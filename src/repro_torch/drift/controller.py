"""Adaptive forgetting controller: detector flags -> forgetting actions.

Port of ``repro/drift/controller.py``: ``DriftPolicy`` (:38),
``controller_init`` (:66) and ``make_controller`` (:71). Instead of a
fixed ``trigger_every`` cadence, the controller reacts to the drift
detector (``repro_torch.drift.detector``):

  * on a detector firing, one eviction pass (``policy.eviction``, LRU
    with ``lru_max_age=64`` by default);
  * then, if ``boost_batches > 0``, a boost window: gradual decay by
    ``boost_gamma`` on each of the next micro-batches, then nothing.

JAX gates both actions with ``lax.cond``; here the flags stay on the
device and gate the in-place passes (``forgetting.apply_forgetting``'s
``gate``), so the controller runs in the device loop with no host read.
Its only carry is one int32 (boost batches left). With ``mode ==
"adaptive"`` it replaces the fixed cadence (``StreamConfig.forgetting``
is not consulted).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import forgetting as forgetting_lib
from repro_torch.drift.detector import DetectorConfig

__all__ = ["DriftPolicy", "make_controller", "controller_init"]


class DriftPolicy(NamedTuple):
    """Opt-in closed-loop drift policy (``StreamConfig.drift``).

    ``mode``: ``"none"`` — drift runtime off (as ``drift=None``: the
    fixed ``cfg.forgetting`` cadence applies); ``"adaptive"`` — detector
    and controller replace the fixed cadence.
    """

    mode: str = "adaptive"
    detector: DetectorConfig = DetectorConfig()
    # One eviction pass per detection (``trigger_every`` unused): evict
    # everything not touched in the last ~64 per-worker events.
    eviction: forgetting_lib.ForgettingConfig = forgetting_lib.ForgettingConfig(
        policy="lru", lru_max_age=64)
    # Optional post-detection boost window of gradual decay.
    boost_batches: int = 0
    boost_gamma: float = 0.90


def controller_init(device="cuda") -> torch.Tensor:
    """Initial controller carry: boost batches remaining."""
    return torch.zeros((), dtype=torch.int32, device=device)


def make_controller(policy: DriftPolicy):
    """Build the per-micro-batch controller step.

    Returns ``step(states, fired, boost, live=None) -> (states, boost)``
    over the stacked ``[n_c, ...]`` states (updated in place), the
    detector flag ``fired`` (0-d bool tensor) and the carry ``boost``.
    ``live`` (0-d bool) marks a step with events: JAX's engine skips a
    step without, so there neither pass runs and ``boost`` is kept.
    """
    evict = policy.eviction if policy.eviction.policy != "none" else None
    decay = (forgetting_lib.ForgettingConfig(
        policy="gradual", gradual_gamma=policy.boost_gamma)
        if policy.boost_batches > 0 else None)

    def step(states, fired, boost, live=None):
        if live is not None:
            fired = fired & live
        if evict is not None:
            forgetting_lib.apply_forgetting(states, evict, gate=fired)
        new = torch.where(fired, policy.boost_batches, boost)
        if decay is not None:
            gate = new > 0 if live is None else (new > 0) & live
            forgetting_lib.apply_forgetting(states, decay, gate=gate)
        new = torch.clamp(new - 1, min=0).to(torch.int32)
        return states, new if live is None else torch.where(live, new, boost)

    return step
