"""Prequential ensemble weigher (exp3-style softmax weights).

Port of ``repro/ensemble/weights.py``. Which of {DISGD, DICS, BPR-MF}
should answer a query *right now*? The weigher maintains one weight per
ensemble member (optionally per user-popularity stratum) from each
member's own prequential reward — the recall (or precision@N) head the
device loop's telemetry vector already folds
(:class:`repro_torch.obs.telemetry.TelemetryState`), so the reward
signal costs one read of counters the loop kept anyway.

The update is the classic adversarial-bandit shape (exp3 with softmax
scores):

  * per segment (one ``EnsembleSession.ingest`` call), each member's
    reward rate ``r = hits / evals`` is folded into an exponentially
    weighted mean with bias correction:
    ``reward <- decay * reward + (1 - decay) * r``,
    ``mass   <- decay * mass   + (1 - decay)``, and
    ``r_hat = reward / mass`` (strata that saw no evaluation keep their
    previous estimate — no phantom zeros);
  * weights are a softmax over the estimates (the maximum subtracted
    first, as ``jax.nn.softmax``), floored by a uniform exploration
    term: ``w = (1 - gamma) * softmax(eta * r_hat) + gamma/M``;
  * a drift flag from ANY member's detector re-opens exploration:
    weights flatten to ``1/M`` and the accumulated evidence is
    discounted (``reward *= drift_discount``, ``mass *= drift_discount``),
    with ``resets`` incremented so the exploration trail is visible in
    the metrics registry.

The state is ``[M, S]`` float32 tensors on the ensemble's device. Every
step is one float32 operation, rounded once, in JAX's order (its
ensemble calls the update eagerly, op by op, so nothing is contracted
into a fused multiply-add): reward and mass equal JAX's bit for bit;
the weights differ at most by the last bits of ``exp``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["WeigherConfig", "WeigherState", "weigher_init",
           "weigher_update", "weigher_to_dict", "weigher_from_dict",
           "popularity_stratum"]

_F32 = torch.float32


class WeigherConfig(NamedTuple):
    """Knobs of the prequential weigher (all static)."""

    # Sharpness is calibrated to prequential Recall@N magnitudes (the
    # reward lives in [0, ~0.3], so member gaps are a few 1e-2): eta is
    # high enough that a 4e-2 recall gap yields a ~3x weight ratio, and
    # the exploration floor stays small so the mixture tracks the
    # current best member within ~1% absolute recall (the bench gate).
    eta: float = 24.0           # softmax temperature over reward estimates
    gamma: float = 0.05         # uniform exploration floor (exp3's gamma)
    decay: float = 0.80         # EW reward decay per segment
    reward: str = "recall"      # "recall" | "precision" telemetry head
    strata: int = 1             # user-popularity strata (1 = global)
    drift_reset: bool = True    # drift flag flattens weights
    drift_discount: float = 0.25  # evidence-mass discount on drift


class WeigherState(NamedTuple):
    """``[M, S]`` = members x strata; scalars are 0-d int32."""

    reward: torch.Tensor   # f32[M, S] EW reward numerator
    mass: torch.Tensor     # f32[M, S] EW evidence mass (bias correction)
    weights: torch.Tensor  # f32[M, S] current mixture weights (sum_M = 1)
    resets: torch.Tensor   # i32[] exploration re-openings (drift flags)
    updates: torch.Tensor  # i32[] segments folded


def weigher_init(n_members: int, cfg: WeigherConfig,
                 device="cpu") -> WeigherState:
    if n_members < 1:
        raise ValueError("weigher needs at least one member")
    shape = (n_members, max(int(cfg.strata), 1))
    zero = torch.zeros((), dtype=torch.int32, device=device)
    return WeigherState(
        reward=torch.zeros(shape, dtype=_F32, device=device),
        mass=torch.zeros(shape, dtype=_F32, device=device),
        weights=torch.full(shape, 1.0 / n_members, dtype=_F32,
                           device=device),
        resets=zero, updates=zero.clone())


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A Python float (or array) as float32 on ``like``'s device, rounded
    once from float64 — how JAX takes a weakly typed scalar."""
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


def weigher_update(state: WeigherState, hits, evals, drift,
                   cfg: WeigherConfig) -> WeigherState:
    """Fold one segment's per-member reward counts into the weights.

    ``hits`` / ``evals``: reward numerator / denominator per member (and
    stratum), ``[M, S]``-shaped or broadcastable (host arrays or
    tensors); ``drift`` is a bool — True when any member's detector
    fired this segment.
    """
    w0 = state.weights
    m = w0.shape[0]

    def arg(x):
        x = (x.to(device=w0.device, dtype=_F32) if torch.is_tensor(x)
             else _f32(x, w0))
        return x.expand(w0.shape)

    hits, evals = arg(hits), arg(evals)
    drift = bool(drift)
    decay, rest = _f32(cfg.decay, w0), _f32(1 - cfg.decay, w0)

    seen = evals > 0
    r = hits / torch.clamp(evals, min=1.0)
    reward = torch.where(seen, decay * state.reward + rest * r, state.reward)
    mass = torch.where(seen, decay * state.mass + rest, state.mass)
    if cfg.drift_reset and drift:
        # Drift: keep the reward *estimate*, discount its evidence mass
        # so post-drift segments dominate the EW mean quickly.
        k = _f32(cfg.drift_discount, w0)
        reward, mass = reward * k, mass * k

    r_hat = reward / torch.clamp(mass, min=_f32(1e-6, w0))
    x = _f32(cfg.eta, w0) * r_hat
    e = torch.exp(x - x.max(dim=0, keepdim=True).values)
    w = e / e.sum(dim=0, keepdim=True)
    w = _f32(1.0 - cfg.gamma, w0) * w + _f32(cfg.gamma / m, w0)
    resets = state.resets
    if cfg.drift_reset and drift:
        w = torch.full_like(w, 1.0 / m)
        resets = resets + 1
    return WeigherState(reward=reward, mass=mass, weights=w,
                        resets=resets, updates=state.updates + 1)


def popularity_stratum(freq, strata: int) -> np.ndarray:
    """Log2-spaced user-popularity stratum for event frequencies.

    ``freq`` = how many times each user had been seen BEFORE the event
    (prequential: stratify on what was known at evaluation time).
    Stratum ``min(strata - 1, floor(log2(freq + 1)))`` — 0 = cold users,
    top stratum = heavy hitters.
    """
    freq = np.asarray(freq, np.int64)
    return np.minimum(strata - 1,
                      np.log2(freq + 1).astype(np.int64))


# -- checkpoint (de)serialization — plain JSON-able dicts -------------------


def weigher_to_dict(state: WeigherState) -> dict:
    """Plain lists of the state (float32 values widened to Python
    floats, as JAX's ``np.asarray(...).tolist()``): the same JSON."""
    return {
        "reward": state.reward.cpu().numpy().tolist(),
        "mass": state.mass.cpu().numpy().tolist(),
        "weights": state.weights.cpu().numpy().tolist(),
        "resets": int(state.resets),
        "updates": int(state.updates),
    }


def weigher_from_dict(d: dict, device="cpu") -> WeigherState:
    def f32(key):
        return torch.as_tensor(np.asarray(d[key], np.float32), device=device)

    def i32(key):
        return torch.tensor(int(d[key]), dtype=torch.int32, device=device)

    return WeigherState(reward=f32("reward"), mass=f32("mass"),
                        weights=f32("weights"), resets=i32("resets"),
                        updates=i32("updates"))
