"""On-device concept-drift detection from the prequential recall signal.

Port of ``repro/drift/detector.py``: ``DetectorConfig`` (:48),
``DetectorState`` (:61), ``detector_init`` (:92) and
``detector_update`` (:107). A detector watches the stream's own
prequential Recall@N bits and raises a flag when they degrade in a way
consistent with drift. Two statistics, either of which fires:

  * a two-window recall drop — bias-corrected fast and slow exponential
    means; a flag when the fast mean falls more than ``drop_frac`` below
    the tracked peak of the fast mean;
  * a Page–Hinkley-style CUSUM of how far each micro-batch's recall runs
    below the slow mean (minus ``ph_delta``); a flag past ``ph_lambda``.

On a firing the detector re-baselines (slow mean snapped to the fast
mean, CUSUM reset) and stays quiet for ``cooldown`` micro-batches.

The state is ten 0-d tensors on the stream's device, updated from the
micro-batch's integer hit / evaluated counts with the JAX expression
order, so it rides the device loop's carry without a host read. Every
update builds new tensors (none is written in place), so a publish
boundary may hand the carry's tensors over as they are.

XLA on the CPU contracts the four exponential updates ``x + y * z``
into fused multiply-adds (found by holding each variant against JAX; a
plain f32 chain differs in the last bit of ``fast`` / ``slow`` within a
few batches). ``_fma`` computes them in float64, where the product of
two f32 values is exact, and rounds once to f32, so the port's
detector equals JAX's bit for bit on every device (a double rounding
could still differ on an exact f32 tie; never seen).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["DetectorConfig", "DetectorState", "detector_init",
           "detector_update"]


class DetectorConfig(NamedTuple):
    """Static detector knobs (part of ``StreamConfig.drift``)."""

    alpha_fast: float = 0.30   # fast EW window (~1/alpha micro-batches)
    alpha_slow: float = 0.05   # slow EW window
    drop_frac: float = 0.25    # fire when fast < (1 - drop_frac) * peak
    min_slow: float = 0.02     # slow mean below this = no signal yet
    warmup: int = 2048         # evaluated events before flags may fire
    ph_delta: float = 0.01     # CUSUM drift allowance per micro-batch
    ph_lambda: float = 0.30    # CUSUM firing threshold
    cooldown: int = 8          # micro-batches suppressed after a firing


class DetectorState(NamedTuple):
    """Loop-carry detector state (0-d tensors).

    ``fast`` / ``slow`` are uncorrected exponential accumulators with
    their bias corrections ``fast_c`` / ``slow_c`` (the running ``1 -
    (1-a)^t`` denominators), so the means are unbiased from batch one.
    """

    fast: torch.Tensor    # f32 fast EW recall accumulator
    slow: torch.Tensor    # f32 slow EW recall accumulator
    fast_c: torch.Tensor  # f32 bias correction for ``fast``
    slow_c: torch.Tensor  # f32 bias correction for ``slow``
    peak: torch.Tensor    # f32 tracked peak of the fast mean
    seen: torch.Tensor    # i32 evaluated events so far
    ph: torch.Tensor      # f32 one-sided CUSUM deficit
    cool: torch.Tensor    # i32 micro-batches of cooldown remaining
    fired: torch.Tensor   # bool flag emitted by the last update
    fires: torch.Tensor   # i32 total firings

    @property
    def fast_mean(self):
        """Bias-corrected fast-window recall mean."""
        return self.fast / torch.clamp(self.fast_c, min=1e-9)

    @property
    def slow_mean(self):
        """Bias-corrected slow-window recall mean."""
        return self.slow / torch.clamp(self.slow_c, min=1e-9)


_DTYPES = (torch.float32,) * 5 + (torch.int32, torch.float32, torch.int32,
                                  torch.bool, torch.int32)


def detector_init(device="cuda") -> DetectorState:
    return DetectorState(*(torch.zeros((), dtype=d, device=device)
                           for d in _DTYPES))


def detector_from(leaves, device="cuda") -> DetectorState:
    """A ``DetectorState`` on ``device`` from any ten leaves in field
    order (this package's tensors, or the JAX state mapped to numpy)."""
    return DetectorState(*(torch.as_tensor(leaf).to(device=device, dtype=d)
                           for leaf, d in zip(leaves, _DTYPES, strict=True)))


def _f64(x):
    """A f32 tensor, or a Python float rounded to f32, as float64."""
    return x.double() if torch.is_tensor(x) else float(np.float32(x))


def _fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as XLA's contraction."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def detector_update(state: DetectorState, hits, evaluated,
                    cfg: DetectorConfig) -> DetectorState:
    """One micro-batch of detector time (``detector.py:107-174``).

    ``hits`` / ``evaluated`` are the micro-batch's bool recall bits and
    validity (any shape). Returns the new state; ``fired`` is this
    micro-batch's drift flag. A batch with nothing evaluated leaves the
    means and the CUSUM untouched.
    """
    n_eval = evaluated.sum(dtype=torch.int32)
    n_hits = (hits & evaluated).sum(dtype=torch.int32)
    has = n_eval > 0
    hasf = has.to(torch.float32)
    r = n_hits.to(torch.float32) / torch.clamp(n_eval, min=1).to(
        torch.float32)

    af, as_ = cfg.alpha_fast, cfg.alpha_slow
    fast = torch.where(has, _fma(af, r, (1 - af) * state.fast), state.fast)
    slow = torch.where(has, _fma(as_, r, (1 - as_) * state.slow), state.slow)
    fast_c = _fma(hasf * af, 1 - state.fast_c, state.fast_c)
    slow_c = _fma(hasf * as_, 1 - state.slow_c, state.slow_c)
    fast_hat = fast / torch.clamp(fast_c, min=1e-9)
    slow_hat = slow / torch.clamp(slow_c, min=1e-9)
    seen = state.seen + n_eval
    ph = torch.where(
        has, torch.clamp(state.ph + (slow_hat - r - cfg.ph_delta), min=0.0),
        state.ph)

    armed = ((seen >= cfg.warmup) & (state.cool <= 0)
             & (slow_hat > cfg.min_slow))
    window_drop = fast_hat < (1.0 - cfg.drop_frac) * state.peak
    cusum = ph > cfg.ph_lambda
    fired = armed & has & (window_drop | cusum)

    # Re-baseline on a firing and through the cooldown window; the peak
    # tracks only once warm (see the JAX module for why).
    warm = seen >= cfg.warmup
    cooling = state.cool > 0
    slow = torch.where(fired | cooling, fast_hat * slow_c, slow)
    peak = torch.where(
        fired, fast_hat,
        torch.where(cooling, torch.minimum(state.peak, fast_hat),
                    torch.where(warm, torch.maximum(state.peak, fast_hat),
                                state.peak)))
    ph = torch.where(fired | cooling, 0.0, ph)
    cool = torch.where(fired, cfg.cooldown,
                       torch.clamp(state.cool - has.to(torch.int32), min=0))
    return DetectorState(
        fast=fast, slow=slow, fast_c=fast_c, slow_c=slow_c, peak=peak,
        seen=seen, ph=ph, cool=cool.to(torch.int32), fired=fired,
        fires=state.fires + fired.to(torch.int32))
