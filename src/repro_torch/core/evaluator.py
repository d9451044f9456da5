"""Prequential online evaluation (paper Algorithm 4 + Section 5.2).

A numpy-only copy of ``repro/core/evaluator.py`` (``RecallAccumulator``
:38), kept here because importing the JAX package pulls in jax.

For every stream event the recommender first produces a top-N list
(test: ``Recall@N ∈ {0,1}``, 1 iff the event's item is in the list), and
only then trains on the event. The recall bits are smoothed with a moving
average over a 5000-event window (paper's reporting).

The per-event test-then-train interleaving lives inside the worker step
functions (``disgd_worker_step`` / ``dics_worker_step``); this module
aggregates their emitted bits back into stream order and computes the
curves and summary statistics reported in the paper's figures.
"""

from __future__ import annotations

import numpy as np

__all__ = ["moving_average", "RecallAccumulator"]


def moving_average(bits: np.ndarray, window: int = 5000) -> np.ndarray:
    """Paper's smoothing: mean over a trailing window of evaluated events."""
    bits = np.asarray(bits, dtype=np.float64)
    if bits.size == 0:
        return bits
    c = np.cumsum(np.insert(bits, 0, 0.0))
    n = bits.size
    out = np.empty(n)
    # Warm-up head (windows still filling): mean over the first t events —
    # one cumsum slice, not a per-element Python loop over `window` items.
    warm = min(window, n)
    out[:warm] = c[1 : warm + 1] / np.arange(1, warm + 1)
    if n > window:
        out[window:] = (c[window + 1 :] - c[1 : n - window + 1]) / window
    return out


class RecallAccumulator:
    """Collects per-micro-batch hit bits back into stream order."""

    def __init__(self):
        self._bits: list[np.ndarray] = []

    def add_batch(self, buckets: np.ndarray, hits: np.ndarray, evaluated: np.ndarray,
                  batch_size: int):
        """Scatter bucket-ordered hits back to stream order.

        Args:
          buckets: int[n_workers, capacity] event indices (-1 padding).
          hits: bool[n_workers, capacity] recall bits per bucket slot.
          evaluated: bool[n_workers, capacity] validity per bucket slot.
          batch_size: number of events in this micro-batch.
        """
        bits = np.full(batch_size, np.nan)
        flat_idx = buckets.reshape(-1)
        flat_hits = np.asarray(hits).reshape(-1)
        flat_eval = np.asarray(evaluated).reshape(-1)
        sel = (flat_idx >= 0) & flat_eval
        bits[flat_idx[sel]] = flat_hits[sel]
        self._bits.append(bits)

    def add_raw(self, bits: np.ndarray):
        """Append an already stream-ordered bit row (NaN = not evaluated).

        Used by the device-resident engine, whose scan emits the scattered
        rows directly (``engine.run_stream_device``).
        """
        self._bits.append(np.asarray(bits, np.float64))

    def bits(self) -> np.ndarray:
        """Recall bits in stream order; NaN = dropped/not evaluated."""
        if not self._bits:
            return np.empty(0)
        return np.concatenate(self._bits)

    def curve(self, window: int = 5000) -> np.ndarray:
        bits = self.bits()
        return moving_average(bits[~np.isnan(bits)], window)

    def mean(self) -> float:
        bits = self.bits()
        bits = bits[~np.isnan(bits)]
        return float(bits.mean()) if bits.size else float("nan")
