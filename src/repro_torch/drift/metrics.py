"""Post-drift recall metrics: dip depth, detection delay, recovery time.

A numpy-only copy of ``repro/drift/metrics.py`` (``DriftReport`` :28,
``recovery_report`` :42), over this package's
``core/evaluator.moving_average``:

  * **pre** — windowed recall just before the drift event;
  * **dip** — the post-drift minimum of the windowed curve;
  * **recovery_events** — evaluated events from the drift until the
    curve regains ``frac`` (default 95%) of ``pre``; ``None`` if the
    stream ends first (``recovery_or_censored`` ranks "never recovered"
    past the horizon).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.evaluator import moving_average

__all__ = ["DriftReport", "recovery_report"]


@dataclasses.dataclass(frozen=True)
class DriftReport:
    pre: float                    # windowed recall at the drift boundary
    dip: float                    # post-drift windowed minimum
    dip_events: int               # evaluated events from drift to the dip
    recovery_events: int | None   # events from drift back to frac * pre
    horizon: int                  # evaluated events available post-drift

    @property
    def recovery_or_censored(self) -> int:
        """Recovery time with "never recovered" ranked past the horizon."""
        return (self.recovery_events if self.recovery_events is not None
                else self.horizon + 1)


def recovery_report(bits: np.ndarray, drift_event: int, window: int = 400,
                    frac: float = 0.95, dip_horizon: int = 3000) -> DriftReport:
    """Score one run's recall bits against one drift point.

    Args:
      bits: stream-order recall bits (NaN = not evaluated), e.g.
        ``StreamResult.recall.bits()``.
      drift_event: post-dedupe stream index of the drift
        (``DriftStream.drift_events[i]``), in evaluated-event space: run
        with ``StreamResult.dropped == 0``.
      window: moving-average window (events) for the recall curve.
      frac: recovered = curve back above ``frac * pre``.
      dip_horizon: events after the drift within which the dip is sought.
    """
    bits = np.asarray(bits, np.float64)
    clean = bits[~np.isnan(bits)]
    curve = moving_average(clean, window)
    pos = min(int(drift_event), max(len(curve) - 1, 0))
    pre = float(curve[pos - 1]) if pos > 0 else float("nan")
    seg = curve[pos:]
    if seg.size == 0:
        return DriftReport(pre, float("nan"), 0, None, 0)
    dip_pos = int(np.argmin(seg[:dip_horizon]))
    recovered = np.flatnonzero(seg[dip_pos:] >= frac * pre)
    recovery = dip_pos + int(recovered[0]) if recovered.size else None
    return DriftReport(
        pre=pre,
        dip=float(seg[dip_pos]),
        dip_events=dip_pos,
        recovery_events=recovery,
        horizon=int(seg.size),
    )
