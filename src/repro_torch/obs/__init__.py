"""Observability: the metrics registry and span tracing.

Port of ``repro/obs/__init__.py`` without its device telemetry
(``TelemetryState``, ``TelemetryFolder``), which comes with ROADMAP
Queue 1 item 10:

  * ``repro_torch.obs.metrics`` — host-side instruments (:class:`Counter`,
    :class:`Gauge`, :class:`Histogram`) in a thread-safe
    :class:`MetricsRegistry` with Prometheus/JSON export;
  * ``repro_torch.obs.trace``   — nestable :func:`span` timers marked in
    ``torch.profiler`` traces (and NVTX ranges on the card), plus the
    one-call :func:`profile` capture hook.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     HistogramSnapshot, MetricsRegistry,
                                     ScopedRegistry, default_buckets,
                                     merge_histograms)
from repro_torch.obs.trace import current_span, profile, span

__all__ = [
    "MetricsRegistry", "ScopedRegistry", "Counter", "Gauge", "Histogram",
    "HistogramSnapshot", "default_buckets", "merge_histograms", "span",
    "profile", "current_span",
]
