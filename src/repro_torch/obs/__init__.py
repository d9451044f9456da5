"""Unified observability: metrics registry, loop telemetry, tracing.

Port of ``repro/obs/__init__.py``, the same public names:

  * ``repro_torch.obs.metrics``   — host-side instruments (:class:`Counter`,
    :class:`Gauge`, :class:`Histogram`) in a thread-safe
    :class:`MetricsRegistry` with Prometheus/JSON export;
  * ``repro_torch.obs.telemetry`` — the device counters riding the
    streaming loop's carry (:class:`TelemetryState`), folded into the
    registry off the hot path by :class:`TelemetryFolder`;
  * ``repro_torch.obs.trace``     — nestable :func:`span` timers marked in
    ``torch.profiler`` traces (and NVTX ranges on the card), plus the
    one-call :func:`profile` capture hook.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     HistogramSnapshot, MetricsRegistry,
                                     ScopedRegistry, default_buckets,
                                     merge_histograms)
from repro_torch.obs.telemetry import (HOST_CARRY_CAP, TelemetryFolder,
                                       TelemetryState, effective_list_len,
                                       telemetry_batch_update,
                                       telemetry_init, telemetry_ints,
                                       telemetry_update)
from repro_torch.obs.trace import current_span, profile, span

__all__ = [
    "MetricsRegistry", "ScopedRegistry", "Counter", "Gauge", "Histogram",
    "HistogramSnapshot", "default_buckets", "merge_histograms",
    "TelemetryState", "TelemetryFolder", "telemetry_init",
    "telemetry_update", "telemetry_batch_update", "telemetry_ints",
    "effective_list_len", "HOST_CARRY_CAP", "span", "profile",
    "current_span",
]
