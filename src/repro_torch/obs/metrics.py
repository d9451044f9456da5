"""Thread-safe metrics registry: typed, labeled instruments.

A copy of ``repro/obs/metrics.py`` (numpy only): the same instruments,
bucket bounds, merge rule and exports, so the same registry operations
give the same Prometheus and JSON text in both packages.

One :class:`MetricsRegistry` per process (or per ``StreamSession``) holds
every instrument the runtime emits:

  * :class:`Counter` — monotone event counts (``inc``);
  * :class:`Gauge`   — last-written level (``set`` / ``set_max``);
  * :class:`Histogram` — latency/size distributions over **fixed
    log-spaced buckets** (:func:`default_buckets`), so two histograms of
    the same metric — different threads, different processes, different
    runs — merge *exactly* by summing bucket counts
    (:func:`merge_histograms`). Each histogram also retains raw samples
    up to ``keep_samples`` observations; while every observation is
    retained, :meth:`Histogram.percentile` is exact (``np.percentile``
    over the samples — matching pre-registry inline math bit for bit)
    and degrades to within-bucket interpolation only past the bound.

Get-or-create is idempotent: ``registry.counter("x")`` called twice
returns the same family, so independent components (snapshot store,
query front-end, telemetry folder) share instruments by name without
coordination. Re-registering a name with a different type or label set
raises.

Export: :meth:`MetricsRegistry.snapshot` (plain dict),
:meth:`~MetricsRegistry.to_json`, and Prometheus text exposition
(:meth:`~MetricsRegistry.to_prometheus` — counters get the ``_total``
suffix, histograms the ``_bucket{le=}`` / ``_sum`` / ``_count``
triplet).

Pure host-side bookkeeping: no torch here. The device-resident half of
observability is ``obs/telemetry.py`` (the loop's telemetry vector,
folded into a registry by its ``TelemetryFolder``).
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Any, Iterable

import numpy as np

__all__ = ["MetricsRegistry", "ScopedRegistry", "Counter", "Gauge",
           "Histogram", "HistogramSnapshot", "default_buckets",
           "merge_histograms"]


def default_buckets(lo_exp: int = -6, hi_exp: int = 4,
                    per_decade: int = 4) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds, ``10**(lo_exp..hi_exp)``.

    Deterministic: every histogram built from the same parameters shares
    identical bounds, which is what makes cross-instance merges exact.
    The default range covers 1 µs .. 10 ks in seconds (latency) and
    1 .. 10 000 in counts (staleness events); observations past the top
    bound land in the implicit ``+Inf`` bucket.
    """
    return tuple(10.0 ** (e / per_decade)
                 for e in range(lo_exp * per_decade,
                                hi_exp * per_decade + 1))


class Counter:
    """Monotone counter. ``inc`` only; negative increments raise."""

    kind = "counter"
    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-written level; ``set_max`` keeps a running high-water mark."""

    kind = "gauge"
    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def set_max(self, v) -> None:
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value


class HistogramSnapshot:
    """Immutable point-in-time view of a histogram (merge/percentile)."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max",
                 "samples", "exact")

    def __init__(self, bounds, counts, count, sum_, min_, max_, samples,
                 exact):
        self.bounds = tuple(bounds)       # bucket upper bounds (le)
        self.counts = tuple(counts)       # per-bucket (NOT cumulative);
        self.count = count                # last slot is the +Inf bucket
        self.sum = sum_
        self.min = min_
        self.max = max_
        self.samples = samples            # np.float64[<=keep_samples]
        self.exact = exact                # samples cover every observation

    def percentile(self, q: float) -> float:
        """Exact ``np.percentile`` while ``exact``; else interpolated
        from bucket counts (within-bucket linear)."""
        if self.count == 0:
            return math.nan
        if self.exact:
            return float(np.percentile(self.samples, q))
        rank = (q / 100.0) * (self.count - 1)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, rank + 1))
        lo = self.bounds[b - 1] if b > 0 else self.min
        hi = self.bounds[b] if b < len(self.bounds) else self.max
        lo, hi = max(lo, self.min), min(hi, self.max)
        prev = cum[b - 1] if b > 0 else 0
        frac = (rank - prev + 1) / max(self.counts[b], 1)
        return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))


def merge_histograms(*snaps: HistogramSnapshot) -> HistogramSnapshot:
    """Exact merge of histogram snapshots sharing identical bounds.

    Bucket counts add; retained samples concatenate, so the merged
    ``percentile`` stays exact whenever every input was exact
    (``np.percentile`` is order-independent).
    """
    if not snaps:
        return HistogramSnapshot(default_buckets(), [], 0, 0.0,
                                 math.inf, -math.inf,
                                 np.empty(0, np.float64), True)
    bounds = snaps[0].bounds
    for s in snaps[1:]:
        if s.bounds != bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket bounds")
    counts = np.sum([s.counts for s in snaps], axis=0) if snaps[0].counts \
        else []
    return HistogramSnapshot(
        bounds, list(counts), sum(s.count for s in snaps),
        sum(s.sum for s in snaps),
        min(s.min for s in snaps), max(s.max for s in snaps),
        np.concatenate([s.samples for s in snaps]),
        all(s.exact for s in snaps))


class Histogram:
    """Fixed-bucket histogram with exact percentiles up to a sample cap."""

    kind = "histogram"
    __slots__ = ("_lock", "_bounds", "_counts", "_count", "_sum", "_min",
                 "_max", "_samples", "_keep")

    def __init__(self, lock: threading.RLock, bounds: tuple[float, ...],
                 keep_samples: int):
        self._lock = lock
        self._bounds = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)   # +1: the +Inf bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._samples: list[float] = []
        self._keep = keep_samples

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self._bounds, v)] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < self._keep:
                self._samples.append(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return HistogramSnapshot(
                self._bounds, list(self._counts), self._count, self._sum,
                self._min, self._max,
                np.asarray(self._samples, np.float64),
                len(self._samples) == self._count)

    def percentile(self, q: float) -> float:
        return self.snapshot().percentile(q)


class MetricFamily:
    """One named metric; children keyed by label values.

    Unlabeled families delegate the instrument API (``inc`` / ``set`` /
    ``observe`` / ``value`` / ...) straight to their single child, so
    ``registry.counter("x").inc()`` works without a ``labels()`` hop.
    """

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help_: str, label_names: tuple[str, ...], ctor):
        self.name = name
        self.kind = kind
        self.help = help_
        self.label_names = label_names
        self._registry = registry
        self._ctor = ctor
        self._children: dict[tuple[str, ...], Any] = {}

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in self.label_names)
        with self._registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._ctor()
            return child

    def series(self) -> list[tuple[dict[str, str], Any]]:
        """``(labels_dict, instrument)`` per live child, label-sorted."""
        with self._registry._lock:
            items = sorted(self._children.items())
        return [(dict(zip(self.label_names, key)), child)
                for key, child in items]

    # -- unlabeled convenience delegation ---------------------------------

    def _default(self):
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.label_names}; "
                "use .labels(...)")
        return self.labels()

    def inc(self, n=1):
        return self._default().inc(n)

    def set(self, v):
        return self._default().set(v)

    def set_max(self, v):
        return self._default().set_max(v)

    def observe(self, v):
        return self._default().observe(v)

    def snapshot(self):
        return self._default().snapshot()

    def percentile(self, q):
        return self._default().percentile(q)

    @property
    def value(self):
        return self._default().value


class MetricsRegistry:
    """Process-local registry of named metric families (thread-safe)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, MetricFamily] = {}

    # -- registration (idempotent get-or-create) --------------------------

    def _family(self, name, kind, help_, labels, ctor) -> MetricFamily:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(self, name, kind, help_, labels, ctor)
                self._families[name] = fam
            elif fam.kind != kind or fam.label_names != labels:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} "
                    f"with labels {fam.label_names}; asked for {kind} "
                    f"with {labels}")
            return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, "counter", help, labels,
                            lambda: Counter(self._lock))

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> MetricFamily:
        return self._family(name, "gauge", help, labels,
                            lambda: Gauge(self._lock))

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] | None = None,
                  keep_samples: int = 65536) -> MetricFamily:
        bounds = tuple(buckets) if buckets is not None else default_buckets()
        return self._family(name, "histogram", help, labels,
                            lambda: Histogram(self._lock, bounds,
                                              keep_samples))

    def get(self, name: str) -> MetricFamily:
        with self._lock:
            return self._families[name]

    def families(self) -> list[MetricFamily]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    # -- export -----------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Plain-dict view of every family (JSON-serializable)."""
        out: dict[str, Any] = {}
        for fam in self.families():
            series = []
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    h = child.snapshot()
                    series.append({
                        "labels": labels,
                        "count": h.count,
                        "sum": h.sum,
                        "min": h.min if h.count else None,
                        "max": h.max if h.count else None,
                        "bounds": list(h.bounds),
                        "bucket_counts": list(int(c) for c in h.counts),
                    })
                else:
                    v = child.value
                    series.append({"labels": labels,
                                   "value": (int(v) if isinstance(
                                       v, (bool, np.integer)) else v)})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps({"schema_version": 1, "metrics": self.snapshot()},
                          indent=indent, default=float)

    def write_json(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: list[str] = []
        for fam in self.families():
            base = fam.name
            if fam.kind == "counter" and not base.endswith("_total"):
                base += "_total"
            if fam.help:
                lines.append(f"# HELP {base} {fam.help}")
            lines.append(f"# TYPE {base} {fam.kind}")
            for labels, child in fam.series():
                lab = _fmt_labels(labels)
                if fam.kind == "histogram":
                    h = child.snapshot()
                    cum = 0
                    for bound, c in zip(h.bounds, h.counts):
                        cum += c
                        lines.append(
                            f"{base}_bucket"
                            f"{_fmt_labels({**labels, 'le': _fmt_f(bound)})}"
                            f" {cum}")
                    lines.append(
                        f"{base}_bucket"
                        f"{_fmt_labels({**labels, 'le': '+Inf'})} {h.count}")
                    lines.append(f"{base}_sum{lab} {_fmt_f(h.sum)}")
                    lines.append(f"{base}_count{lab} {h.count}")
                else:
                    lines.append(f"{base}{lab} {_fmt_f(child.value)}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_prometheus())
        return path


class _ScopedFamily:
    """A :class:`MetricFamily` view with scope labels pre-bound.

    ``labels(**extra)`` merges the scope into the child lookup;
    the unlabeled convenience API (``inc`` / ``set`` / ``observe`` /
    ``value`` / ...) resolves to the scope-only child — the analogue of
    ``MetricFamily._default`` for a family whose only labels are the
    scope's. ``series()`` filters to this scope's children, so consumers
    that enumerate label series (e.g. the autoscaler reading per-bucket
    occupancy gauges) see only their own slice of a shared family.
    """

    __slots__ = ("_fam", "_scope")

    def __init__(self, fam: MetricFamily, scope: dict[str, str]):
        self._fam = fam
        self._scope = scope

    def labels(self, **labels):
        return self._fam.labels(**self._scope, **labels)

    def series(self) -> list[tuple[dict[str, str], Any]]:
        return [(labels, child) for labels, child in self._fam.series()
                if all(labels.get(k) == v for k, v in self._scope.items())]

    def _default(self):
        return self._fam.labels(**self._scope)

    def inc(self, n=1):
        return self._default().inc(n)

    def set(self, v):
        return self._default().set(v)

    def set_max(self, v):
        return self._default().set_max(v)

    def observe(self, v):
        return self._default().observe(v)

    def snapshot(self):
        return self._default().snapshot()

    def percentile(self, q):
        return self._default().percentile(q)

    @property
    def value(self):
        return self._default().value

    def __getattr__(self, name):   # name / kind / help / label_names ...
        return getattr(self._fam, name)


class ScopedRegistry:
    """A constant-label view over a shared :class:`MetricsRegistry`.

    ``ScopedRegistry(base, member="dics")`` hands out instruments whose
    families carry the scope's label(s) in addition to their own, with
    the scope values pre-bound — so N components (e.g. the member
    sessions of an ``EnsembleSession``) share ONE base registry and one
    scrape without label-set collisions:

        scoped = ScopedRegistry(base, member="dics")
        scoped.counter("stream_events_total").inc(5)
        # == base family "stream_events_total"{member="dics"} += 5

    Families created through a scope declare ``scope labels + own
    labels``; a family of the same name created through a *different*
    scope with the same label names is the same base family (idempotent
    get-or-create), while creating it unscoped on the base raises — the
    registry's usual label-set strictness, now guarding against mixing
    scoped and unscoped writers of one name.

    Scopes nest: ``ScopedRegistry(scoped, stage="serve")`` flattens into
    a single combined label set on the underlying base. Everything else
    (``snapshot`` / ``to_prometheus`` / ``get`` / export) delegates to
    the base registry and covers ALL scopes.
    """

    def __init__(self, base, **labels):
        if not labels:
            raise ValueError("ScopedRegistry needs at least one label")
        if isinstance(base, ScopedRegistry):
            labels = {**base.scope, **labels}
            base = base.base
        self.base: MetricsRegistry = base
        self.scope: dict[str, str] = {k: str(v) for k, v in labels.items()}

    def _label_names(self, labels: Iterable[str]) -> tuple[str, ...]:
        return tuple(self.scope) + tuple(labels)

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> _ScopedFamily:
        fam = self.base.counter(name, help, labels=self._label_names(labels))
        return _ScopedFamily(fam, self.scope)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> _ScopedFamily:
        fam = self.base.gauge(name, help, labels=self._label_names(labels))
        return _ScopedFamily(fam, self.scope)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] | None = None,
                  keep_samples: int = 65536) -> _ScopedFamily:
        fam = self.base.histogram(name, help,
                                  labels=self._label_names(labels),
                                  buckets=buckets,
                                  keep_samples=keep_samples)
        return _ScopedFamily(fam, self.scope)

    def __getattr__(self, name):   # snapshot / to_json / get / families ...
        return getattr(self.base, name)


def _fmt_f(v) -> str:
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return format(float(v), ".9g")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\").replace('"', r"\"")
                         .replace("\n", r"\n"))
        for k, v in labels.items())
    return "{" + body + "}"
