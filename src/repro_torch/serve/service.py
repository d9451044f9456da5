"""Mixed-load service runner: live ingest + query traffic on one session.

Port of ``repro/serve/service.py``. The paper's evaluation trains and
serves in separate phases; a real deployment does both at once, and the
number that matters is the tail latency of queries *while the trainer is
running* — rotation stalls, forgetting passes and drift evictions all
land on the read path as latency spikes. This runner measures exactly
that, in two modes:

  * ``mode="interleaved"`` — single-threaded, deterministic: a seeded
    ``loadgen.mixed_schedule`` dictates the exact order of ingest chunks
    and query batches, so the model states (and answers) are
    bit-reproducible across runs — pending async rotations are drained
    before each query batch, so this holds even under an async
    ``PublishPolicy``. This is the mode tests use, and the fallback
    where threads are unwelcome.
  * ``mode="threaded"`` — one ingest thread runs the full event stream
    through ``session.ingest`` (publishing per the session's
    ``PublishPolicy``) while this thread issues query batches open-loop,
    paced by the load generator's arrival schedule. PyTorch releases the
    GIL inside its operators, so the two paths overlap on the host; on
    the card both enqueue on the default stream, so a query's kernels
    wait behind the trainer's steps already queued there.

On a process grid (a ``backend="shard_map"`` session, every rank
running ``run_service`` with the same arguments) the same two modes
run on every rank. Interleaved: each query batch drains the rank's
async backlog, then ``recommend``'s agreement picks the snapshot, so
the answers are the same pure function of the schedule. Threaded: the
loop's iteration count, its pauses and ``under_load`` must be the same
on every rank, or the ranks' serve-group collectives would mismatch, so
each decision is taken from the last call's agreement
(``SnapshotStore.last_agreement.training``: whether any rank's trainer
still ran), never from this rank's own clock; the trainer is counted
running (``SnapshotStore.begin_training``) from before its thread
starts until it is done.

Every query batch records its latency, the snapshot version and
forgetting counter it was answered from, and its staleness-at-answer
(events the snapshot trailed the reported stream position). The report
aggregates tail latencies, the staleness distribution, combined
throughput, and attributes latency spikes to snapshot-generation
transitions (rotation / forgetting-eviction boundaries).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Any

import numpy as np

from repro_torch.obs import metrics as metrics_lib
from repro_torch.serve.loadgen import LoadConfig, QueryLoad, mixed_schedule

__all__ = ["ServiceConfig", "QueryRecord", "ServiceReport", "run_service"]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """How to drive the mixed load (the *what* lives in ``LoadConfig``)."""

    mode: str = "interleaved"        # "interleaved" | "threaded"
    events_per_chunk: int = 256      # ingest granularity (interleaved mode)
    query_batches: int = 50          # total query batches to issue
    schedule_seed: int = 0           # interleave-order seed

    def __post_init__(self):
        if self.mode not in ("interleaved", "threaded"):
            raise ValueError(f"unknown service mode {self.mode!r}")
        if self.events_per_chunk < 1:
            raise ValueError("events_per_chunk must be positive")


@dataclasses.dataclass
class QueryRecord:
    """One served query batch, annotated for spike attribution."""

    latency_s: float
    staleness_events: int
    snapshot_version: int
    snapshot_forgets: int
    cache_hits: int
    fallbacks: int
    under_load: bool = True   # issued while the trainer was still running


@dataclasses.dataclass
class ServiceReport:
    """Aggregated mixed-load measurements (see ``summary()``).

    ``metrics`` is the run's own :class:`~repro_torch.obs.metrics.
    MetricsRegistry` — every query batch was observed into
    ``service_query_latency_seconds`` / ``service_staleness_events``
    histograms labeled by ``under_load``, and ``summary()``'s
    percentiles are computed from those histograms (exact while the
    retained-sample cap holds, which it always does at benchmark query
    counts — bit-matching the former inline ``np.percentile`` over the
    records). Reports deserialized without a registry (``metrics=None``)
    fall back to the inline computation.
    """

    records: list[QueryRecord]
    wall_s: float
    events_processed: int
    queries: int                  # individual queries (batches * batch size)
    ingest_wall_s: float          # time spent inside ingest (interleaved) or
                                  # the ingest thread's span (threaded)
    publish_stats: dict[str, int]
    metrics: Any = None           # per-run MetricsRegistry (or None)

    def _loaded(self) -> list[QueryRecord]:
        """Tail latencies are computed over batches issued while the
        trainer was live; the post-stream drain would dilute them."""
        loaded = [r for r in self.records if r.under_load]
        return loaded if loaded else self.records

    def _lat_ms(self) -> np.ndarray:
        return np.asarray([r.latency_s for r in self._loaded()]) * 1e3

    def _stale(self) -> np.ndarray:
        return np.asarray([r.staleness_events for r in self._loaded()])

    def _hist(self, name: str):
        """The metric's under-load series, falling back to the merge of
        every series when no under-load batch was recorded — the same
        dilution rule as ``_loaded()``."""
        fam = self.metrics.get(name)
        loaded = fam.labels(under_load="true").snapshot()
        if loaded.count:
            return loaded
        return metrics_lib.merge_histograms(
            *(child.snapshot() for _, child in fam.series()))

    def summary(self) -> dict[str, Any]:
        lat, stale = self._lat_ms(), self._stale()
        out: dict[str, Any] = {
            "query_batches": len(self.records),
            "query_batches_under_load": sum(
                r.under_load for r in self.records),
            "queries": self.queries,
            "events_processed": self.events_processed,
            "wall_s": round(self.wall_s, 4),
            "combined_ops_per_s": round(
                (self.events_processed + self.queries)
                / max(self.wall_s, 1e-9), 1),
            "ingest_events_per_s": round(
                self.events_processed / max(self.ingest_wall_s, 1e-9), 1),
        }
        if lat.size and self.metrics is not None:
            lh = self._hist("service_query_latency_seconds")
            sh = self._hist("service_staleness_events")
            out.update(
                p50_ms=round(lh.percentile(50) * 1e3, 3),
                p99_ms=round(lh.percentile(99) * 1e3, 3),
                max_ms=round(lh.max * 1e3, 3),
                staleness_mean=round(sh.sum / sh.count, 1),
                staleness_p95=int(sh.percentile(95)),
                staleness_max=int(sh.max),
            )
            out.update(self._spikes(lat))
        elif lat.size:
            out.update(
                p50_ms=round(float(np.percentile(lat, 50)), 3),
                p99_ms=round(float(np.percentile(lat, 99)), 3),
                max_ms=round(float(lat.max()), 3),
                staleness_mean=round(float(stale.mean()), 1),
                staleness_p95=int(np.percentile(stale, 95)),
                staleness_max=int(stale.max()),
            )
            out.update(self._spikes(lat))
        for k in ("coalesced", "async_rotations"):
            if k in self.publish_stats:
                out[k] = int(self.publish_stats[k])
        return out

    def _spikes(self, lat: np.ndarray) -> dict[str, Any]:
        """Split batch latencies by whether the answering snapshot
        generation just advanced (rotation and/or forgetting eviction) —
        the boundary where invalidation cost lands on the read path.

        Operates on the same under-load subset as ``lat``.
        """
        recs = self._loaded()
        gens = [(r.snapshot_version, r.snapshot_forgets) for r in recs]
        forgets = [r.snapshot_forgets for r in recs]
        boundary = np.zeros(len(gens), bool)
        evicted = np.zeros(len(gens), bool)
        for i in range(1, len(gens)):
            boundary[i] = gens[i] != gens[i - 1]
            evicted[i] = forgets[i] != forgets[i - 1]
        out: dict[str, Any] = {}
        if boundary.any() and (~boundary).any():
            out["rotation_batch_p99_ms"] = round(
                float(np.percentile(lat[boundary], 99)), 3)
            out["steady_batch_p99_ms"] = round(
                float(np.percentile(lat[~boundary], 99)), 3)
        if evicted.any():
            out["eviction_batches"] = int(evicted.sum())
            out["eviction_batch_max_ms"] = round(
                float(lat[evicted].max()), 3)
        return out


def _serve_one(session, batch: np.ndarray) -> QueryRecord:
    t0 = time.perf_counter()
    resp = session.recommend(batch)
    dt = time.perf_counter() - t0
    return QueryRecord(
        latency_s=dt,
        staleness_events=resp.staleness_events,
        snapshot_version=resp.snapshot_version,
        snapshot_forgets=resp.snapshot_forgets,
        cache_hits=resp.cache_hits,
        fallbacks=resp.fallbacks,
    )


def run_service(session, users, items, load: LoadConfig,
                svc: ServiceConfig = ServiceConfig()) -> ServiceReport:
    """Drive ``session`` with interleaved ingest + query traffic.

    ``users`` / ``items`` are the full event stream to ingest;
    ``load`` shapes the query side; ``svc`` picks the mode and mix.
    The session's own :class:`~repro_torch.serve.policy.PublishPolicy` governs
    snapshot cadence — for honest staleness numbers give it
    ``every > 0`` (ideally ``mode="async"``), else every query answers
    from the previous ``ingest`` call's final publish.
    """
    users = np.asarray(users)
    items = np.asarray(items)
    gen = QueryLoad(load)
    records: list[QueryRecord] = []

    # Per-run registry: each run_service call measures its own
    # distributions (summary() percentiles come from these histograms),
    # so repeated runs never cross-contaminate. The session's own
    # long-lived registry keeps accumulating independently.
    reg = metrics_lib.MetricsRegistry()
    lat_h = reg.histogram(
        "service_query_latency_seconds",
        "Query-batch latency under mixed load", labels=("under_load",))
    stale_h = reg.histogram(
        "service_staleness_events",
        "Staleness at answer under mixed load", labels=("under_load",))

    def observe(rec: QueryRecord) -> QueryRecord:
        lab = "true" if rec.under_load else "false"
        lat_h.labels(under_load=lab).observe(rec.latency_s)
        stale_h.labels(under_load=lab).observe(rec.staleness_events)
        return rec

    if svc.mode == "interleaved":
        ops = mixed_schedule(
            len(users), svc.query_batches,
            events_per_chunk=svc.events_per_chunk, seed=svc.schedule_seed)
        pos = 0
        ingest_wall = 0.0
        t0 = time.perf_counter()
        for op, k in ops:
            if op == "ingest":
                ti = time.perf_counter()
                session.ingest(users[pos:pos + k], items[pos:pos + k])
                ingest_wall += time.perf_counter() - ti
                pos += k
            else:
                # Drain pending async rotations so the answering snapshot
                # is a pure function of the schedule position — keeps this
                # mode bit-reproducible under PublishPolicy(mode="async").
                session.store.flush()
                records.append(observe(_serve_one(session, gen.batch())))
        session.store.flush(timeout=30.0)
        wall = time.perf_counter() - t0
    else:
        done = threading.Event()
        ingest_span = [0.0]
        ingest_err: list[BaseException | None] = [None]
        store = session.store
        grid = getattr(store, "mesh", None) is not None

        # On a grid: whether the last call's agreement saw a trainer
        # running on any rank (counted from before the thread starts).
        agreed = [True]

        def running() -> bool:
            """Whether the trainer runs, as every rank sees it on a grid,
            else as this thread sees it."""
            return agreed[0] if grid else not done.is_set()

        def _ingest():
            ti = time.perf_counter()
            try:
                session.ingest(users, items)
            except BaseException as e:  # re-raised on the caller after join
                ingest_err[0] = e
            finally:
                ingest_span[0] = time.perf_counter() - ti
                if grid:
                    store.end_training()
                done.set()

        trainer = threading.Thread(target=_ingest, name="service-ingest")
        # The trainer's Python-side dispatch loop holds the GIL between
        # (GIL-released) operator calls; at the default 5 ms switch interval a
        # query thread on a busy box can starve for tens of ms per serve.
        # Drop the handoff latency for the duration of the mixed run —
        # the standard CPython tuning for latency-sensitive service
        # threads sharing a process with a batch loop.
        prev_switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        t0 = time.perf_counter()
        try:
            if grid:
                store.begin_training()
            trainer.start()
            issued = 0
            # Open loop: issue batches paced by the arrival schedule while
            # the trainer runs; keep serving until both the stream ends
            # and the batch budget is spent, so the tail always includes
            # under-load batches. On a grid a batch is under load when
            # its agreement saw a trainer running.
            while issued < svc.query_batches or running():
                batch, pause = gen.batch(), gen.gap()
                live = running()
                rec = _serve_one(session, batch)
                if grid:
                    agreed[0] = live = store.last_agreement.training
                rec.under_load = live
                records.append(observe(rec))
                issued += 1
                if pause and not (issued >= svc.query_batches
                                  and not running()):
                    time.sleep(min(pause, 0.05))
            trainer.join()
            if ingest_err[0] is not None:
                # A crashed trainer must fail the run, not produce a
                # report claiming the full stream was processed.
                raise ingest_err[0]
        finally:
            sys.setswitchinterval(prev_switch)
        session.store.flush(timeout=30.0)
        wall = time.perf_counter() - t0
        ingest_wall = ingest_span[0]

    return ServiceReport(
        records=records,
        wall_s=wall,
        events_processed=int(len(users)),
        queries=len(records) * load.query_batch,
        ingest_wall_s=ingest_wall,
        publish_stats=session.store.stats_snapshot(),
        metrics=reg,
    )
