"""Micro-batched query front-end: cache, re-queue, popularity fallback.

Port of ``repro/serve/frontend.py:47-334``: ``ServeConfig``,
``ServeResponse`` and ``QueryFrontend``. Production serving traffic is
many small point queries; the grid plane wants dense batches. This
front-end sits between them:

  * incoming user ids are answered from an LRU response cache when the
    cache entry was computed against the current snapshot *generation*
    (snapshot version, forgetting counter). Invalidation is lazy: a
    rotation does NOT eagerly flush the cache — each entry is stamped
    with the generation it was computed under and is treated as a miss
    (and dropped) on its next lookup, so the serve path never pays an
    O(cache) clear when the trainer publishes;
  * misses are packed into fixed-size micro-batches for ``grid_topn``
    (one serve-leaf kernel launch each, on the snapshot's device);
    queries that overflow their column's bucket capacity come back
    un-served and are re-queued into the next batch (the same
    backpressure contract as the training dispatch);
  * users unknown on every worker of their column get the snapshot's
    popularity head instead of an empty list — the classic cold-start
    answer — flagged ``known=False`` in the response.

The front-end is synchronous and single-threaded by design: one
``serve`` call = one consistent snapshot. Its ``grid_topn`` calls run on
the calling thread's current stream, so during training they queue
behind the training steps already enqueued there. Staleness is enforced
at acquire time via ``ServeConfig.publish.max_staleness_events``.

On the process grid (the store's ``mesh``, ``backend="shard_map"``)
every rank runs ``serve`` with the same ids, one call at a time. A call
that may race the trainer (on a reader thread, or while ``ingest``
runs) begins with the ranks' agreement on the snapshot
(``SnapshotStore.agree``: one all-reduce on the mesh's serve group; a
call in program order between ``ingest`` calls needs none), so every rank
answers from the same snapshot, stamps its cache with the same
generation and decides the staleness bound from the same values,
whenever its own publisher rotated: its cache, micro-batches and
fallback rows evolve alike on every rank, so every rank makes the same
plane calls, each one all-gather of the partial lists on the serve
group (``plane.grid_topn(mesh=)``), and gets the same answer. The serve
stats then also count the ranks, those all-gathers and the agreements.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.obs import metrics as metrics_lib
from repro_torch.serve import plane
from repro_torch.serve.policy import PublishPolicy
from repro_torch.serve.snapshot import SnapshotStore

__all__ = ["ServeConfig", "ServeResponse", "QueryFrontend"]


def _resident(storage):
    """A storage policy as the serve leaves take it: None for the default
    (compute-form states, no decode), else the policy."""
    return None if storage is None or storage.is_default else storage


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static parameters of the serving plane."""

    algorithm: str = "disgd"              # registry key (core/algorithm.py)
    grid: routing.GridSpec = routing.GridSpec(1)
    u_cap: int = 1024
    top_n: int = 10
    k_nn: int = 10                        # DICS neighborhood (Eq. 7)
    batch_size: int = 64                  # query micro-batch
    query_capacity: int = 0               # per-column bucket; 0 = auto
    capacity_factor: float = 2.0          # auto qcap vs fair share
    use_kernel: bool = True               # serve through the leaf's kernel
    cache_capacity: int = 4096            # LRU response-cache entries
    # Publish-plane contract (cadence, async/sync, staleness bound).
    publish: PublishPolicy = PublishPolicy()
    # Resident encoding of the published states (a StoragePolicy when
    # the trainer stores compressed tables; None = compute-form states).
    storage: object = None

    @property
    def max_staleness_events(self) -> int | None:
        """The policy's staleness bound (the pre-policy field, read-only)."""
        return self.publish.max_staleness_events

    @property
    def qcap(self) -> int:
        if self.query_capacity:
            return min(self.query_capacity, self.batch_size)
        return plane.query_capacity(self.batch_size, self.grid.g,
                                    self.capacity_factor)

    @classmethod
    def from_stream(cls, stream_cfg, **overrides) -> "ServeConfig":
        """Derive the serving parameters from a training ``StreamConfig``."""
        hyper = stream_cfg.resolved_hyper()
        fields = dict(
            algorithm=stream_cfg.algorithm,
            grid=stream_cfg.grid,
            u_cap=hyper.u_cap,
            top_n=hyper.top_n,
            k_nn=getattr(hyper, "k_nn", 10),
            # None under the default (identity) policy, as in JAX.
            storage=_resident(stream_cfg.storage),
        )
        fields.update(overrides)
        return cls(**fields)


@dataclasses.dataclass
class ServeResponse:
    ids: np.ndarray       # i32[Q, N] global item ids, -1 padded
    scores: np.ndarray    # f32[Q, N]; popularity mass on fallback rows
    known: np.ndarray     # bool[Q] False -> answered by popularity fallback
    snapshot_version: int
    cache_hits: int       # positions answered without touching the plane
    fallbacks: int        # positions answered by the popularity head
    staleness_events: int = 0   # events the answering snapshot trailed by
    snapshot_forgets: int = 0   # forgetting counter of the answering snapshot


class QueryFrontend:
    """Serves point queries against the freshest published snapshot."""

    # The pre-registry ad-hoc counter keys, preserved verbatim as the
    # stats_snapshot() vocabulary; each maps to a ``serve_<key>_total``
    # counter in the registry.
    _COUNTER_KEYS = ("queries", "cache_hits", "fallbacks", "requeued",
                     "plane_batches", "invalidations", "lazy_drops",
                     "retargets")
    _COUNTER_HELP = {
        "queries": "Point queries received",
        "cache_hits": "Queries answered from the LRU response cache",
        "fallbacks": "Queries answered by the popularity head",
        "requeued": "Queries re-queued on column bucket overflow",
        "plane_batches": "grid_topn micro-batches dispatched",
        "invalidations": "Snapshot-generation transitions observed",
        "lazy_drops": "Stale cache entries dropped at lookup",
        "retargets": "Front-end regrid retargets",
    }

    def __init__(self, store: SnapshotStore, cfg: ServeConfig,
                 registry: metrics_lib.MetricsRegistry | None = None):
        self.store = store
        self.cfg = cfg
        # uid -> (generation, ids, scores, known). Entries from older
        # generations are lazily dropped at lookup time, never by an
        # eager flush on rotation.
        self._cache: collections.OrderedDict[int, tuple] = collections.OrderedDict()
        self._seen_gen: tuple = (-1, -1)
        # Share the store's registry by default, so one scrape covers
        # the whole serving plane; get-or-create is idempotent, so the
        # session's recommend(n=...) path (a fresh frontend on the same
        # store) binds to the same counters.
        if registry is None:
            registry = getattr(store, "metrics", None)
        self.metrics = (registry if registry is not None
                        else metrics_lib.MetricsRegistry())
        self._c = {k: self.metrics.counter(f"serve_{k}_total",
                                           self._COUNTER_HELP[k])
                   for k in self._COUNTER_KEYS}
        self._h_latency = self.metrics.histogram(
            "serve_latency_seconds", "serve() wall time per call")
        self._h_staleness = self.metrics.histogram(
            "serve_staleness_events",
            "Staleness of the answering snapshot (events)")

    # -- cache ------------------------------------------------------------

    @staticmethod
    def _generation(snap) -> tuple:
        """Cache-validity epoch: advances on rotation or forgetting."""
        return (snap.version, snap.forgets)

    def _note_epoch(self, gen: tuple) -> None:
        """Track epoch transitions for the stats counter only — the cache
        itself is invalidated lazily, entry by entry, at lookup."""
        if gen != self._seen_gen:
            if self._cache:
                self._c["invalidations"].inc()
            self._seen_gen = gen

    def _cache_get(self, uid: int, gen: tuple):
        """A cached answer computed under ``gen``, else None (stale
        entries are dropped here — lazy invalidation)."""
        hit = self._cache.get(uid)
        if hit is None:
            return None
        if hit[0] != gen:
            del self._cache[uid]        # stale generation: lazy drop
            self._c["lazy_drops"].inc()
            return None
        self._cache.move_to_end(uid)
        return hit[1]

    def _cache_put(self, uid: int, gen: tuple, entry: tuple) -> None:
        self._cache[uid] = (gen, entry)
        self._cache.move_to_end(uid)
        while len(self._cache) > self.cfg.cache_capacity:
            self._cache.popitem(last=False)

    # -- elasticity ------------------------------------------------------

    def retarget(self, grid, u_cap: int | None = None, storage=...) -> None:
        """Point the front-end at a resharded grid (``core/regrid``).

        Swaps the static plane parameters and drops every cached answer — lists computed against the old shape may
        disagree with the resharded state's merges. (This is the one
        eager flush left: a regrid changes the meaning of every entry,
        not just its freshness.) The snapshot store is shape-agnostic,
        so the same store keeps serving across the rescale; callers
        publish the first post-regrid snapshot and then retarget.
        ``storage`` (a StoragePolicy or None) follows a policy migration;
        the default policy becomes None.
        """
        over = {"grid": grid}
        if u_cap is not None:
            over["u_cap"] = u_cap
        if storage is not ...:
            over["storage"] = _resident(storage)
        self.cfg = dataclasses.replace(self.cfg, **over)
        self._cache.clear()
        self._seen_gen = (-1, -1)
        self._c["retargets"].inc()

    # -- the serving loop -------------------------------------------------

    def _compute(self, snap, gen, uids: list[int]) -> dict:
        """Run the grid plane for ``uids``; returns {uid: entry} and fills
        the cache. Overflowed queries re-queue into the next micro-batch.

        The returned dict — not the cache — is what answers this call:
        the LRU may evict an entry computed earlier in the same call when
        the unique-query count exceeds ``cache_capacity``.
        """
        cfg = self.cfg
        device = snap.states.tables.user_ids.device
        mesh = getattr(self.store, "mesh", None)
        computed = {}
        queue = collections.deque(uids)
        while queue:
            batch = [queue.popleft()
                     for _ in range(min(cfg.batch_size, len(queue)))]
            arr = np.full(cfg.batch_size, -1, np.int64)
            arr[:len(batch)] = batch
            out = plane.grid_topn(
                snap.states, torch.as_tensor(arr, device=device),
                algorithm=cfg.algorithm, grid=cfg.grid,
                top_n=cfg.top_n, u_cap=cfg.u_cap, qcap=cfg.qcap,
                k_nn=cfg.k_nn, use_kernel=cfg.use_kernel,
                storage=cfg.storage, mesh=mesh)
            ids, scores, known, served = (t.cpu().numpy() for t in out)
            self._c["plane_batches"].inc()
            if mesh is not None:
                self._grid_counter("collectives").inc()
            progress = False
            for j, uid in enumerate(batch):
                if served[j]:
                    progress = True
                    entry = (ids[j], scores[j], bool(known[j]))
                    computed[uid] = entry
                    self._cache_put(uid, gen, entry)
                else:               # column bucket overflow: try next batch
                    self._c["requeued"].inc()
                    queue.append(uid)
            if not progress:
                raise RuntimeError(
                    "query dispatch made no progress; "
                    f"qcap={cfg.qcap} cannot be right for batch={batch}")
        return computed

    def serve(self, user_ids, agree: bool = True) -> ServeResponse:
        """Answer a batch of point queries (any length, duplicates fine).

        On a process grid the call begins with the ranks' agreement
        unless ``agree`` is false: the caller knows that every rank's
        front is already the same snapshot (between the ``ingest`` calls
        of the thread that runs them, in program order)."""
        t0 = time.perf_counter()
        cfg = self.cfg
        bound = cfg.publish.max_staleness_events
        if getattr(self.store, "mesh", None) is None or not agree:
            snap, progress = self.store.acquire(bound), None
        else:
            snap, agreement = self.store.agree(bound)
            progress = agreement.progress
            self._grid_counter("agreements").inc(agreement.rounds)
        gen = self._generation(snap)
        self._note_epoch(gen)

        uids = np.asarray(user_ids, np.int64).reshape(-1)
        self._c["queries"].inc(int(uids.size))
        # Resolve cache hits BEFORE computing misses: _compute's LRU
        # insertions may evict a previously-cached uid of this very call,
        # so answers are assembled from this local dict, never from the
        # cache after the fact.
        resolved, from_cache, missing = {}, set(), []
        for uid in uids.tolist():
            if uid < 0 or uid in resolved or uid in from_cache:
                continue
            entry = self._cache_get(uid, gen)
            if entry is not None:
                resolved[uid] = entry
                from_cache.add(uid)
            else:
                missing.append(uid)
                resolved[uid] = None    # placeholder: dedupes the queue
        if missing:
            resolved.update(self._compute(snap, gen, missing))

        n = min(cfg.top_n, len(snap.popular_ids))
        out_ids = np.full((uids.size, cfg.top_n), -1, np.int32)
        out_scores = np.full((uids.size, cfg.top_n), -np.inf, np.float32)
        out_known = np.zeros(uids.size, bool)
        cache_hits = fallbacks = 0
        for i, uid in enumerate(uids.tolist()):
            if uid < 0:
                continue
            entry = resolved.get(uid)
            if entry is None:       # unreachable: every uid was resolved
                continue            # above; belt and braces
            if uid in from_cache:
                cache_hits += 1
            ids_row, scores_row, known_row = entry
            if known_row:
                m = min(cfg.top_n, ids_row.shape[0])
                out_ids[i, :m] = ids_row[:m]
                out_scores[i, :m] = scores_row[:m]
                out_known[i] = True
            else:                   # cold start: popularity head
                head = snap.popular_ids[:n]
                live = head >= 0    # keep -inf padding convention when the
                out_ids[i, :n] = head    # grid has < top_n live items
                out_scores[i, :n] = np.where(
                    live, snap.popular_mass[:n], -np.inf)
                fallbacks += 1
        self._c["cache_hits"].inc(cache_hits)
        self._c["fallbacks"].inc(fallbacks)
        if progress is None:
            progress = self.store.progress
        staleness = max(0, progress - snap.events_processed)
        self._h_staleness.observe(staleness)
        self._h_latency.observe(time.perf_counter() - t0)
        return ServeResponse(
            ids=out_ids, scores=out_scores, known=out_known,
            snapshot_version=snap.version,
            cache_hits=cache_hits, fallbacks=fallbacks,
            staleness_events=staleness,
            snapshot_forgets=snap.forgets)

    # -- stats ------------------------------------------------------------

    _GRID_HELP = {
        "collectives": "Plane collectives on the process grid (one "
                       "all-gather a micro-batch)",
        "agreements": "Snapshot agreement all-reduces on the process "
                      "grid (one a serve call, two for a call that waits "
                      "for the first boundary)",
    }

    def _grid_counter(self, key: str):
        return self.metrics.counter(f"serve_{key}_total",
                                    self._GRID_HELP[key])

    def stats_snapshot(self) -> dict[str, int]:
        """The serve counters as plain ints (registry-backed).

        Same key vocabulary as the pre-registry ``stats`` dict; the
        counters themselves live in ``self.metrics`` as
        ``serve_<key>_total``. On the process grid, also ``ranks`` (the
        group's size), ``collectives`` (the plane's all-gathers) and
        ``agreements`` (the serve calls' all-reduces), both on the serve
        group.
        """
        out = {k: int(c.value) for k, c in self._c.items()}
        mesh = getattr(self.store, "mesh", None)
        if mesh is not None:
            out["ranks"] = mesh.world
            for key in self._GRID_HELP:
                out[key] = int(self._grid_counter(key).value)
        return out
