"""Snapshot double-buffering: serve a consistent grid while training runs.

Port of ``repro/serve/snapshot.py:68-354``: ``popularity_topn``,
``Snapshot``, ``StaleSnapshotError`` and ``SnapshotStore``. The engine
publishes worker states at micro-batch boundaries
(``engine.run_stream_device(publish_every=..., on_publish=...)``); this
store is the subscriber. It keeps a small ring of snapshot slots
(double-buffered by default): a publish writes the incoming states into
the back slot and then atomically rotates it to the front, so
``acquire`` always returns a complete snapshot taken exactly at a
micro-batch boundary. The port updates states in place, so what a
publish hands over must be a copy (``state.clone_state``; the engine's
``PublishEvent.states`` is one): the store keeps references and copies
nothing itself.

Two publish paths share the rotation:

  * ``publish``       — synchronous: popularity aggregation + rotation
    complete before the call returns.
  * ``publish_async`` — the trainer's boundary. On the trainer's thread
    it enqueues non-blocking copies of what the rotation reads — the
    per-slot item ids and popularity weights, any tensor progress
    scalars and the telemetry vector — into pinned host buffers, records one CUDA event after
    them, and returns. A publisher thread waits on that event and on
    nothing else (a plain ``.cpu()`` there would wait behind every
    training step enqueued since the boundary), then aggregates the
    popularity head and rotates. The backlog is bounded: at most one
    pending copy is kept, and a newer ``publish_async`` replaces it,
    counted in ``snapshot_coalesced_total`` (``stats_snapshot()
    ["coalesced"]``), so ``async_rotations + coalesced`` equals the
    ``publish_async`` calls once ``flush()`` returns.

Post-rotation listeners (``subscribe``) fire after every rotation,
outside the store lock.

Bounded staleness: the trainer reports stream progress via
``report_progress`` — publishes do this implicitly — and ``acquire``
raises ``StaleSnapshotError`` when the front snapshot has fallen more
than ``max_staleness_events`` processed events behind that progress.

Each snapshot also carries the grid-wide popularity head
(``popularity_topn`` over the paper's frequency statistics), the
front-end's fallback answer for unknown users.

On the process grid (``mesh=``, ``backend="shard_map"``) a snapshot
holds the rank's own worker, and the popularity head is aggregated from
every rank's item ids and weights, gathered in one collective on the
publishing thread; every rank publishes at the same points, and only
synchronously (``publish_async`` raises: ROADMAP item 14c).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import state as state_lib
from repro_torch.obs import metrics as metrics_lib

__all__ = ["Snapshot", "SnapshotStore", "StaleSnapshotError",
           "popularity_topn"]


class StaleSnapshotError(RuntimeError):
    """The front snapshot violates the caller's staleness bound."""


def popularity_topn(states, top_n: int, mesh=None):
    """Grid-wide most-popular items from a (stacked) worker state.

    Aggregates per-worker item rating mass (``state.item_stats``) by
    global id — an item replicated across the ``g`` workers of its row
    contributes all replicas' local counts — and returns the ``top_n``
    head ordered by (mass desc, id asc). With ``mesh`` (the process grid)
    ``states`` is this rank's worker and every rank's stats are gathered
    first (one collective), so every rank gets the grid's head.

    Returns:
      (ids int64[top_n] (-1 padded), mass float64[top_n]).
    """
    if mesh is None:
        ids, weight = state_lib.item_stats(states)
    else:
        from repro_torch.core import distributed

        ids, weight = distributed.gather_item_stats(mesh, states)
    return _popularity_head(ids.cpu().numpy(), weight.cpu().numpy(), top_n)


def _popularity_head(ids: np.ndarray, weight: np.ndarray, top_n: int):
    ids = ids.reshape(-1)
    weight = np.asarray(weight, np.float64).reshape(-1)
    live = ids >= 0
    ids, weight = ids[live], weight[live]
    out_ids = np.full(top_n, -1, np.int64)
    out_mass = np.zeros(top_n, np.float64)
    if ids.size:
        uniq, inverse = np.unique(ids, return_inverse=True)
        mass = np.zeros(uniq.size, np.float64)
        np.add.at(mass, inverse, weight)
        order = np.lexsort((uniq, -mass))[:top_n]
        out_ids[:order.size] = uniq[order]
        out_mass[:order.size] = mass[order]
    return out_ids, out_mass


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One published, read-only grid state at a micro-batch boundary."""

    states: Any               # [n_c, ...] worker states (a copy; never updated)
    version: int              # monotonically increasing publish counter
    events_processed: int     # stream position of the boundary
    forgets: int              # forgetting triggers fired up to the boundary
    popular_ids: np.ndarray   # popularity-fallback head (global ids)
    popular_mass: np.ndarray  # its rating mass (fallback "scores")


class _Handoff(NamedTuple):
    """What an async publish's rotation reads, on the host or on its way
    there: ``done`` (a CUDA event, or None for CPU tensors) marks the end
    of the copies into the pinned buffers."""

    states: Any
    item_ids: torch.Tensor
    item_weight: torch.Tensor
    events_processed: Any
    forgets: Any
    telemetry: Any
    done: Any


def _handoff(states, events_processed, forgets, telemetry) -> _Handoff:
    """Enqueue the boundary's copies to the host; never waits for the
    card."""
    ids, weight = state_lib.item_stats(states)
    if ids.device.type != "cuda":
        scalars = (x.clone() if torch.is_tensor(x) else x
                   for x in (events_processed, forgets))
        return _Handoff(states, ids.clone(), weight.clone(), *scalars,
                        telemetry, None)

    def to_host(x):
        if not torch.is_tensor(x):
            return x
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return buf.copy_(x, non_blocking=True)

    ids_h, weight_h, ev_h, forgets_h = (
        to_host(x) for x in (ids, weight, events_processed, forgets))
    if telemetry is not None:
        # The fold reads the vector on the publisher thread: from the
        # host copies, behind the same event.
        telemetry = type(telemetry)(*(to_host(x) for x in telemetry))
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(ids.device))
    return _Handoff(states, ids_h, weight_h, ev_h, forgets_h, telemetry, done)


class SnapshotStore:
    """Double-buffered snapshot exchange between trainer and servers.

    Thread-safe; the rotation is a single front-index assignment under a
    lock, so readers either get the old complete snapshot or the new
    complete one, never a mix.
    """

    def __init__(self, slots: int = 2, fallback_n: int = 100,
                 registry: metrics_lib.MetricsRegistry | None = None,
                 mesh=None):
        if slots < 2:
            raise ValueError("double-buffering needs at least 2 slots")
        # The process grid the published states are a rank's worker of
        # (``launch.mesh.Mesh``), or None in one process.
        self.mesh = mesh
        self._slots: list[Snapshot | None] = [None] * slots
        self._front = -1
        self._version = 0
        self._progress = 0
        self._fallback_n = fallback_n
        self._lock = threading.Lock()
        self._listeners: list[Callable[[Snapshot], None]] = []
        # Async publish machinery: at most one pending hand-off, drained
        # by a lazily-started daemon thread; ``_idle`` is set whenever
        # nothing is pending and no rotation is in flight. ``_draining``
        # is the spawn gate: it flips true when a drain thread is started
        # and false only in the same critical section where that thread
        # decides to exit, so an enqueue can never observe a thread that
        # is alive but already past its exit decision.
        self._pending: _Handoff | None = None
        self._draining = False
        self._idle = threading.Event()
        self._idle.set()
        # Publish-plane instruments, shared with whoever passed the
        # registry in (StreamSession wires one registry through store and
        # front-end); a store constructed bare gets its own.
        self.metrics = (registry if registry is not None
                        else metrics_lib.MetricsRegistry())
        self._c_rotations = self.metrics.counter(
            "snapshot_rotations_total", "Snapshot rotations by publish "
            "path", labels=("mode",))
        self._c_coalesced = self.metrics.counter(
            "snapshot_coalesced_total", "Async publishes coalesced away "
            "under backlog")
        self._g_front_version = self.metrics.gauge(
            "snapshot_front_version", "Version of the front snapshot")
        self._g_front_events = self.metrics.gauge(
            "snapshot_front_events", "Stream position of the front "
            "snapshot (events)")
        self._g_staleness = self.metrics.gauge(
            "snapshot_staleness_events", "Events the front snapshot "
            "trails reported stream progress")
        # Fold target for a boundary's telemetry vector (the session's
        # TelemetryFolder), or None.
        self._telemetry_sink: Callable[[Any], Any] | None = None

    # -- the rotation (shared by both publish paths) ----------------------

    def _rotate(self, states, events_processed: int, forgets: int,
                mode: str, popular=None) -> Snapshot:
        if popular is None:
            popular = popularity_topn(states, self._fallback_n, self.mesh)
        popular_ids, popular_mass = popular
        with self._lock:
            self._version += 1
            snap = Snapshot(
                states=states,
                version=self._version,
                events_processed=int(events_processed),
                forgets=int(forgets),
                popular_ids=popular_ids,
                popular_mass=popular_mass,
            )
            back = (self._front + 1) % len(self._slots)
            self._slots[back] = snap
            self._front = back                     # the atomic rotation
            self._progress = max(self._progress, snap.events_processed)
            listeners = list(self._listeners)
            self._c_rotations.labels(mode=mode).inc()
            self._g_front_version.set(snap.version)
            self._g_front_events.set(snap.events_processed)
            self._g_staleness.set(self._progress - snap.events_processed)
        for fn in listeners:    # outside the lock: listeners may acquire()
            fn(snap)
        return snap

    def publish(self, states, events_processed: int, forgets: int = 0,
                telemetry=None) -> Snapshot:
        """Synchronous publish: aggregate, rotate, then return.

        ``states`` must not change after the call (a copy of live
        states). Tensor progress scalars are read here (a host sync).
        """
        snap = self._rotate(states, events_processed, forgets, mode="sync")
        if telemetry is not None and self._telemetry_sink is not None:
            self._telemetry_sink(telemetry)
        return snap

    # -- async publish ----------------------------------------------------

    def publish_async(self, states, events_processed, forgets=0,
                      telemetry=None) -> None:
        """Hand a boundary's states over; the rotation happens off-thread.

        The call is the trainer's publish boundary: it enqueues the
        copies to pinned host memory and one event, and never waits for
        the card. ``events_processed`` / ``forgets`` may be 0-d tensors.
        A hand-off still pending is replaced by this one and counted as
        coalesced: the freshest state is served, never a queue of stale
        ones. Raises ``ValueError`` on a process grid: how many publishes
        coalesce differs by rank, and the ranks must agree on the
        snapshot they serve (ROADMAP item 14c).
        """
        if self.mesh is not None:
            raise ValueError(
                "async publishing on a process grid (backend='shard_map') "
                "is ROADMAP Queue 1 item 14c; publish synchronously")
        handoff = _handoff(states, events_processed, forgets, telemetry)
        with self._lock:
            if self._pending is not None:
                self._c_coalesced.inc()
            self._pending = handoff
            self._idle.clear()
            if not self._draining:
                self._draining = True
                threading.Thread(target=self._drain_forever,
                                 name="snapshot-publisher",
                                 daemon=True).start()

    def _drain_forever(self) -> None:
        try:
            while True:
                with self._lock:
                    if self._pending is None:
                        # Exit decision and spawn-gate clear are one
                        # critical section (see __init__): an enqueue
                        # serialized after this sees _draining False and
                        # spawns a fresh thread — no stranded hand-off.
                        self._draining = False
                        self._idle.set()
                        return
                    h, self._pending = self._pending, None
                # The one wait of the async path: the boundary's copies
                # to the host, not the training enqueued after them.
                if h.done is not None:
                    h.done.synchronize()
                popular = _popularity_head(h.item_ids.numpy(),
                                           h.item_weight.numpy(),
                                           self._fallback_n)
                self._rotate(h.states, int(h.events_processed),
                             int(h.forgets), mode="async", popular=popular)
                if (h.telemetry is not None
                        and self._telemetry_sink is not None):
                    self._telemetry_sink(h.telemetry)
        except BaseException:
            # A failing rotation (e.g. a raising listener) must not wedge
            # the store: reopen the spawn gate so the next enqueue
            # restarts draining, and don't leave flush() hanging.
            with self._lock:
                self._draining = False
                if self._pending is None:
                    self._idle.set()
            raise

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every pending async publish has rotated."""
        return self._idle.wait(timeout)

    def set_telemetry_sink(self, fn: Callable[[Any], Any] | None) -> None:
        """Install the fold target for publish-boundary telemetry
        vectors. The sink runs on the publisher thread for async
        publishes and inline for sync ones, always outside the lock."""
        self._telemetry_sink = fn

    def stats_snapshot(self) -> dict[str, int]:
        """The publish counters as plain ints (registry-backed):
        ``snapshot_rotations_total{mode=}`` and
        ``snapshot_coalesced_total``."""
        a = int(self._c_rotations.labels(mode="async").value)
        s = int(self._c_rotations.labels(mode="sync").value)
        return {"async_rotations": a, "sync_rotations": s,
                "rotations": a + s,
                "coalesced": int(self._c_coalesced.value)}

    # -- subscribers ------------------------------------------------------

    def subscriber(self, mode: str = "sync"):
        """Adapter for the engine hook: ``on_publish=store.subscriber()``.

        ``mode="async"`` routes through :meth:`publish_async` (the
        non-blocking path); default is the synchronous rotation. The
        event's states are already a copy.
        """
        pub = self.publish_async if mode == "async" else self.publish

        def _on_publish(ev):
            pub(ev.states, ev.events_processed, ev.forgets,
                telemetry=getattr(ev, "telemetry", None))
        return _on_publish

    def subscribe(self, fn: Callable[[Snapshot], None]) -> None:
        """Call ``fn(snapshot)`` after every rotation (outside the lock):
        inline for sync publishes, on the publisher thread for async
        ones."""
        with self._lock:
            self._listeners.append(fn)

    # -- readers ----------------------------------------------------------

    def acquire(self, max_staleness_events: int | None = None) -> Snapshot:
        """The front snapshot; optionally enforce a staleness bound."""
        with self._lock:
            snap = self._slots[self._front] if self._front >= 0 else None
            progress = self._progress
        if snap is None:
            raise LookupError("no snapshot published yet")
        if (max_staleness_events is not None
                and progress - snap.events_processed > max_staleness_events):
            raise StaleSnapshotError(
                f"snapshot v{snap.version} is {progress - snap.events_processed}"
                f" events behind the stream (bound {max_staleness_events});"
                " publish more often or loosen the bound")
        return snap

    def report_progress(self, events_processed: int) -> None:
        """Advance the trainer's stream position (drives the staleness check)."""
        with self._lock:
            self._progress = max(self._progress, int(events_processed))

    def staleness(self) -> int:
        """Processed events the front snapshot is behind reported progress."""
        with self._lock:
            if self._front < 0:
                return 0
            return self._progress - self._slots[self._front].events_processed

    @property
    def progress(self) -> int:
        """Latest reported stream position (events processed)."""
        with self._lock:
            return self._progress

    @property
    def latest_version(self) -> int:
        with self._lock:
            return self._version
