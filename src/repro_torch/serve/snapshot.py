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
publishing thread: the trainer's, on the default group, at the same
boundary on every rank (``publish`` and ``publish_async`` alike; the
publisher thread issues no collective). Every rank publishes the same
boundaries in the same order, and async publishes never coalesce
there: the trainer waits while two hand-offs are outstanding instead.
So a snapshot's ``version`` is the same boundary on every rank (the
grid's publish sequence), and ``agree`` (the front-end's first step of
a ``serve`` call, on the reader's thread) picks the one every rank
serves: one all-reduce on the mesh's serve group of each rank's front
version, progress, trainer flag and failure flag; every rank serves
the newest front, waiting for its own publisher to rotate it if it
lags, and keeps the snapshots from its front at the call on until it
has them (``_pin``), so the agreed one cannot rotate away meanwhile.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import state as state_lib
from repro_torch.obs import metrics as metrics_lib

__all__ = ["Snapshot", "SnapshotStore", "StaleSnapshotError",
           "Agreement", "popularity_topn"]

# Seconds a rank waits for its publisher to rotate the agreed snapshot.
AGREE_TIMEOUT = 300.0


class StaleSnapshotError(RuntimeError):
    """The front snapshot violates the caller's staleness bound."""


def popularity_topn(states, top_n: int, mesh=None, group: str = "train"):
    """Grid-wide most-popular items from a (stacked) worker state.

    Aggregates per-worker item rating mass (``state.item_stats``) by
    global id — an item replicated across the ``g`` workers of its row
    contributes all replicas' local counts — and returns the ``top_n``
    head ordered by (mass desc, id asc). With ``mesh`` (the process grid)
    ``states`` is this rank's worker and every rank's stats are gathered
    first (one collective on the mesh's ``group``), so every rank gets
    the grid's head.

    Returns:
      (ids int64[top_n] (-1 padded), mass float64[top_n]).
    """
    if mesh is None:
        ids, weight = state_lib.item_stats(states)
    else:
        from repro_torch.core import distributed

        ids, weight = distributed.gather_item_stats(mesh, states, group)
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


class Agreement(NamedTuple):
    """What the ranks agreed on for one ``serve`` call on the process
    grid: the snapshot's ``version`` and stream position, the grid's
    ``progress`` (the largest a rank reported), whether a rank's
    trainer was running (``SnapshotStore.begin_training``) and the
    all-reduces it took (two when no rank had a snapshot yet while a
    trainer ran, else one)."""

    version: int
    events_processed: int
    progress: int
    training: bool
    rounds: int = 1


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


def _handoff(states, ids, weight, events_processed, forgets,
             telemetry) -> _Handoff:
    """Enqueue the boundary's copies (``ids`` / ``weight``: the item stats
    the head aggregates) to the host; never waits for the card."""
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
        # The snapshots kept, oldest first, the front last: the last
        # ``slots`` and, while a grid reader agrees (``agree``), every
        # one from ``_pin`` on.
        self._slots = slots
        self._history: collections.deque[Snapshot] = collections.deque()
        self._pin: int | None = None
        self._version = 0
        self._progress = 0
        self._fallback_n = fallback_n
        self._lock = threading.Lock()
        # Signalled (under ``_lock``) after every rotation and hand-off.
        self._cond = threading.Condition(self._lock)
        self._listeners: list[Callable[[Snapshot], None]] = []
        # Async publish machinery: pending hand-offs (at most one in one
        # process, where a newer one replaces it; on a grid at most two
        # outstanding, rotating included, in order), drained by a
        # lazily-started daemon thread; ``_idle`` is set whenever nothing
        # is pending and no rotation is in flight. ``_draining`` is the
        # spawn gate: it flips true when a drain thread is started and
        # false only in the same critical section where that thread
        # decides to exit, so an enqueue can never observe a thread that
        # is alive but already past its exit decision.
        self._pending: collections.deque[_Handoff] = collections.deque()
        self._rotating = 0
        # On a grid: the hand-offs queued and taken up so far, and the
        # number of the one whose rotation failed (``_failed``).
        self._queued = 0
        self._taken = 0
        self._failed: BaseException | None = None
        self._failed_at = 0
        self._draining = False
        self._idle = threading.Event()
        self._idle.set()
        # Grid serving: trainers running on this rank (``begin_training``;
        # ``_train_lock`` guards the count), what the last ``agree``
        # returned, and the session's publish of its live states for a
        # call that finds no snapshot on any rank (``agree``).
        self._training = 0
        self._train_lock = threading.Lock()
        self.last_agreement: Agreement | None = None
        self.cold_publish: Callable[[], Any] | None = None
        # The rank's device (its card under NCCL, where the agreement's
        # buffer lives); the session sets it.
        self.device: Any = "cpu"
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
                mode: str, popular=None, group: str = "train") -> Snapshot:
        if popular is None:
            popular = popularity_topn(states, self._fallback_n, self.mesh,
                                      group)
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
            self._history.append(snap)             # the atomic rotation
            self._trim()
            self._progress = max(self._progress, snap.events_processed)
            listeners = list(self._listeners)
            self._c_rotations.labels(mode=mode).inc()
            self._g_front_version.set(snap.version)
            self._g_front_events.set(snap.events_processed)
            self._g_staleness.set(self._progress - snap.events_processed)
            self._cond.notify_all()
        for fn in listeners:    # outside the lock: listeners may acquire()
            fn(snap)
        return snap

    def _trim(self) -> None:
        """Drop the snapshots past the last ``slots`` that no grid reader
        holds (under the lock)."""
        h = self._history
        while len(h) > self._slots and (self._pin is None
                                        or h[0].version < self._pin):
            h.popleft()

    def _front_snapshot(self) -> Snapshot | None:
        return self._history[-1] if self._history else None

    def publish(self, states, events_processed: int, forgets: int = 0,
                telemetry=None, group: str = "train") -> Snapshot:
        """Synchronous publish: aggregate, rotate, then return.

        ``states`` must not change after the call (a copy of live
        states). Tensor progress scalars are read here (a host sync). On
        a grid the popularity head's gather runs on the mesh's ``group``:
        the trainer's (default) or, for the zero state a ``serve`` call
        publishes (``agree``), the reader's.
        """
        snap = self._rotate(states, events_processed, forgets, mode="sync",
                            group=group)
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
        ones.

        On a process grid every rank calls it at the same boundary: the
        grid's item stats are gathered here (one all-gather on the
        default group, the trainer's), and the hand-off is queued behind
        the pending one, never coalesced (how many publishes coalesce
        would differ by rank, and ``agree`` needs every rank to rotate
        the same boundaries): the call waits, before it queues, while two
        hand-offs are outstanding (queued or rotating). The wait is for
        the publisher thread, which issues no collective.
        """
        if self.mesh is None:
            ids, weight = state_lib.item_stats(states)
        else:
            from repro_torch.core import distributed

            ids, weight = distributed.gather_item_stats(self.mesh, states)
        handoff = _handoff(states, ids, weight, events_processed, forgets,
                           telemetry)
        with self._lock:
            if self.mesh is None:
                if self._pending:
                    self._c_coalesced.inc()
                    self._pending.clear()
            else:
                self._queued += 1
                self._cond.wait_for(
                    lambda: (len(self._pending) + self._rotating < 2
                             or self._failed is not None))
                if self._failed is not None:
                    # Every hand-off but the last has rotated or failed
                    # by now, on every rank: a failure among them raises
                    # here on every rank at this boundary. The last
                    # one's raises at the next boundary, or in flush.
                    if self._failed_at <= self._queued - 2:
                        raise RuntimeError("the snapshot publisher failed"
                                           ) from self._failed
                    return
            self._pending.append(handoff)
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
                    self._rotating = 0
                    self._cond.notify_all()
                    if not self._pending:
                        # Exit decision and spawn-gate clear are one
                        # critical section (see __init__): an enqueue
                        # serialized after this sees _draining False and
                        # spawns a fresh thread — no stranded hand-off.
                        self._draining = False
                        self._idle.set()
                        return
                    h = self._pending.popleft()
                    self._taken += 1
                    self._rotating = 1
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
        except BaseException as e:
            # A failing rotation (e.g. a raising listener) must not wedge
            # the store: reopen the spawn gate so the next enqueue
            # restarts draining, and don't leave flush() hanging. On a
            # grid the rank's boundaries are then lost: the hand-offs
            # queued behind are dropped, ``agree`` raises on every rank,
            # and so do the trainer's next hand-offs and ``flush``.
            with self._lock:
                self._draining = False
                self._rotating = 0
                if self.mesh is not None:
                    self._failed = e
                    self._failed_at = self._taken
                    self._pending.clear()
                self._cond.notify_all()
                if not self._pending:
                    self._idle.set()
            raise

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every pending async publish has rotated. On a
        process grid, raises ``RuntimeError`` once the rank's publisher
        has failed."""
        done = self._idle.wait(timeout)
        if self._failed is not None:
            raise RuntimeError("the snapshot publisher failed"
                               ) from self._failed
        return done

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
            snap = self._front_snapshot()
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
            snap = self._front_snapshot()
            return 0 if snap is None else self._progress - snap.events_processed

    @property
    def progress(self) -> int:
        """Latest reported stream position (events processed)."""
        with self._lock:
            return self._progress

    @property
    def latest_version(self) -> int:
        with self._lock:
            return self._version

    # -- the process grid ---------------------------------------------------

    def begin_training(self) -> None:
        """Count a trainer running on this rank (``ingest``, or a service
        run's trainer thread from before it starts); ``agree`` tells every
        rank whether one runs on any rank. Waits while a ``serve`` call
        that found no snapshot here decides whether to publish the zero
        state (``agree``)."""
        with self._train_lock:
            self._training += 1

    def end_training(self) -> None:
        with self._train_lock:
            self._training -= 1

    @property
    def training(self) -> bool:
        """Whether a trainer runs on this rank (``begin_training``)."""
        return self._training > 0

    def _wait_version(self, version: int) -> None:
        """Wait (under the lock) until this rank has rotated ``version``;
        raises ``RuntimeError`` on a failed publisher or after
        ``AGREE_TIMEOUT``."""
        def ready():
            front = self._front_snapshot()
            return ((front is not None and front.version >= version)
                    or self._failed is not None)

        if not self._cond.wait_for(ready, AGREE_TIMEOUT):
            raise RuntimeError(
                f"rank {self.mesh.rank}: snapshot v{version} not rotated "
                f"within {AGREE_TIMEOUT} s")
        if self._failed is not None:
            raise RuntimeError("the snapshot publisher failed"
                               ) from self._failed

    def agree(self, max_staleness_events: int | None = None) -> tuple:
        """The snapshot every rank of the grid serves for one call, and
        the :class:`Agreement`: one all-reduce (MAX) on the serve group
        of this rank's front version, progress, trainer flag and
        publisher failure (``core.distributed.serve_agree``). Every rank
        serves the newest front (waiting for its own publisher to rotate
        it; the ranks publish the same boundaries, and a snapshot from
        this rank's front at the call on is kept until then), raises
        ``StaleSnapshotError`` from the agreed progress, and raises
        ``RuntimeError`` when a rank's publisher failed: all ranks
        together.

        When no rank has a snapshot, every rank either publishes its live
        states (``cold_publish``, the zero state of a fresh session; its
        popularity gather on the serve group) when no trainer runs on
        any rank, holding its trainer back meanwhile, or, while one runs,
        waits for its first rotation and agrees again. Returns
        ``(snapshot, agreement)``."""
        from repro_torch.core import distributed

        rounds = 0
        try:
            while True:
                rounds += 1
                with self._lock:
                    front = self._front_snapshot()
                    mine = 0 if front is None else front.version
                    self._pin = mine
                    progress = self._progress
                    failed = self._failed is not None
                cold = mine == 0
                if cold:        # no ingest may start here until decided
                    self._train_lock.acquire()
                try:
                    version, progress, training, failed = (
                        distributed.serve_agree(
                            self.mesh,
                            [mine, progress, self._training > 0, failed],
                            self.device))
                    if failed:
                        raise RuntimeError(
                            "a rank's snapshot publisher failed")
                    if version == 0 and not training:
                        if self.cold_publish is None:
                            raise LookupError("no snapshot published yet")
                        self.cold_publish()
                        version = 1
                finally:
                    if cold:
                        self._train_lock.release()
                if version:
                    break
                with self._lock:        # a trainer runs: its first boundary
                    self._wait_version(1)
            with self._lock:
                self._wait_version(version)
                snap = next(s for s in self._history if s.version == version)
        finally:
            with self._lock:
                self._pin = None
                self._trim()
        agreement = Agreement(version, snap.events_processed, progress,
                              bool(training), rounds)
        self.last_agreement = agreement
        stale = progress - snap.events_processed
        if max_staleness_events is not None and stale > max_staleness_events:
            raise StaleSnapshotError(
                f"snapshot v{snap.version} is {stale} events behind the "
                f"stream (bound {max_staleness_events}); publish more often "
                "or loosen the bound")
        return snap, agreement
