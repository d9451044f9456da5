"""StreamSession — one public facade over training and serving.

Port of ``repro/session.py:54-291``: the ``ingest`` / ``recommend``
lifecycle over the snapshot store and the query front-end:

    cfg = repro_torch.StreamConfig(algorithm="disgd",
                                   grid=repro_torch.GridSpec(2))
    session = repro_torch.StreamSession(
        cfg, publish=repro_torch.PublishPolicy(every=8, mode="async"))
    session.ingest(users, items)        # incremental; call repeatedly
    session.recommend(user_ids)         # snapshot-backed grid top-N

The session owns the plumbing — carrying states across calls and the
serving snapshot — never the math. Algorithms resolve through the
registry (``repro_torch.core.algorithm``), so a session drives any
registered algorithm (``"disgd"``, ``"dics"``, ``"bpr"``) the same way.
Publishing is governed by one :class:`~repro_torch.serve.policy.
PublishPolicy`: cadence (``every`` micro-batches), sync vs async
rotation, and the read-side staleness bound.

The session threads the adaptive drift detector and the overflow
re-queue across ``ingest`` calls and folds each run's telemetry vector
into its registry (``obs.telemetry.TelemetryFolder``, the store's
telemetry sink: the ``stream_*`` counters). ``checkpoint`` writes a
grid-portable checkpoint (detector included) that either package
restores; ``restore`` resumes one at any grid; ``rescale`` reshapes the
live grid, its capacities and its storage policy in one regrid
(``repro/session.py:222-291``).

With ``backend="shard_map"`` the session runs on a process grid: every
rank of a ``torch.distributed`` group (``launch.mesh.run_on_ranks``)
runs the same session code with the same arguments (SPMD) and holds
only its own worker (``launch.mesh.make_grid_mesh``: worker ``w`` on
rank ``w``; ranks past the grid hold none). ``states`` is the rank's
worker; the snapshots, the popularity head, ``recommend``'s answers,
``checkpoint``'s file, ``restore`` and ``rescale`` equal the one-process
session's, through the collectives of ``core.distributed``. Under an
async policy the boundaries are handed to each rank's publisher thread
(``SnapshotStore.publish_async``: the popularity gather on the
trainer's thread, the default group; never coalesced on a grid), and
``recommend`` may run on one reader thread a rank while ``ingest``
runs: its calls are serialized, and each begins with the ranks'
agreement on the snapshot (``SnapshotStore.agree``), so that every
rank answers from the same one, with its collectives on the mesh's
serve group. A call that finds no snapshot on any rank publishes the
zero state when no rank's trainer runs, else waits for the first
boundary. A call in program order on the thread that runs ``ingest``
needs no agreement: every rank's front is then the same.
``checkpoint`` and ``rescale`` drain the async backlog first.

    def rank(info, users, items, cfg):  # cfg.backend == "shard_map"
        s = StreamSession(cfg, publish=PublishPolicy(every=2, mode="async"))
        reader = threading.Thread(target=s.recommend, args=(users[:4],))
        reader.start()                  # serves during the ingest
        s.ingest(users, items)
        reader.join()
        return s.recommend(users[:4]).ids
    launch.mesh.run_on_ranks(rank, 4, "cuda", users, items, cfg)

(``rank`` must be importable by the spawned ranks: a module-level
function; ``launch.mesh.session_on_rank`` is one.)
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import distributed
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import state as state_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core.pipeline import (RestoredCheckpoint, StreamConfig,
                                       StreamResult,
                                       restore_stream_checkpoint, run_stream,
                                       save_stream_checkpoint)
from repro_torch.core.routing import GridSpec
from repro_torch.launch.mesh import make_grid_mesh
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import telemetry as telemetry_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.serve import (PublishPolicy, QueryFrontend, ServeConfig,
                               ServeResponse, SnapshotStore)

__all__ = ["StreamSession"]


class StreamSession:
    """A live streaming recommender: states + serving plane.

    Construction allocates zero states for ``cfg.grid`` on ``cfg.device``.
    The session is single-writer: ``ingest`` mutates it, ``recommend``
    reads the last published snapshot (so it can run from other threads
    while ``ingest`` runs, the same contract as ``SnapshotStore``; on a
    process grid, from one reader thread a rank, in the same order on
    every rank).
    """

    def __init__(self, cfg: StreamConfig, *, serve: ServeConfig | None = None,
                 publish: PublishPolicy | None = None,
                 snapshot_slots: int = 2,
                 metrics: metrics_lib.MetricsRegistry | None = None):
        self.cfg = cfg
        self.algorithm = algorithm_lib.get_algorithm(cfg.algorithm)
        # The process grid this rank is part of (backend="shard_map").
        self._mesh = _grid_mesh(cfg)
        # One registry spans the session: loop telemetry, snapshot store,
        # query front-end and stage spans all land here.
        self.metrics = (metrics if metrics is not None
                        else metrics_lib.MetricsRegistry())
        self.store = SnapshotStore(slots=snapshot_slots,
                                   registry=self.metrics, mesh=self._mesh)
        # Publish boundaries carry the loop's telemetry vector; the store
        # hands it to this folder (on the publisher thread when async).
        self._telemetry = telemetry_lib.TelemetryFolder(self.metrics)
        self.store.set_telemetry_sink(self._telemetry.fold)
        # One policy governs both halves: the session's ingest cadence
        # and the front-end's staleness bound. An explicit ``publish``
        # wins; otherwise adopt the ServeConfig's (or the default).
        if serve is None:
            serve = ServeConfig.from_stream(cfg)
        if publish is None:
            publish = serve.publish
        else:
            serve = dataclasses.replace(serve, publish=publish)
        self.publish_policy = publish
        if self._mesh is not None:
            # A serve call that finds no snapshot on any rank publishes
            # the live (zero) states itself, on the reader's thread.
            self.store.cold_publish = lambda: self._publish("serve")
            self.store.device = cfg.device
        # One serve call at a time on a grid: a rank never has two
        # serve-group collectives in flight.
        self._serve_lock = threading.Lock()
        # The thread that runs ``ingest`` (the constructor's until the
        # first): its ``recommend`` calls between ingests run in program
        # order, the same on every rank, and need no agreement.
        self._owner = threading.current_thread()
        self._frontend = QueryFrontend(self.store, serve)
        self._states = (pipeline_lib.init_states(cfg) if self._mesh is None
                        else distributed.init_grid_states(cfg, self._mesh))
        self._carry: tuple = (None, None)
        self._detector = None
        self.events_processed = 0
        self.forgets = 0
        hyper = cfg.resolved_hyper()
        self._telemetry.set_capacity(hyper.u_cap + hyper.i_cap)
        self._table_bytes = self.metrics.gauge(
            "table_bytes", "Exact resident bytes of a live state table",
            labels=("algorithm", "table", "dtype"))
        self._update_table_bytes()

    def _update_table_bytes(self) -> None:
        # Tensor metadata only (shape x itemsize) — no device sync.
        for table, (dtype, nbytes) in storage_lib.state_nbytes(
                self._states).items():
            self._table_bytes.labels(
                algorithm=self.cfg.algorithm, table=table,
                dtype=dtype).set(nbytes)

    # -- introspection ----------------------------------------------------

    @property
    def states(self):
        """Current stacked ``[n_c, ...]`` worker states (live: the next
        ``ingest`` updates them in place); on a process grid, this rank's
        own worker, ``[1, ...]`` (``[0, ...]`` past the grid)."""
        return self._states

    @property
    def grid(self) -> GridSpec:
        return self.cfg.grid

    @property
    def frontend(self) -> QueryFrontend:
        """The session's query front-end (read path; shares the store)."""
        return self._frontend

    # -- train ------------------------------------------------------------

    def ingest(self, users, items, *, verbose: bool = False) -> StreamResult:
        """Stream a batch of ``<user, item>`` events through the engine.

        Incremental: each call continues from the states and the drift
        detector's baseline the previous call left behind. With
        ``policy.every = k > 0`` the engine publishes a copy of the
        states into this session's store every ``k`` micro-batches,
        asynchronously when ``policy.mode == "async"``. The final state
        is always published (synchronously, so ``recommend`` right after
        ``ingest`` sees it), then the call's telemetry vector is folded
        into the registry. ``verbose`` prints the loop's progress lines
        (``run_stream(verbose=True)``). Returns the call's
        ``StreamResult``.
        """
        policy = self.publish_policy
        hook = None
        if policy.every > 0:
            base = self.events_processed
            base_forgets = self.forgets
            publish = (self.store.publish_async if policy.is_async
                       else self.store.publish)

            def hook(ev):
                publish(ev.states, base + ev.events_processed,
                        base_forgets + ev.forgets, telemetry=ev.telemetry)

        # The telemetry vector restarts from zero at each run_stream call;
        # the previous call's folds are complete (_publish flushed).
        self._telemetry.rebase()
        self._owner = threading.current_thread()
        self.store.begin_training()
        try:
            with trace_lib.span("ingest", self.metrics), _on_device(
                    self.cfg.device):
                res = run_stream(
                    np.asarray(users), np.asarray(items), self.cfg,
                    verbose=verbose, publish_every=policy.every,
                    on_publish=hook, publish_sync=not policy.is_async,
                    initial_states=self._states, initial_carry=self._carry,
                    initial_detector=self._detector)
            self._states = res.final_states
            # run_stream drains the re-queue before it returns (flushed,
            # or counted in res.dropped): the carry is consumed.
            self._carry = (None, None)
            if res.final_detector is not None:
                self._detector = res.final_detector
            self.events_processed += res.events_processed
            self.forgets += res.forgets
            self._publish()
        finally:
            self.store.end_training()
        # Final fold: the end-of-run vector covers any tail past the last
        # boundary; after _publish's flush no async fold is in flight.
        self._telemetry.fold(res.telemetry)
        return res

    def _publish(self, group: str = "train") -> None:
        # Drain in-flight async rotations first: a mid-stream snapshot
        # rotating after this final one would move the front back to an
        # older stream position. The live states change at the next
        # ingest, so the snapshot is a copy. ``group``: the grid's group
        # the popularity gather runs on (the calling thread's).
        with trace_lib.span("publish", self.metrics):
            self.store.flush()
            self.store.publish(state_lib.clone_state(self._states),
                               self.events_processed, self.forgets,
                               group=group)
            self._update_table_bytes()

    # -- serve ------------------------------------------------------------

    def recommend(self, user_ids, n: int | None = None) -> ServeResponse:
        """Grid-wide top-N for a batch of users, from the last snapshot.

        Runs the full serving plane: column fan-out + cross-split merge
        (``grid_topn``), LRU response cache, and the popularity fallback
        for unknown users. ``n`` overrides the list length (a fresh
        front-end on the same store); default is the serving config's
        ``top_n``. On a process grid every rank calls it with the same
        arguments, in the same order (one reader thread a rank); the
        calls are serialized. A call on the thread that runs ``ingest``,
        while no trainer runs on the rank, serves the front as it is
        (every rank's is the same after the async backlog drains);
        any other begins with the ranks' agreement
        (``SnapshotStore.agree``), which also publishes a cold session's
        zero state.
        """
        if self._mesh is None:
            if self.store.latest_version == 0:
                self._publish()     # cold session: serve the zero state
            return self._serve(user_ids, n)
        with self._serve_lock, _on_device(self.cfg.device):
            if (threading.current_thread() is not self._owner
                    or self.store.training):
                return self._serve(user_ids, n)
            self.store.flush()
            if self.store.latest_version == 0:
                self._publish()
            return self._serve(user_ids, n, agree=False)

    def _serve(self, user_ids, n, agree: bool = True):
        if n is not None and n != self._frontend.cfg.top_n:
            # The fresh frontend shares the store's registry (idempotent
            # get-or-create), so the serve counters keep accumulating.
            self._frontend = QueryFrontend(
                self.store, dataclasses.replace(self._frontend.cfg, top_n=n))
        with trace_lib.span("serve", self.metrics):
            return self._frontend.serve(user_ids, agree)

    # -- checkpoint / restore -----------------------------------------------

    def checkpoint(self, directory: str) -> str:
        """Write a grid-portable checkpoint (detector state included) of
        the live states in their resident encoding; returns its path. On a
        process grid rank 0 writes the grid's file and every rank waits
        for it at a barrier. The async backlog is drained first."""
        self.store.flush()
        path = save_stream_checkpoint(
            directory, self.events_processed, self._states,
            carry=self._carry, grid=self.cfg.grid,
            algorithm=self.cfg.algorithm, detector=self._detector,
            storage=self.cfg.storage, mesh=self._mesh)
        _barrier(self._mesh)
        return path

    @classmethod
    def restore(cls, directory: str, cfg: StreamConfig,
                step: int | None = None, *,
                serve: ServeConfig | None = None,
                publish: PublishPolicy | None = None,
                snapshot_slots: int = 2,
                metrics: metrics_lib.MetricsRegistry | None = None,
                ) -> "StreamSession":
        """Resume a session from ``checkpoint`` output (either package's),
        at ``cfg.grid``: a grid-portable checkpoint regrids to the
        configured shape on the way, so restoring at another ``(n_i, g)``
        is the scale-out path (see :meth:`rescale` for live states). On a
        process grid every rank reads the file and builds its own worker
        at ``cfg.grid`` (any grid that fits the group)."""
        session = cls(cfg, serve=serve, publish=publish,
                      snapshot_slots=snapshot_slots, metrics=metrics)
        ck: RestoredCheckpoint = restore_stream_checkpoint(
            directory, cfg, step, mesh=session._mesh)
        session._states = ck.states
        session._carry = ck.carry
        session._detector = ck.detector
        session.events_processed = int(ck.events_processed)
        session._publish()
        return session

    # -- elasticity -------------------------------------------------------

    def rescale(self, grid: GridSpec, *, u_cap: int | None = None,
                i_cap: int | None = None, merge: str = "fresh",
                storage=None) -> None:
        """Reshape the live worker grid to ``grid`` (elastic S&R).

        Runs the algorithm's regrid hooks (logical extract + rebuild)
        inside the ``regrid`` span, swaps the session config to the new
        shape (optionally with new per-worker capacities), refreshes the
        ``table_bytes`` gauges, publishes the resharded snapshot and
        retargets the query front-end: queries right after this call
        answer from the new grid. ``storage`` migrates the resident
        encoding in the same pass (a new ``StoragePolicy``; default: keep
        the current one).

        On a process grid ``grid`` may have any ``n_c`` up to the group's
        size: each rank extracts its worker's logical state, the ranks
        exchange their live records and entries
        (``core.distributed.exchange_logical``), and each rank builds its
        own destination worker only. The async backlog is drained first.
        Run it between ``ingest`` calls, with no ``recommend`` in flight
        (the front-end is retargeted after the new snapshot rotates).
        """
        self.store.flush()
        hyper = self.cfg.resolved_hyper()
        new_u = u_cap if u_cap is not None else hyper.u_cap
        new_i = i_cap if i_cap is not None else hyper.i_cap
        new_storage = storage if storage is not None else self.cfg.storage
        with trace_lib.span("regrid", self.metrics):
            mesh, relations = None, None
            if self._mesh is None:
                logical = self.algorithm.extract_logical(
                    self._states, self.cfg.grid, storage=self.cfg.storage)
            else:
                mesh = make_grid_mesh(grid)
                logical, relations = distributed.exchange_logical(
                    self._mesh, self._states, self.cfg.grid,
                    self.cfg.algorithm, self.cfg.storage)
            self._states = self.algorithm.build_states(
                logical, src=self.cfg.grid, dst=grid,
                u_cap=new_u, i_cap=new_i, merge=merge, storage=new_storage,
                workers=None if mesh is None else distributed.rank_workers(
                    mesh), relations=relations)
            del logical, relations
            self.cfg = dataclasses.replace(
                self.cfg, grid=grid, storage=new_storage,
                hyper=hyper._replace(u_cap=new_u, i_cap=new_i))
            self._mesh = self.store.mesh = mesh
            self._telemetry.set_capacity(new_u + new_i)
            self._publish()
            self._frontend.retarget(grid, u_cap=u_cap, storage=new_storage)


def _grid_mesh(cfg):
    """The process grid of a ``shard_map`` config, else None."""
    if pipeline_lib._resolve_backend(cfg) != "shard_map":
        return None
    return make_grid_mesh(cfg.grid)


def _on_device(device):
    """The device's context for a thread that may not have it current (a
    reader or trainer thread on a rank's card), else nothing."""
    import contextlib

    import torch

    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _barrier(mesh) -> None:
    if mesh is not None and mesh.group is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)
