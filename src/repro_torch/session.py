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
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import state as state_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core.pipeline import (RestoredCheckpoint, StreamConfig,
                                       StreamResult,
                                       restore_stream_checkpoint, run_stream,
                                       save_stream_checkpoint)
from repro_torch.core.routing import GridSpec
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
    while ``ingest`` runs, the same contract as ``SnapshotStore``).
    """

    def __init__(self, cfg: StreamConfig, *, serve: ServeConfig | None = None,
                 publish: PublishPolicy | None = None,
                 snapshot_slots: int = 2,
                 metrics: metrics_lib.MetricsRegistry | None = None):
        self.cfg = cfg
        self.algorithm = algorithm_lib.get_algorithm(cfg.algorithm)
        # One registry spans the session: loop telemetry, snapshot store,
        # query front-end and stage spans all land here.
        self.metrics = (metrics if metrics is not None
                        else metrics_lib.MetricsRegistry())
        self.store = SnapshotStore(slots=snapshot_slots,
                                   registry=self.metrics)
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
        self._frontend = QueryFrontend(self.store, serve)
        self._states = pipeline_lib.init_states(cfg)
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
        ``ingest`` updates them in place)."""
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
        with trace_lib.span("ingest", self.metrics):
            res = run_stream(
                np.asarray(users), np.asarray(items), self.cfg,
                verbose=verbose, publish_every=policy.every, on_publish=hook,
                publish_sync=not policy.is_async,
                initial_states=self._states, initial_carry=self._carry,
                initial_detector=self._detector)
        self._states = res.final_states
        # run_stream drains the re-queue before it returns (flushed, or
        # counted in res.dropped): the carry is consumed.
        self._carry = (None, None)
        if res.final_detector is not None:
            self._detector = res.final_detector
        self.events_processed += res.events_processed
        self.forgets += res.forgets
        self._publish()
        # Final fold: the end-of-run vector covers any tail past the last
        # boundary; after _publish's flush no async fold is in flight.
        self._telemetry.fold(res.telemetry)
        return res

    def _publish(self) -> None:
        # Drain in-flight async rotations first: a mid-stream snapshot
        # rotating after this final one would move the front back to an
        # older stream position. The live states change at the next
        # ingest, so the snapshot is a copy.
        with trace_lib.span("publish", self.metrics):
            self.store.flush()
            self.store.publish(state_lib.clone_state(self._states),
                               self.events_processed, self.forgets)
            self._update_table_bytes()

    # -- serve ------------------------------------------------------------

    def recommend(self, user_ids, n: int | None = None) -> ServeResponse:
        """Grid-wide top-N for a batch of users, from the last snapshot.

        Runs the full serving plane: column fan-out + cross-split merge
        (``grid_topn``), LRU response cache, and the popularity fallback
        for unknown users. ``n`` overrides the list length (a fresh
        front-end on the same store); default is the serving config's
        ``top_n``.
        """
        if self.store.latest_version == 0:
            self._publish()     # cold session: serve the zero state
        if n is not None and n != self._frontend.cfg.top_n:
            # The fresh frontend shares the store's registry (idempotent
            # get-or-create), so the serve counters keep accumulating.
            self._frontend = QueryFrontend(
                self.store, dataclasses.replace(self._frontend.cfg, top_n=n))
        with trace_lib.span("serve", self.metrics):
            return self._frontend.serve(user_ids)

    # -- checkpoint / restore -----------------------------------------------

    def checkpoint(self, directory: str) -> str:
        """Write a grid-portable checkpoint (detector state included) of
        the live states in their resident encoding; returns its path."""
        return save_stream_checkpoint(
            directory, self.events_processed, self._states,
            carry=self._carry, grid=self.cfg.grid,
            algorithm=self.cfg.algorithm, detector=self._detector,
            storage=self.cfg.storage)

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
        is the scale-out path (see :meth:`rescale` for live states)."""
        ck: RestoredCheckpoint = restore_stream_checkpoint(directory, cfg,
                                                           step)
        session = cls(cfg, serve=serve, publish=publish,
                      snapshot_slots=snapshot_slots, metrics=metrics)
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
        """
        hyper = self.cfg.resolved_hyper()
        new_u = u_cap if u_cap is not None else hyper.u_cap
        new_i = i_cap if i_cap is not None else hyper.i_cap
        new_storage = storage if storage is not None else self.cfg.storage
        with trace_lib.span("regrid", self.metrics):
            logical = self.algorithm.extract_logical(
                self._states, self.cfg.grid, storage=self.cfg.storage)
            self._states = self.algorithm.build_states(
                logical, src=self.cfg.grid, dst=grid,
                u_cap=new_u, i_cap=new_i, merge=merge, storage=new_storage)
            del logical
            self.cfg = dataclasses.replace(
                self.cfg, grid=grid, storage=new_storage,
                hyper=hyper._replace(u_cap=new_u, i_cap=new_i))
            self._telemetry.set_capacity(new_u + new_i)
            self._publish()
            self._frontend.retarget(grid, u_cap=u_cap, storage=new_storage)
