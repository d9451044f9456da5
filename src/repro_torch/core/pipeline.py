"""End-to-end S&R streaming pipeline (paper Figure 1/2).

Port of ``repro/core/pipeline.py``: ``StreamConfig`` (:49) with the same
fields and ``bucket_capacity`` plus a ``device``, ``StreamResult`` (:88),
``init_states`` (:178) and ``run_stream`` (:188) for a registered
algorithm (``"disgd"``, ``"dics"`` or ``"bpr"``, ``core/algorithm.py``),
on one of three backends:

  * ``backend="cuda"`` (alias ``"pallas"``, the JAX package's name) —
    the device loop of ``core/engine.py`` with the kernel worker
    (``disgd.make_cuda_worker``, ``dics.make_cuda_worker``,
    ``algos/bpr.make_cuda_worker``);
  * ``backend="scan"`` — the same device loop with the eager reference
    worker (``disgd_worker_step``, ``dics_worker_step``,
    ``bpr_worker_step``);
  * ``backend="host"`` — the reference loop of ``pipeline.py:188-475``
    (``_run_host``): numpy bucketing (``routing.bucket_dispatch_np``), an
    unbounded host re-queue drained at the end of the stream, and the
    eager reference worker on ``cfg.device``, one micro-batch at a time
    with a host round trip each.

``run_stream``'s publish hooks (``publish_every``, ``on_publish``,
``publish_sync``) hand a copy of the states to the serving plane's
snapshot store at micro-batch boundaries (``engine.PublishEvent``).

Every backend runs forgetting (``StreamConfig.forgetting``, a
``core.forgetting.ForgettingConfig``; ``None`` means none), the
closed-loop drift policy (``StreamConfig.drift``, a
``drift.DriftPolicy``) and the telemetry vector (``StreamConfig.
telemetry``, on by default as in JAX: ``StreamResult.telemetry`` and
``StreamResult.precision``). What later slices of the port bring raises
``ValueError`` naming the slice: the ``shard_map`` backend and storage
policies.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import forgetting as forgetting_lib
from repro_torch.core import routing
from repro_torch.core.evaluator import RecallAccumulator

__all__ = ["StreamConfig", "StreamResult", "init_states", "run_stream"]

_BACKENDS = {"cuda": "cuda", "pallas": "cuda", "scan": "scan",
             "host": "host"}
_LATER = {"shard_map": "the multi-GPU slice (ROADMAP Queue 1 item 14)"}


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    # Registry key into repro_torch.core.algorithm.
    algorithm: str = "disgd"
    grid: routing.GridSpec = routing.GridSpec(1, 0)
    micro_batch: int = 2048
    capacity_factor: float = 2.0             # bucket capacity vs fair share
    forgetting: Any = forgetting_lib.ForgettingConfig()  # None = "none"
    hyper: Any = None                        # DisgdHyper / DicsHyper / BprHyper
    seed: int = 0
    record_every: int = 4                    # occupancy snapshot cadence
    backend: str = "cuda"                    # "cuda" (= "pallas") | "scan" | "host"
    carry_slots: int = 0                     # overflow re-queue size (0 = micro_batch)
    # Opt-in closed-loop drift policy (repro_torch.drift.DriftPolicy).
    # With mode "adaptive" the detector and controller replace the
    # fixed ``forgetting.trigger_every`` cadence entirely.
    drift: Any = None
    # The loop's telemetry vector (repro_torch.obs.telemetry).
    telemetry: bool = True
    storage: Any = None                      # not in this slice
    device: str = "cuda"

    def resolved_hyper(self):
        h = self.hyper
        if h is None:
            h = algorithm_lib.get_algorithm(self.algorithm).default_hyper()
        return h._replace(n_i=self.grid.n_i, g=self.grid.g)

    @property
    def bucket_capacity(self) -> int:
        fair = self.micro_batch / self.grid.n_c
        return max(8, int(np.ceil(fair * self.capacity_factor)))


@dataclasses.dataclass
class StreamResult:
    """What one ``run_stream`` call measured and produced."""

    recall: RecallAccumulator
    user_occupancy: list      # [(events_processed, np[n_c])]
    item_occupancy: list
    events_processed: int
    dropped: int
    wall_seconds: float
    load_history: list        # per-batch worker loads (skew diagnostics)
    # Final worker states [n_c, ...] on cfg.device: the input to the
    # serving plane (repro_torch.serve.plane.grid_topn).
    final_states: Any = None
    # Forgetting passes fired (fixed cadence or adaptive controller).
    forgets: int = 0
    # Per-step detector flags (int32, one per active step) under the
    # adaptive drift policy, else None.
    drift_flags: Any = None
    # Final DetectorState (numpy) under the adaptive policy: pass it as
    # ``run_stream(initial_detector=...)`` to continue the stream.
    final_detector: Any = None
    # End-of-run TelemetryState (numpy; None with cfg.telemetry off),
    # cumulative over this call only.
    telemetry: Any = None

    @property
    def throughput(self) -> float:
        return self.events_processed / max(self.wall_seconds, 1e-9)

    @property
    def precision(self) -> float:
        """Micro-averaged prequential precision@N of this call: hits over
        the summed effective list length (``min(top_n, live unrated
        candidates)`` per evaluated event), both from the telemetry
        vector; NaN with telemetry off or nothing evaluated. JAX's
        ``StreamResult.precision_at_n``."""
        if self.telemetry is None:
            return float("nan")
        denom = int(self.telemetry.list_len)
        return int(self.telemetry.hits) / denom if denom else float("nan")

    precision_at_n = precision

    def occupancy_summary(self):
        """Mean per-worker live entries at end of stream (paper's metric)."""
        u = self.user_occupancy[-1][1] if self.user_occupancy else np.zeros(1)
        i = self.item_occupancy[-1][1] if self.item_occupancy else np.zeros(1)
        return {
            "user_mean": float(np.mean(u)), "user_max": int(np.max(u)),
            "item_mean": float(np.mean(i)), "item_max": int(np.max(i)),
            "user_total": int(np.sum(u)), "item_total": int(np.sum(i)),
        }


def init_states(cfg: StreamConfig):
    """Zero states of every worker, stacked ``[n_c, ...]`` on cfg.device."""
    return algorithm_lib.get_algorithm(cfg.algorithm).init_state(
        cfg.resolved_hyper(), batch=(cfg.grid.n_c,), device=cfg.device)


def _resolve_backend(cfg: StreamConfig) -> str:
    if cfg.backend in _LATER:
        raise ValueError(f"backend={cfg.backend!r} is not ported yet; it "
                         f"comes with {_LATER[cfg.backend]}")
    if cfg.backend not in _BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; ported: "
                         f"{sorted(_BACKENDS)}")
    if cfg.storage is not None:
        raise ValueError("storage policies are not ported yet; they come "
                         "with the storage slice (ROADMAP Queue 1 item 11)")
    return _BACKENDS[cfg.backend]


def run_stream(users: np.ndarray, items: np.ndarray, cfg: StreamConfig,
               publish_every: int = 0, on_publish=None,
               publish_sync: bool = True, initial_states=None,
               initial_carry=(None, None),
               initial_detector=None) -> StreamResult:
    """Run the full prequential stream; returns curves + paper metrics.

    ``publish_every``/``on_publish`` expose state snapshots at
    micro-batch boundaries for the serving plane
    (``repro_torch.serve.snapshot``): every ``publish_every`` steps,
    ``on_publish(PublishEvent)`` fires with a copy of the worker states
    at that boundary. ``publish_sync=False`` makes the device loop's
    boundary non-blocking (0-d tensors for the progress scalars — see
    ``engine.run_stream_device``); the host reference loop is synchronous
    by construction and ignores it.

    ``initial_states``/``initial_carry`` resume mid-stream (for example
    from ``core.convert.states_from_numpy``); the states must be shaped
    for ``cfg.grid`` and are updated in place. ``initial_detector``
    resumes the adaptive drift detector (a ``StreamResult.
    final_detector``, this package's or JAX's).
    """
    from repro_torch.core import engine

    backend = _resolve_backend(cfg)
    users, items = np.asarray(users), np.asarray(items)
    if backend == "host":
        return _run_host(users, items, cfg, publish_every, on_publish,
                         initial_states, initial_carry, initial_detector)
    return engine.run_stream_device(
        users, items, cfg, backend, publish_every=publish_every,
        on_publish=on_publish, publish_sync=publish_sync,
        initial_states=initial_states, initial_carry=initial_carry,
        initial_detector=initial_detector)


def _run_host(users: np.ndarray, items: np.ndarray, cfg: StreamConfig,
              publish_every: int, on_publish, initial_states, initial_carry,
              initial_detector) -> StreamResult:
    """The host reference loop (``repro/core/pipeline.py:260-475``): per
    micro-batch, bucket the carried and fresh events on the host, run the
    eager reference worker on ``cfg.device``, scatter the recall bits
    back to stream order and re-queue the overflow, unbounded. Then, as
    JAX: the drift detector and controller (adaptive policy), or a
    forgetting pass once ``trigger_every`` events have been processed
    since the last (the remainder carried); and the telemetry fold with
    ``HOST_CARRY_CAP``. After the stream, empty batches drain the
    re-queue, up to ``n_batches + ceil(carry / capacity) + 1`` batches in
    all; what is left then is dropped. Every ``publish_every`` batches,
    and once more after the last batch when it was not a boundary (the
    tail publish), ``on_publish`` gets a copy of the states with int
    progress scalars."""
    from repro_torch.core import engine, state as state_lib
    from repro_torch.drift import controller as controller_lib
    from repro_torch.drift import detector as detector_lib
    from repro_torch.obs import telemetry as telemetry_lib

    if users.shape != items.shape:
        raise ValueError(f"users {users.shape} and items {items.shape} differ")
    n = users.shape[0]
    grid = cfg.grid
    cap = cfg.bucket_capacity
    device = torch.device(cfg.device)
    worker = engine.make_worker_fn(cfg, "scan")
    states = initial_states if initial_states is not None else init_states(cfg)

    # The closed-loop drift policy replaces the fixed cadence.
    adaptive = engine._adaptive(cfg)
    forgetting = engine._fixed_forgetting(cfg)
    forget = forgetting is not None
    det = controller = boost = None
    if adaptive:
        controller = controller_lib.make_controller(cfg.drift)
        det = (detector_lib.detector_from(initial_detector, device)
               if initial_detector is not None
               else detector_lib.detector_init(device))
        boost = controller_lib.controller_init(device)
    # Telemetry, host edition: the device loop's fold, once a batch; the
    # host re-queue is unbounded, hence HOST_CARRY_CAP.
    tel = (telemetry_lib.telemetry_init(grid.n_c, device) if cfg.telemetry
           else None)
    top_n = cfg.resolved_hyper().top_n

    acc = RecallAccumulator()
    user_occ, item_occ, loads, drift_flags = [], [], [], []
    dropped = processed = forgets = since = 0
    carry_u, carry_i = (np.asarray(c, np.int64) if c is not None
                        else np.empty(0, np.int64) for c in initial_carry)

    def occupancy():
        u_occ, i_occ = state_lib.occupancy(states.tables)
        return u_occ.cpu().numpy(), i_occ.cpu().numpy()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def publish(segment, steps_done):
        # The copy is the trainer's work; only the subscriber's time is
        # left out of the wall clock, as in the device loop.
        ev = engine.PublishEvent(state_lib.clone_state(states), processed,
                                 dropped, forgets, segment, steps_done,
                                 detector=det, telemetry=tel)
        sync()
        tp = time.perf_counter()
        on_publish(ev)
        return time.perf_counter() - tp

    # Warm the step before the clock starts, as JAX compiles it there: a
    # bucket of padding changes no state.
    dummy = torch.full((grid.n_c, cap), -1, dtype=torch.int32, device=device)
    worker(states, dummy, dummy)
    occupancy()
    sync()

    t0 = time.perf_counter()
    publish_time = 0.0
    published_steps = 0
    n_batches = int(np.ceil(n / cfg.micro_batch))
    empty = np.empty(0, dtype=np.int64)
    b = 0
    max_drain = None
    while True:
        if b < n_batches:
            lo, hi = b * cfg.micro_batch, min((b + 1) * cfg.micro_batch, n)
            fresh_u, fresh_i = users[lo:hi], items[lo:hi]
        elif carry_u.size == 0:
            break
        else:
            if max_drain is None:
                max_drain = n_batches + int(np.ceil(carry_u.size / cap)) + 1
            if b >= max_drain:
                dropped += carry_u.size
                break
            fresh_u, fresh_i = empty, empty
        bu = np.concatenate([carry_u, fresh_u])
        bi = np.concatenate([carry_i, fresh_i])
        keys = (bi % grid.n_i) * grid.g + (bu % grid.g)
        buckets, kept, load = routing.bucket_dispatch_np(
            keys.astype(np.int64), grid.n_c, cap)
        # Overflow events re-queue into the next micro-batch (not lost).
        carry_u, carry_i = bu[~kept], bi[~kept]

        src = np.clip(buckets, 0, None)
        ev_u = torch.as_tensor(np.where(buckets >= 0, bu[src], -1),
                               dtype=torch.int32, device=device)
        ev_i = torch.as_tensor(np.where(buckets >= 0, bi[src], -1),
                               dtype=torch.int32, device=device)
        # Precision@N denominator from the bucket-start states.
        lens = (telemetry_lib.effective_list_len(states, ev_u, top_n=top_n,
                                                 g=grid.g)
                if tel is not None else 0)
        states, hits, evaluated = worker(states, ev_u, ev_i)

        acc.add_batch(buckets, hits.cpu().numpy(), evaluated.cpu().numpy(),
                      bu.shape[0])
        kept_n = int(kept.sum())
        processed += kept_n
        since += kept_n
        loads.append(load)
        evicted = 0
        occ_before = (engine._occ_total(*state_lib.occupancy(states.tables))
                      if tel is not None and (adaptive or forget) else None)
        if adaptive:
            det = detector_lib.detector_update(det, hits, evaluated,
                                               cfg.drift.detector)
            states, boost = controller(states, det.fired, boost)
            fired = bool(det.fired)
            drift_flags.append(fired)
            forgets += int(fired)
        elif forget and since >= forgetting.trigger_every:
            forgetting_lib.apply_forgetting(states, forgetting)
            # Carry the remainder, as the device loop does.
            since -= forgetting.trigger_every
            forgets += 1
        if tel is not None:
            u_o, i_o = state_lib.occupancy(states.tables)
            if occ_before is not None:
                evicted = max(int(occ_before)
                              - int(engine._occ_total(u_o, i_o)), 0)
            tel = telemetry_lib.telemetry_batch_update(
                tel, kept=kept_n, overflow=int(carry_u.size),
                carry_cap=telemetry_lib.HOST_CARRY_CAP, evicted=evicted,
                hits=hits, evaluated=evaluated, load=load,
                occupancy=u_o + i_o, list_len=lens)
        if (publish_every and on_publish is not None
                and (b + 1) % publish_every == 0):
            publish_time += publish((b + 1) // publish_every - 1, b + 1)
            published_steps = b + 1
        if b % cfg.record_every == 0:
            u_occ, i_occ = occupancy()
            user_occ.append((processed, u_occ))
            item_occ.append((processed, i_occ))
        b += 1

    # Final occupancy snapshot, unless the last batch recorded this point.
    if n_batches and (not user_occ or user_occ[-1][0] != processed):
        u_occ, i_occ = occupancy()
        user_occ.append((processed, u_occ))
        item_occ.append((processed, i_occ))
    # Tail publish, as the device loop publishes after its last segment.
    if (publish_every and on_publish is not None and n_batches
            and published_steps != b):
        publish_time += publish(published_steps // publish_every, b)
    sync()
    return StreamResult(
        recall=acc,
        user_occupancy=user_occ,
        item_occupancy=item_occ,
        events_processed=processed,
        dropped=dropped,
        wall_seconds=time.perf_counter() - t0 - publish_time,
        load_history=loads,
        final_states=states,
        forgets=forgets,
        drift_flags=np.asarray(drift_flags, np.int32) if adaptive else None,
        final_detector=engine._to_numpy(det) if adaptive else None,
        telemetry=engine._to_numpy(tel) if tel is not None else None,
    )
