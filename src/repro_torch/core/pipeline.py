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
``drift.DriftPolicy``), the telemetry vector (``StreamConfig.
telemetry``, on by default as in JAX: ``StreamResult.telemetry`` and
``StreamResult.precision``) and storage policies (``StreamConfig.
storage``, a ``core.storage.StoragePolicy``: the states stay resident in
the policy's encoding and every step decodes, computes and encodes, as
in JAX). The ``shard_map`` backend comes with a later slice and raises
``ValueError`` naming it.

Checkpoints (``repro/core/pipeline.py:477-665``):
``save_stream_checkpoint`` writes the msgpack files of
``repro.checkpoint`` (``repro_torch.checkpoint``, the same bytes), in
the grid-portable ``sr-logical-v1`` format (``grid=``) or the legacy
fixed-shape one; ``restore_stream_checkpoint`` reads either package's
files at the configured grid (regridding a logical one on the way,
``core.regrid``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import forgetting as forgetting_lib
from repro_torch.core import routing, state as state_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core.evaluator import RecallAccumulator
from repro_torch.core.regrid import CheckpointShapeError
from repro_torch.core.storage import StoragePolicy, StoragePolicyError

__all__ = ["StreamConfig", "StreamResult", "RestoredCheckpoint",
           "init_states", "run_stream", "save_stream_checkpoint",
           "restore_stream_checkpoint", "CheckpointShapeError",
           "StoragePolicyError", "LOGICAL_FORMAT"]

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
    # Per-table resident encoding of worker state (core.storage): every
    # layer that touches state decodes -> computes in f32/bool ->
    # encodes. The default runs no codec at all.
    storage: StoragePolicy = StoragePolicy()
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
    """Zero states of every worker, stacked ``[n_c, ...]`` on cfg.device,
    in ``cfg.storage``'s resident encoding: one worker's state is encoded
    once, before the broadcast over the workers, as in JAX."""
    algo = algorithm_lib.get_algorithm(cfg.algorithm)
    n_c = cfg.grid.n_c
    if cfg.storage.is_default:
        return algo.init_state(cfg.resolved_hyper(), batch=(n_c,),
                               device=cfg.device)
    one = algo.init_state(cfg.resolved_hyper(), device=cfg.device,
                          storage=cfg.storage)

    def bcast(x):
        if x is None:
            return None
        s = state_lib.signed(x)
        return s.expand((n_c,) + s.shape).contiguous().view(x.dtype)

    return type(one)(type(one.tables)(*(bcast(t) for t in one.tables)),
                     *(bcast(t) for t in one[1:]))


def _resolve_backend(cfg: StreamConfig) -> str:
    if cfg.backend in _LATER:
        raise ValueError(f"backend={cfg.backend!r} is not ported yet; it "
                         f"comes with {_LATER[cfg.backend]}")
    if cfg.backend not in _BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; ported: "
                         f"{sorted(_BACKENDS)}")
    return _BACKENDS[cfg.backend]


def run_stream(users: np.ndarray, items: np.ndarray, cfg: StreamConfig,
               verbose: bool = False, publish_every: int = 0,
               on_publish=None, publish_sync: bool = True,
               initial_states=None, initial_carry=(None, None),
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
    final_detector``, this package's or JAX's). ``verbose`` prints a
    progress line every 16 micro-batches, as JAX's loops do.
    """
    from repro_torch.core import engine

    backend = _resolve_backend(cfg)
    users, items = np.asarray(users), np.asarray(items)
    if backend == "host":
        return _run_host(users, items, cfg, publish_every, on_publish,
                         initial_states, initial_carry, initial_detector,
                         verbose)
    return engine.run_stream_device(
        users, items, cfg, backend, verbose=verbose,
        publish_every=publish_every,
        on_publish=on_publish, publish_sync=publish_sync,
        initial_states=initial_states, initial_carry=initial_carry,
        initial_detector=initial_detector)


def _run_host(users: np.ndarray, items: np.ndarray, cfg: StreamConfig,
              publish_every: int, on_publish, initial_states, initial_carry,
              initial_detector, verbose: bool = False) -> StreamResult:
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
    progress scalars. Under a storage policy the states stay encoded
    between the steps: the worker, the forgetting pass and the
    controller each decode, compute and encode (JAX's boundaries, at
    ``repro/core/pipeline.py:240``), and the telemetry gather unpacks
    only the rows it reads."""
    from repro_torch.core import engine
    from repro_torch.drift import controller as controller_lib
    from repro_torch.drift import detector as detector_lib
    from repro_torch.obs import telemetry as telemetry_lib

    if users.shape != items.shape:
        raise ValueError(f"users {users.shape} and items {items.shape} differ")
    n = users.shape[0]
    grid = cfg.grid
    cap = cfg.bucket_capacity
    device = torch.device(cfg.device)
    policy = cfg.storage
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
                                                 g=grid.g, storage=policy)
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
            _, boost = storage_lib.in_compute_form(
                states, policy, lambda s: controller(s, det.fired, boost))
            fired = bool(det.fired)
            drift_flags.append(fired)
            forgets += int(fired)
        elif forget and since >= forgetting.trigger_every:
            storage_lib.in_compute_form(
                states, policy,
                lambda s: forgetting_lib.apply_forgetting(s, forgetting))
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
        if verbose and b % 16 == 0:
            print(f"[stream] batch {b}/{n_batches} recall so far: "
                  f"{acc.mean():.4f}")
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


# ---------------------------------------------------------------------------
# Fault tolerance: checkpoint / resume of the streaming state
# ---------------------------------------------------------------------------

# Version tag of the grid-portable checkpoint payload (JAX's): v1 is
# LogicalState records + (algorithm, grid shape, carry). Legacy
# fixed-shape checkpoints have no "format" key and restore only at their
# own grid.
LOGICAL_FORMAT = "sr-logical-v1"


def _host_tuple(tup):
    """A tuple of tensors (a DetectorState) as the same tuple of numpy."""
    return type(tup)(*(x.detach().cpu().numpy() if torch.is_tensor(x)
                       else np.asarray(x) for x in tup))


def save_stream_checkpoint(directory: str, events_processed: int, states,
                           carry=(None, None), grid=None, algorithm=None,
                           detector=None, storage: StoragePolicy = None):
    """Persist worker states (+ the re-queue carry) mid-stream, in the
    JAX package's format (``repro/core/pipeline.py:477``).

    With ``grid`` (the ``GridSpec`` the states are shaped for) the file
    is the grid-portable logical format (``core.regrid.LogicalState``,
    ``LOGICAL_FORMAT``), which restores at any ``(n_i, g)``; without it,
    the legacy fixed-shape format. ``storage`` is the policy the live
    ``states`` are encoded under (default: the identity policy); its
    descriptor is stamped into the file, and the logical format keeps
    the heavy leaves in the policy's encoding: quantized ``co`` with
    ``co_scale``, packed ``rated`` with ``rated_bits``, bf16 factors as
    bf16. ``detector`` (a ``DetectorState``, e.g. ``StreamResult.
    final_detector``) rides along in either format. Returns the path.
    """
    from repro_torch.checkpoint import save_checkpoint

    if storage is None:
        storage = StoragePolicy()
    carry_u, carry_i = carry
    tree = {
        "carry_u": np.asarray(carry_u if carry_u is not None else
                              np.empty(0, np.int64)),
        "carry_i": np.asarray(carry_i if carry_i is not None else
                              np.empty(0, np.int64)),
        "storage": storage.describe(),
    }
    if detector is not None:
        tree["detector"] = _host_tuple(detector)
    if grid is None:
        tree["states"] = states
    else:
        if algorithm is None:
            algorithm = algorithm_lib.infer_algorithm(states)
        logical = algorithm_lib.get_algorithm(algorithm).extract_logical(
            states, grid, storage=storage)
        # Re-encode the heavy logical leaves per the policy, so the bytes
        # on disk match the resident footprint.
        if storage.factors == "bf16":
            logical = logical._replace(
                u_vec=logical.u_vec.to(torch.bfloat16),
                i_vec=logical.i_vec.to(torch.bfloat16))
        if storage.co in ("uint16", "int8"):
            q, scale = storage_lib.quantize_rows(logical.co, storage.co)
            logical = logical._replace(co=q)
            tree["co_scale"] = scale
        elif storage.co == "bf16":
            logical = logical._replace(co=logical.co.to(torch.bfloat16))
        if storage.rated == "packed":
            tree["rated_bits"] = int(logical.rated.shape[-1])
            logical = logical._replace(
                rated=storage_lib.pack_bits(logical.rated))
        tree.update({
            "format": LOGICAL_FORMAT,
            "algorithm": algorithm,
            "grid": np.asarray([grid.n_i, grid.g], np.int64),
            "logical": logical,
        })
    return save_checkpoint(directory, events_processed, tree)


@dataclasses.dataclass
class RestoredCheckpoint:
    """What ``restore_stream_checkpoint`` hands back, by name: ``states``
    shaped for the restoring config's grid, on its device; ``carry`` the
    ``(carry_u, carry_i)`` re-queue; ``detector`` the saved drift
    ``DetectorState`` as a tuple of numpy arrays (for ``run_stream(
    initial_detector=...)``), or None."""

    events_processed: int
    states: Any
    carry: tuple
    detector: Any = None


def _leaves(tree) -> list:
    """The array leaves of a decoded checkpoint tree, depth first (JAX's
    ``tree.leaves`` order; ``None`` is no leaf)."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def restore_stream_checkpoint(directory: str, cfg: StreamConfig,
                              step: int | None = None) -> RestoredCheckpoint:
    """Restore worker states shaped like ``init_states(cfg)`` from a file
    of either package (``repro/core/pipeline.py:577``).

    A logical-format checkpoint restores at whatever grid ``cfg``
    configures (regridded through the algorithm's ``build_states``); a
    legacy one must match the grid (checked against ``state_template``)
    or raises ``CheckpointShapeError``. A checkpoint written under
    another storage policy than ``cfg.storage`` raises
    ``StoragePolicyError``, another algorithm or an unknown format
    ``ValueError``.
    """
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import convert
    from repro_torch.core import regrid as regrid_lib

    events_processed, tree = restore_checkpoint(directory, step)
    # Writable copies (msgpack's buffers are read-only).
    carry = (np.array(tree["carry_u"]), np.array(tree["carry_i"]))
    detector = tree.get("detector")
    if detector is not None:
        detector = tuple(np.array(x) for x in detector)
    hyper = cfg.resolved_hyper()
    algo = algorithm_lib.get_algorithm(cfg.algorithm)
    dev = cfg.device

    saved_policy = StoragePolicy.from_descriptor(tree.get("storage"))
    if saved_policy != cfg.storage:
        raise StoragePolicyError(saved_policy, cfg.storage)

    fmt = tree.get("format")
    if fmt is not None:
        if fmt != LOGICAL_FORMAT:
            raise ValueError(f"unknown checkpoint format {fmt!r}")
        if tree["algorithm"] != cfg.algorithm:
            raise ValueError(
                f"checkpoint holds {tree['algorithm']!r} state but the "
                f"config asks for {cfg.algorithm!r}")
        n_i, g = (int(x) for x in np.asarray(tree["grid"]))
        src = routing.GridSpec.rect(n_i, g)
        logical = regrid_lib.LogicalState(
            *(convert.to_tensor(leaf, dev) for leaf in tree["logical"]))
        # Back to the compute form build_states expects.
        if saved_policy.factors == "bf16":
            logical = logical._replace(
                u_vec=logical.u_vec.to(torch.float32),
                i_vec=logical.i_vec.to(torch.float32))
        if saved_policy.co in ("uint16", "int8"):
            logical = logical._replace(co=storage_lib.dequantize_rows(
                logical.co, convert.to_tensor(tree["co_scale"], dev)))
        elif saved_policy.co == "bf16":
            logical = logical._replace(co=logical.co.to(torch.float32))
        if saved_policy.rated == "packed":
            logical = logical._replace(rated=storage_lib.unpack_bits(
                logical.rated, int(tree["rated_bits"])))
        states = algo.build_states(
            logical, src=src, dst=cfg.grid,
            u_cap=hyper.u_cap, i_cap=hyper.i_cap, storage=cfg.storage)
        return RestoredCheckpoint(events_processed, states, carry, detector)

    # Legacy fixed-shape payload: validate against the algorithm's schema
    # (one worker stacked over the grid, in the policy's encoding).
    one = algo.state_template(hyper, cfg.storage)
    n_c = cfg.grid.n_c
    flat_t = [((n_c,) + tuple(t.shape), t.dtype) for t in _leaves(one)]
    flat_s = _leaves(tree["states"])
    ckpt_workers = (flat_s[0].shape[0] if flat_s and len(flat_s[0].shape)
                    else "?")
    if len(flat_t) != len(flat_s):
        raise CheckpointShapeError(
            ckpt_workers, cfg.grid,
            f"leaf count {len(flat_s)} != expected {len(flat_t)} "
            f"(algorithm mismatch?)")
    for s, (shape, _) in zip(flat_s, flat_t):
        if tuple(s.shape) != shape:
            raise CheckpointShapeError(
                ckpt_workers, cfg.grid,
                f"leaf shape {tuple(s.shape)} != expected {shape}")
    def leaf(s, dtype):
        t = convert.to_tensor(s, dev)
        return t if t.dtype == dtype else t.to(dtype)

    leaves = iter(leaf(s, dtype) for s, (_, dtype) in zip(flat_s, flat_t))
    tables = type(one.tables)(*(next(leaves) for _ in one.tables))
    rest = [None if t is None else next(leaves) for t in one[1:]]
    return RestoredCheckpoint(events_processed, type(one)(tables, *rest),
                              carry, detector)
