"""Device-resident S&R streaming loop.

Port of the device loop of ``repro/core/engine.py``: ``_make_batch_step``
(:146, its ``live`` branch :181-278), ``init_scan_carry`` (:300),
``PublishEvent`` (:345) and ``run_stream_device`` (:405) with its
publish hooks (:440-509). The JAX engine is one jitted ``lax.scan``;
here it is a Python loop over micro-batches that only enqueues work on
the device:

  * routing and capacity bucketing on the device (``bucket_dispatch``);
  * overflow events re-queued, in stream order, into a fixed-size carry
    buffer (``carry_slots``); whatever does not fit is counted as dropped;
  * a static drain tail of ``ceil(carry_cap / capacity)`` empty steps
    flushes the re-queue at the end of the stream;
  * forgetting at the fixed ``trigger_every`` cadence (the remainder
    carried), or, with ``StreamConfig.drift``, the drift detector and
    controller (``repro_torch.drift``), their state in the loop's carry;
  * the telemetry vector (``repro_torch.obs.telemetry``) folded every
    step;
  * recall bits scattered back to stream order on the device;
  * under a storage policy (``StreamConfig.storage``, ``core.storage``),
    JAX's decode -> compute -> encode boundaries
    (``repro/core/engine.py:86``, ``:111``, ``:159``): each step decodes
    the resident states into a compute-form temporary (a full unpack of
    ``rated`` under ``packed``), the worker, the forgetting pass or the
    controller update that temporary in place, and the encoding is
    copied back into the resident tensors. The forgetting pass and the
    controller share the worker's decoded form; for the lossy tables
    (bf16 factors, bf16 or quantized ``co``) JAX encodes between the two,
    so the port rounds them there (``storage.round_trip``). The default
    policy runs no codec operation.

The loop does not synchronise with the host until the end of the stream:
no ``.item()``, no ``nonzero``, no boolean indexing. The overflow
compaction is a ``cumsum`` and a scatter. Where JAX gates the
forgetting pass and the controller with ``lax.cond`` on a device flag,
the port runs them every step with the flag folded into their masks
(``forgetting.apply_forgetting``'s ``gate``): the same result, paid on
every step. A publish boundary in sync mode (``publish_sync=True``) is
the one exception to the rule: it reads the progress scalars once the
segment's work is done.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import forgetting as forgetting_lib
from repro_torch.core import prng, routing, state as state_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core.evaluator import RecallAccumulator
from repro_torch.drift import controller as controller_lib
from repro_torch.drift import detector as detector_lib
from repro_torch.obs import telemetry as telemetry_lib

__all__ = ["make_worker_fn", "init_scan_carry", "PublishEvent",
           "run_stream_device"]

# Backend name -> the algorithm hook that builds its worker step.
_WORKERS = {"scan": "make_worker_step", "cuda": "make_cuda_worker_step"}


def make_worker_fn(cfg, backend: str, codecs: bool = True) -> Callable:
    """``worker(states, ev_u, ev_i) -> (states, hits, evaluated)`` over all
    workers, from the registered algorithm (``"scan"`` or ``"cuda"``).
    Under a storage policy it decodes the resident states, runs the step
    and encodes back in place (JAX's ``make_worker_fn`` boundary);
    ``codecs=False`` gives the bare step on compute-form states, which is
    what the device loop's step takes (it owns the codecs)."""
    algo = algorithm_lib.get_algorithm(cfg.algorithm)
    key = prng.key(cfg.seed, device=cfg.device)
    one = getattr(algo, _WORKERS[backend])(cfg.resolved_hyper(), key)
    policy = cfg.storage if codecs else None

    def worker(states, ev_u, ev_i):
        _, hits, evaluated = storage_lib.in_compute_form(
            states, policy, lambda s: one(s, (ev_u, ev_i)))
        return states, hits, evaluated

    return worker


def _adaptive(cfg) -> bool:
    return cfg.drift is not None and cfg.drift.mode == "adaptive"


def _fixed_forgetting(cfg):
    """The ``ForgettingConfig`` the fixed cadence runs, or None (no
    policy, or the adaptive drift policy, which replaces the cadence)."""
    f = cfg.forgetting
    if _adaptive(cfg) or f is None or f.policy == "none":
        return None
    return f


def _occ_total(u_occ, i_occ) -> torch.Tensor:
    """Live entries over every worker and both tables (0-d int32)."""
    return u_occ.sum(dtype=torch.int32) + i_occ.sum(dtype=torch.int32)


def _make_batch_step(cfg, worker_fn):
    """The loop's step. ``worker_fn(states, ev_u, ev_i)`` runs on the
    compute form (``make_worker_fn(..., codecs=False)``): this step owns
    the codecs."""
    grid = cfg.grid
    n_c, g, n_i = grid.n_c, grid.g, grid.n_i
    cap = cfg.bucket_capacity
    carry_cap = cfg.carry_slots or cfg.micro_batch
    layout = carry_cap + cfg.micro_batch
    top_n = cfg.resolved_hyper().top_n
    tel_on = cfg.telemetry
    # The closed-loop drift policy replaces the fixed forgetting cadence
    # when its mode is "adaptive" (``StreamConfig.drift``).
    adaptive = _adaptive(cfg)
    controller = (controller_lib.make_controller(cfg.drift) if adaptive
                  else None)
    forgetting = _fixed_forgetting(cfg)
    forget = forgetting is not None
    det_cfg = cfg.drift.detector if adaptive else None
    no_fire = torch.zeros((), dtype=torch.int32, device=cfg.device)
    policy = cfg.storage
    coded = not policy.is_default
    # JAX encodes after the worker and decodes again for the pass.
    rounds = coded and (adaptive or forget) and storage_lib.is_lossy(policy)

    def batch_step(carry, fu, fi):
        # Runs on every step, also where the JAX engine's lax.cond takes
        # its "dead" branch. A step without valid events (``live`` false)
        # yields NaN bits, zero loads and zero kept — what the dead branch
        # returns —, hands the worker only padding, which changes no
        # state, and leaves the detector, the controller and the
        # forgetting trigger as they were.
        (resident, cu, ci, since, processed, dropped, forgets, det, boost,
         tel) = carry
        states = (storage_lib.decode_state(resident, policy) if coded
                  else resident)
        bu = torch.cat([cu, fu])
        bi = torch.cat([ci, fi])
        valid = bu >= 0
        live = valid.any()
        # Invalid slots route to key n_c: out of range, so they occupy no
        # bucket capacity and contribute no load.
        keys = torch.where(valid, (bi % n_i) * g + (bu % g), n_c)
        buckets, kept, load = routing.bucket_dispatch(keys, n_c, cap)
        kept = kept & valid

        has = buckets >= 0
        src = buckets.clamp(min=0).long()
        ev_u = torch.where(has, bu[src], -1)
        ev_i = torch.where(has, bi[src], -1)
        # Precision@N denominator, on the bucket-start states.
        list_len = (telemetry_lib.effective_list_len(states, ev_u,
                                                     top_n=top_n, g=g)
                    if tel_on else 0)
        states, hits, evaluated = worker_fn(states, ev_u, ev_i)

        # Stream-order recall bits for this step (NaN = no evaluation).
        flat = buckets.reshape(-1).long()
        sel = (flat >= 0) & evaluated.reshape(-1)
        bits = torch.full((layout + 1,), float("nan"), device=bu.device)
        bits[torch.where(sel, flat, layout)] = hits.reshape(-1).float()
        bits = bits[:layout]

        # Overflow re-queue: order-preserving compaction into the carry
        # buffer; anything past the buffer is dropped and counted.
        overflow = valid & ~kept
        pos = torch.cumsum(overflow.to(torch.int32), 0) - 1
        tgt = torch.where(overflow & (pos < carry_cap), pos, carry_cap).long()
        cu_new = torch.full((carry_cap + 1,), -1, dtype=bu.dtype, device=bu.device)
        ci_new = torch.full_like(cu_new, -1)
        cu_new[tgt] = bu
        ci_new[tgt] = bi
        n_overflow = overflow.sum(dtype=torch.int32)
        dropped = dropped + torch.clamp(n_overflow - carry_cap, min=0)
        kept_n = kept.sum(dtype=torch.int32)
        processed = processed + kept_n
        since = since + kept_n

        # Forgetting (fixed cadence) or drift control (adaptive): the
        # passes run every step, gated by device flags (no host read).
        fired = no_fire
        occ_before = None
        if tel_on and (adaptive or forget):
            occ_before = _occ_total(*state_lib.occupancy(states.tables))
        if rounds:
            storage_lib.round_trip(states, policy)
        if adaptive:
            new = detector_lib.detector_update(det, hits, evaluated, det_cfg)
            det = detector_lib.DetectorState(*(
                torch.where(live, a, b) for a, b in zip(new, det)))
            flag = det.fired & live
            states, boost = controller(states, flag, boost, live=live)
            fired = flag.to(torch.int32)
            forgets = forgets + fired
        elif forget:
            trigger = (since >= forgetting.trigger_every) & live
            forgetting_lib.apply_forgetting(states, forgetting, gate=trigger)
            # Carry the remainder, as JAX: for micro_batch <=
            # trigger_every the count is floor(processed / trigger_every).
            since = torch.where(trigger, since - forgetting.trigger_every,
                                since)
            forgets = forgets + trigger.to(torch.int32)

        u_occ, i_occ = state_lib.occupancy(states.tables)
        if tel_on:
            # Decay frees no row: only the net occupancy drop counts.
            evicted = (torch.clamp(occ_before - _occ_total(u_occ, i_occ),
                                   min=0) if occ_before is not None else 0)
            tel = telemetry_lib.telemetry_batch_update(
                tel, kept=kept_n, overflow=n_overflow, carry_cap=carry_cap,
                evicted=evicted, hits=hits, evaluated=evaluated, load=load,
                occupancy=u_occ + i_occ, list_len=list_len)
        if coded:
            storage_lib.encode_into(resident, states, policy)
        carry = (resident, cu_new[:carry_cap], ci_new[:carry_cap], since,
                 processed, dropped, forgets, det, boost, tel)
        return carry, (bits, load, kept_n, fired, u_occ, i_occ)

    return batch_step


def init_scan_carry(cfg, states=None, carry=(None, None), detector=None):
    """Initial loop carry ``(states, carry_u, carry_i, since, processed,
    dropped, forgets, detector, boost, telemetry)``, JAX's ten fields;
    ``states``/``carry``/``detector`` resume a stream mid-way
    (``detector`` is any ``DetectorState``-shaped tuple)."""
    from repro_torch.core import pipeline

    if states is None:
        states = pipeline.init_states(cfg)
    carry_cap = cfg.carry_slots or cfg.micro_batch
    dev = cfg.device
    cu = torch.full((carry_cap,), -1, dtype=torch.int32, device=dev)
    ci = torch.full((carry_cap,), -1, dtype=torch.int32, device=dev)
    carry_u, carry_i = carry
    lost = 0
    if carry_u is not None and np.asarray(carry_u).size:
        size = int(np.asarray(carry_u).size)
        m = min(size, carry_cap)
        # A longer re-queue than the buffer is accounted as dropped.
        lost = size - m
        cu[:m] = torch.as_tensor(np.asarray(carry_u)[:m], dtype=torch.int32)
        ci[:m] = torch.as_tensor(np.asarray(carry_i)[:m], dtype=torch.int32)
    det = (detector_lib.detector_init(dev) if detector is None
           else detector_lib.detector_from(detector, dev))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    # The telemetry slot rides along with cfg.telemetry False too (zeros,
    # never updated), as in JAX.
    return (states, cu, ci, zero, zero, zero + lost, zero, det,
            controller_lib.controller_init(dev),
            telemetry_lib.telemetry_init(cfg.grid.n_c, dev))


class PublishEvent(NamedTuple):
    """Snapshot-boundary payload handed to ``on_publish``.

    ``states`` is a copy of the worker states at a micro-batch boundary,
    made on their device and enqueued on the loop's stream: the loop
    updates its states in place, so only a copy keeps JAX's contract
    that holding the event's states IS a consistent snapshot, for every
    subscriber. ``forgets`` counts forgetting passes fired so far (fixed
    cadence or drift controller; serving caches invalidate when it
    advances).

    The progress scalars come in two modes:

    * ``publish_sync=True`` (the default): ``events_processed`` /
      ``dropped`` / ``forgets`` are Python ints, read after the segment's
      work is done.
    * ``publish_sync=False``: they are 0-d tensors on the states' device,
      copied at the boundary; the subscriber (e.g.
      ``SnapshotStore.publish_async``) reads them off the training loop.
      :meth:`as_ints` resolves them (waiting for the segment's work).

    ``detector`` is the ``DetectorState`` at the boundary under the
    adaptive drift policy (else ``None``); ``telemetry`` the loop's
    ``TelemetryState``, cumulative for the run (``None`` with
    ``StreamConfig.telemetry`` off). Both are copies of the carry's 0-d
    tensors made at the boundary, on the states' device, in both modes;
    the ``host`` loop hands its own vector (the same values).
    """

    states: Any
    events_processed: Any  # int, or 0-d tensor when publish_sync=False
    dropped: Any
    forgets: Any
    segment: int          # 0-based index of the segment just finished
    steps_done: int       # micro-batch steps completed so far (padded)
    detector: Any = None
    telemetry: Any = None

    def as_ints(self) -> "PublishEvent":
        """A copy with the progress scalars as Python ints and the
        telemetry vector as numpy arrays (reading a tensor waits for the
        work that produced it)."""
        return self._replace(
            events_processed=int(self.events_processed),
            dropped=int(self.dropped), forgets=int(self.forgets),
            telemetry=(_to_numpy(self.telemetry)
                       if self.telemetry is not None else None))


def _to_numpy(tup):
    """A tuple of tensors (or arrays) as the same tuple of numpy arrays."""
    return type(tup)(*(x.cpu().numpy() if torch.is_tensor(x)
                       else np.asarray(x) for x in tup))


def _clone(tup):
    return type(tup)(*(x.clone() for x in tup))


def _publish_event(carry, cfg, publish_sync: bool, segment: int,
                   steps_done: int) -> PublishEvent:
    """The boundary's event: a copy of the states, then the progress
    scalars, as ints read after the segment's work (sync) or as 0-d
    tensor copies (async: no host sync), and copies of the detector and
    the telemetry vector."""
    states, _, _, _, processed, dropped, forgets, det, _, tel = carry
    snapshot = state_lib.clone_state(states)
    scalars = (processed, dropped, forgets)
    scalars = (tuple(int(x) for x in scalars) if publish_sync
               else tuple(x.clone() for x in scalars))
    return PublishEvent(snapshot, *scalars, segment=segment,
                        steps_done=steps_done,
                        detector=_clone(det) if _adaptive(cfg) else None,
                        telemetry=_clone(tel) if cfg.telemetry else None)


def run_stream_device(users: np.ndarray, items: np.ndarray, cfg, backend: str,
                      verbose: bool = False,
                      publish_every: int = 0, on_publish=None,
                      publish_sync: bool = True,
                      initial_states=None, initial_carry=(None, None),
                      initial_detector=None):
    """Run the whole prequential stream on ``cfg.device``.

    ``backend`` is ``"cuda"`` (kernel worker) or ``"scan"`` (eager
    reference worker). ``initial_states``, when given, is updated in
    place and returned as ``final_states``.

    With ``on_publish``, the stream runs in segments of ``publish_every``
    steps (the whole stream when 0) and ``on_publish(PublishEvent)``
    fires after each. As in JAX, the step count is padded to a whole
    number of segments, so ``segment`` and ``steps_done`` equal JAX's;
    the padded steps change no state and are not launched. The state
    copy is the trainer's work and counts in ``wall_seconds``; the
    subscriber's time does not.
    """
    from repro_torch.core.pipeline import StreamResult
    from repro_torch.kernels import build

    if users.shape != items.shape:
        raise ValueError(f"users {users.shape} and items {items.shape} differ")
    n = users.shape[0]
    mb = cfg.micro_batch
    carry_cap = cfg.carry_slots or mb
    cap = cfg.bucket_capacity
    device = torch.device(cfg.device)

    resumed_carry = (initial_carry[0] is not None
                     and np.asarray(initial_carry[0]).size > 0)
    n_batches = math.ceil(n / mb) if n else 0
    # Static drain tail: worst case every carried event targets one worker.
    drain = math.ceil(carry_cap / cap) if (n_batches or resumed_carry) else 0
    steps = n_batches + drain

    fu = np.full((steps, mb), -1, np.int32)
    fi = np.full((steps, mb), -1, np.int32)
    fu.reshape(-1)[:n] = users
    fi.reshape(-1)[:n] = items
    xs_u = torch.as_tensor(fu).to(device)
    xs_i = torch.as_tensor(fi).to(device)

    batch_step = _make_batch_step(cfg, make_worker_fn(cfg, backend,
                                                      codecs=False))
    carry = init_scan_carry(cfg, states=initial_states, carry=initial_carry,
                            detector=initial_detector)
    if device.type == "cuda":
        # Build the kernels before the clock starts, as the JAX engine
        # compiles its scan before its timer.
        if backend == "cuda":
            build.build_all()
        torch.cuda.synchronize(device)

    seg = publish_every if publish_every > 0 else max(steps, 1)
    n_segments = max(math.ceil(steps / seg), 1)

    t0 = time.perf_counter()
    publish_time = 0.0
    outs = []
    for seg_i in range(n_segments):
        for s in range(seg_i * seg, min((seg_i + 1) * seg, steps)):
            carry, out = batch_step(carry, xs_u[s], xs_i[s])
            outs.append(out)
        if on_publish is not None:
            ev = _publish_event(carry, cfg, publish_sync, seg_i,
                                (seg_i + 1) * seg)
            tp = time.perf_counter()
            on_publish(ev)
            publish_time += time.perf_counter() - tp
    states, cu, _, _, processed, dropped, forgets, det, _, tel = carry
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0 - publish_time

    if outs:
        bits, loads, kept_n, fired, u_occ, i_occ = (
            torch.stack([o[j] for o in outs]).cpu().numpy() for j in range(6))
    else:
        bits = np.empty((0, carry_cap + mb), np.float32)
        loads = np.empty((0, cfg.grid.n_c), np.int32)
        kept_n = fired = np.empty(0, np.int32)
        u_occ = i_occ = loads
    processed = int(processed)
    dropped = int(dropped) + int((cu >= 0).sum())

    acc = RecallAccumulator()
    active = [s for s in range(steps) if loads[s].sum() > 0 or s < n_batches]
    for s in active:
        acc.add_raw(bits[s])
    cum = np.cumsum(kept_n)
    user_occ, item_occ = [], []
    for j, s in enumerate(active):
        if j % cfg.record_every == 0 or j == len(active) - 1:
            user_occ.append((int(cum[s]), u_occ[s]))
            item_occ.append((int(cum[s]), i_occ[s]))
        if verbose and j % 16 == 0:
            print(f"[engine] step {j}/{len(active)}")

    adaptive = _adaptive(cfg)
    return StreamResult(
        recall=acc,
        user_occupancy=user_occ,
        item_occupancy=item_occ,
        events_processed=processed,
        dropped=dropped,
        wall_seconds=wall,
        load_history=[loads[s] for s in active],
        final_states=states,
        forgets=int(forgets),
        drift_flags=(np.asarray(fired[active], np.int32) if adaptive
                     else None),
        final_detector=_to_numpy(det) if adaptive else None,
        telemetry=_to_numpy(tel) if cfg.telemetry else None,
    )
