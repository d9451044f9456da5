"""Device-resident S&R streaming loop.

Port of the device loop of ``repro/core/engine.py``: ``_make_batch_step``
(:146, its ``live`` branch :181-278 without forgetting, drift or
telemetry), ``init_scan_carry`` (:300), ``PublishEvent`` (:345) and
``run_stream_device`` (:405) with its publish hooks (:440-509).
The JAX engine is one jitted ``lax.scan``; here it is a Python loop over
micro-batches that only enqueues work on the device:

  * routing and capacity bucketing on the device (``bucket_dispatch``);
  * overflow events re-queued, in stream order, into a fixed-size carry
    buffer (``carry_slots``); whatever does not fit is counted as dropped;
  * a static drain tail of ``ceil(carry_cap / capacity)`` empty steps
    flushes the re-queue at the end of the stream;
  * recall bits scattered back to stream order on the device.

The loop does not synchronise with the host until the end of the stream:
no ``.item()``, no ``nonzero``, no boolean indexing. The overflow
compaction is a ``cumsum`` and a scatter. A publish boundary in sync
mode (``publish_sync=True``) is the one exception: it reads the progress
scalars once the segment's work is done.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import prng, routing, state as state_lib
from repro_torch.core.evaluator import RecallAccumulator

__all__ = ["make_worker_fn", "init_scan_carry", "PublishEvent",
           "run_stream_device"]

# Backend name -> the algorithm hook that builds its worker step.
_WORKERS = {"scan": "make_worker_step", "cuda": "make_cuda_worker_step"}


def make_worker_fn(cfg, backend: str) -> Callable:
    """``worker(states, ev_u, ev_i) -> (states, hits, evaluated)`` over all
    workers, from the registered algorithm (``"scan"`` or ``"cuda"``)."""
    algo = algorithm_lib.get_algorithm(cfg.algorithm)
    key = prng.key(cfg.seed, device=cfg.device)
    one = getattr(algo, _WORKERS[backend])(cfg.resolved_hyper(), key)

    def worker(states, ev_u, ev_i):
        return one(states, (ev_u, ev_i))

    return worker


def _make_batch_step(cfg, worker_fn):
    grid = cfg.grid
    n_c, g, n_i = grid.n_c, grid.g, grid.n_i
    cap = cfg.bucket_capacity
    carry_cap = cfg.carry_slots or cfg.micro_batch
    layout = carry_cap + cfg.micro_batch

    def batch_step(carry, fu, fi):
        # Runs on every step, also where the JAX engine's lax.cond takes
        # its "dead" branch: a step without valid events yields NaN bits,
        # zero loads and zero kept — what the dead branch returns — and
        # hands the worker only padding, which changes no state.
        states, cu, ci, processed, dropped = carry
        bu = torch.cat([cu, fu])
        bi = torch.cat([ci, fi])
        valid = bu >= 0
        # Invalid slots route to key n_c: out of range, so they occupy no
        # bucket capacity and contribute no load.
        keys = torch.where(valid, (bi % n_i) * g + (bu % g), n_c)
        buckets, kept, load = routing.bucket_dispatch(keys, n_c, cap)
        kept = kept & valid

        has = buckets >= 0
        src = buckets.clamp(min=0).long()
        ev_u = torch.where(has, bu[src], -1)
        ev_i = torch.where(has, bi[src], -1)
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

        u_occ, i_occ = state_lib.occupancy(states.tables)
        carry = (states, cu_new[:carry_cap], ci_new[:carry_cap], processed,
                 dropped)
        return carry, (bits, load, kept_n, u_occ, i_occ)

    return batch_step


def init_scan_carry(cfg, states=None, carry=(None, None)):
    """Initial loop carry ``(states, carry_u, carry_i, processed,
    dropped)``; ``states``/``carry`` resume a stream mid-way."""
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
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (states, cu, ci, zero, zero + lost)


class PublishEvent(NamedTuple):
    """Snapshot-boundary payload handed to ``on_publish``.

    ``states`` is a copy of the worker states at a micro-batch boundary,
    made on their device and enqueued on the loop's stream: the loop
    updates its states in place, so only a copy keeps JAX's contract
    that holding the event's states IS a consistent snapshot, for every
    subscriber. ``forgets`` counts forgetting triggers (always 0 until
    the forgetting slice).

    The progress scalars come in two modes:

    * ``publish_sync=True`` (the default): ``events_processed`` /
      ``dropped`` / ``forgets`` are Python ints, read after the segment's
      work is done.
    * ``publish_sync=False``: they are 0-d tensors on the states' device,
      copied at the boundary; the subscriber (e.g.
      ``SnapshotStore.publish_async``) reads them off the training loop.
      :meth:`as_ints` resolves them (waiting for the segment's work).

    ``detector`` and ``telemetry`` are ``None``: drift detection and the
    device telemetry vector come with later slices.
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
        """A copy with the progress scalars as Python ints (reading a
        tensor waits for the work that produced it)."""
        return self._replace(events_processed=int(self.events_processed),
                             dropped=int(self.dropped),
                             forgets=int(self.forgets))


def _publish_event(carry, publish_sync: bool, segment: int,
                   steps_done: int) -> PublishEvent:
    """The boundary's event: a copy of the states, then the progress
    scalars, as ints read after the segment's work (sync) or as 0-d
    tensor copies (async: no host sync)."""
    states, _, _, processed, dropped = carry
    snapshot = state_lib.clone_state(states)
    if publish_sync:
        scalars = int(processed), int(dropped), 0
    else:
        scalars = processed.clone(), dropped.clone(), torch.zeros_like(dropped)
    return PublishEvent(snapshot, *scalars, segment=segment,
                        steps_done=steps_done)


def run_stream_device(users: np.ndarray, items: np.ndarray, cfg, backend: str,
                      publish_every: int = 0, on_publish=None,
                      publish_sync: bool = True,
                      initial_states=None, initial_carry=(None, None)):
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

    worker_fn = make_worker_fn(cfg, backend)
    batch_step = _make_batch_step(cfg, worker_fn)
    carry = init_scan_carry(cfg, states=initial_states, carry=initial_carry)
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
            ev = _publish_event(carry, publish_sync, seg_i, (seg_i + 1) * seg)
            tp = time.perf_counter()
            on_publish(ev)
            publish_time += time.perf_counter() - tp
    states, cu, _, processed, dropped = carry
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0 - publish_time

    if outs:
        bits, loads, kept_n, u_occ, i_occ = (
            torch.stack([o[j] for o in outs]).cpu().numpy() for j in range(5))
    else:
        bits = np.empty((0, carry_cap + mb), np.float32)
        loads = np.empty((0, cfg.grid.n_c), np.int32)
        kept_n = np.empty(0, np.int32)
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

    return StreamResult(
        recall=acc,
        user_occupancy=user_occ,
        item_occupancy=item_occ,
        events_processed=processed,
        dropped=dropped,
        wall_seconds=wall,
        load_history=[loads[s] for s in active],
        final_states=states,
    )
