"""Device-resident telemetry riding the device loop's carry.

Port of ``repro/obs/telemetry.py``: ``TelemetryState`` (:57),
``telemetry_init`` (:75), ``telemetry_update`` (:81),
``telemetry_batch_update`` (:113), ``effective_list_len`` (:131),
``telemetry_ints`` (:169), ``TelemetryFolder`` (:184) and
``HOST_CARRY_CAP``. A small tuple of 0-d int32 tensors (and two
``[n_c]`` ones) on the stream's device, folded forward every
micro-batch with integer arithmetic: no host read in the loop, and the
same values from the ``host`` loop and the device loop on the same
inputs (integer adds and maxima).

The vector counts, cumulatively within one ``run_stream`` call:

  * ``events``     — kept events processed;
  * ``dropped``    — overflow events past the re-queue capacity;
  * ``requeued``   — overflow events re-queued for a later micro-batch;
  * ``evictions``  — table entries freed by forgetting / drift control
    (occupancy before the pass minus after it);
  * ``hits`` / ``evals`` — prequential recall numerator / denominator;
  * ``bucket_hwm`` — per-bucket dispatch-load high-water mark (``[n_c]``);
  * ``occ_hwm``    — per-worker occupancy high-water mark (``[n_c]``);
  * ``list_len``   — summed effective top-N list length, the
    precision@N denominator.

The host loop's re-queue is unbounded, so it folds with ``carry_cap =
HOST_CARRY_CAP``; the device loop passes its fixed re-queue size. Every
update builds new tensors (none is written in place), so a publish
boundary may hand the carry's vector over as it is.

Host side, :class:`TelemetryFolder` turns cumulative vectors into
registry counters: ``fold`` reads the vector on the calling thread (the
async publisher thread for ``publish_sync=False`` runs, where the store
has already copied it to the host) and increments each counter by the
delta since the previous fold.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import state as state_lib
from repro_torch.core import storage as storage_lib

__all__ = ["TelemetryState", "telemetry_init", "telemetry_update",
           "telemetry_batch_update", "telemetry_ints", "TelemetryFolder",
           "effective_list_len", "HOST_CARRY_CAP"]

# The host loop re-queues overflow into an unbounded list; folding with
# this capacity makes "never drops, always requeues" fall out of the
# same arithmetic the device loop uses.
HOST_CARRY_CAP = int(np.iinfo(np.int32).max)


class TelemetryState(NamedTuple):
    """Cumulative loop telemetry (0-d int32 tensors + two int32[n_c])."""

    events: torch.Tensor      # kept events processed
    dropped: torch.Tensor     # overflow past the re-queue capacity
    requeued: torch.Tensor    # overflow re-queued (backpressure volume)
    evictions: torch.Tensor   # table entries freed by forgetting
    hits: torch.Tensor        # prequential recall hits
    evals: torch.Tensor       # prequential recall evaluations
    bucket_hwm: torch.Tensor  # i32[n_c] per-bucket load high-water mark
    occ_hwm: torch.Tensor     # i32[n_c] per-worker occupancy high-water
                              # mark (user + item live entries)
    list_len: torch.Tensor    # summed effective top-N list length


def telemetry_init(n_c: int, device="cuda") -> TelemetryState:
    def z(shape=()):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return TelemetryState(z(), z(), z(), z(), z(), z(), z((n_c,)), z((n_c,)),
                          z())


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as int32 on ``like``'s device; a Python int is a fill (no
    host copy, so no synchronization)."""
    if torch.is_tensor(x):
        return x.to(torch.int32)
    if isinstance(x, int):
        return torch.full((), x, dtype=torch.int32, device=like.device)
    return torch.as_tensor(np.asarray(x, np.int32), device=like.device)


def telemetry_update(tel: TelemetryState, *, kept, overflow, carry_cap,
                     evicted, hits, evals, load, occupancy=None,
                     list_len=0) -> TelemetryState:
    """Fold one micro-batch of integer counts into the running vector.

    Every argument is an int or an int tensor (int32 arithmetic, as
    JAX). ``occupancy`` (int32[n_c] live entries per worker) is
    optional: ``None`` leaves the occupancy high-water mark unchanged.
    """
    z = tel.events
    overflow = _i32(overflow, z)
    occ_hwm = tel.occ_hwm
    if occupancy is not None:
        occ_hwm = torch.maximum(occ_hwm, _i32(occupancy, z))
    return TelemetryState(
        events=tel.events + _i32(kept, z),
        dropped=tel.dropped + torch.clamp(overflow - carry_cap, min=0),
        requeued=tel.requeued + torch.clamp(overflow, max=carry_cap),
        evictions=tel.evictions + _i32(evicted, z),
        hits=tel.hits + _i32(hits, z),
        evals=tel.evals + _i32(evals, z),
        bucket_hwm=torch.maximum(tel.bucket_hwm, _i32(load, z)),
        occ_hwm=occ_hwm,
        list_len=tel.list_len + _i32(list_len, z),
    )


def telemetry_batch_update(tel: TelemetryState, *, kept, overflow,
                           carry_cap, evicted, hits, evaluated, load,
                           occupancy=None, list_len=0) -> TelemetryState:
    """:func:`telemetry_update` with the recall reduction inlined:
    ``hits`` / ``evaluated`` are the worker step's ``bool[n_c, cap]``
    masks, reduced here by one expression for every backend."""
    return telemetry_update(
        tel, kept=kept, overflow=overflow, carry_cap=carry_cap,
        evicted=evicted, hits=(hits & evaluated).sum(dtype=torch.int32),
        evals=evaluated.sum(dtype=torch.int32), load=load,
        occupancy=occupancy, list_len=list_len)


def effective_list_len(states, ev_u, *, top_n: int, g: int,
                       storage=None) -> torch.Tensor:
    """Summed effective top-N list length of one dispatched micro-batch.

    The precision@N denominator, on the bucket-start ``states`` (before
    the worker step trains on the batch): for each kept event
    ``min(top_n, live unrated items on its worker)``. ``states`` is the
    stacked ``[n_c, ...]`` state and ``ev_u`` the dispatch's int32
    ``[n_c, cap]`` user ids (-1 = empty slot). Integer arithmetic; a
    0-d int32 tensor.
    """
    t = states.tables
    u_cap, i_cap = t.user_ids.shape[-1], t.item_ids.shape[-1]
    valid = ev_u >= 0
    u_slot = state_lib.slot_of(ev_u, g, u_cap).long()
    known_u = valid & (t.user_ids.gather(1, u_slot) == ev_u)
    live = t.item_ids >= 0
    rated = storage_lib.gather_rated(states.rated, u_slot, storage, i_cap)
    # Candidates: live items, less the live items a known user rated.
    n_rated = (rated & live[:, None, :]).sum(-1, dtype=torch.int32)
    n_cand = (live.sum(-1, dtype=torch.int32)[:, None]
              - torch.where(known_u, n_rated, 0))
    return torch.where(valid, torch.clamp(n_cand, max=top_n), 0).sum(
        dtype=torch.int32)


def telemetry_ints(tel: TelemetryState) -> dict:
    """Host-int view of a telemetry vector (reads device tensors)."""
    def arr(x):
        return (x.cpu().numpy() if torch.is_tensor(x)
                else np.asarray(x)).reshape(-1)

    return {
        "events": int(tel.events),
        "dropped": int(tel.dropped),
        "requeued": int(tel.requeued),
        "evictions": int(tel.evictions),
        "hits": int(tel.hits),
        "evals": int(tel.evals),
        "bucket_hwm": [int(v) for v in arr(tel.bucket_hwm)],
        "occ_hwm": [int(v) for v in arr(tel.occ_hwm)],
        "list_len": int(tel.list_len),
    }


class TelemetryFolder:
    """Folds cumulative telemetry vectors into a metrics registry.

    The vector restarts from zero at every ``run_stream`` call, so the
    owner (``StreamSession.ingest``) calls :meth:`rebase` at the start
    of each segment; ``fold`` then increments the ``stream_*`` counters
    by the delta against the previously folded vector. Because the
    vector is cumulative, folding only the freshest of several pending
    publishes (the snapshot store's coalescing) loses nothing.
    """

    _SCALARS = ("events", "dropped", "requeued", "evictions", "hits",
                "evals", "list_len")

    def __init__(self, registry):
        self.registry = registry
        self._lock = threading.Lock()
        self._last: dict | None = None
        self._counters = {
            "events": registry.counter(
                "stream_events_total", "Events processed (kept) by the "
                "streaming engine"),
            "dropped": registry.counter(
                "stream_dropped_total", "Overflow events dropped past "
                "the re-queue capacity"),
            "requeued": registry.counter(
                "stream_requeued_total", "Overflow events re-queued into "
                "a later micro-batch"),
            "evictions": registry.counter(
                "stream_evictions_total", "Table entries freed by "
                "forgetting / drift control"),
            "hits": registry.counter(
                "stream_recall_hits_total", "Prequential recall hits"),
            "evals": registry.counter(
                "stream_recall_evals_total", "Prequential recall "
                "evaluations"),
            "list_len": registry.counter(
                "stream_list_len_total", "Summed effective top-N list "
                "length (precision@N denominator)"),
        }
        self._hwm = registry.gauge(
            "stream_bucket_hwm", "Per-bucket dispatch-load high-water "
            "mark (events)", labels=("bucket",))
        self._occ_frac = registry.gauge(
            "bucket_occupancy_frac", "Per-worker occupancy high-water "
            "mark as a fraction of table capacity (user + item entries)",
            labels=("bucket",))
        self._capacity: int | None = None

    def set_capacity(self, entries: int) -> None:
        """Per-worker entry capacity (u_cap + i_cap) for the occupancy
        fraction gauge."""
        with self._lock:
            self._capacity = int(entries) if entries else None

    def rebase(self) -> None:
        """Mark the start of a new stream segment (counters reset to 0)."""
        with self._lock:
            self._last = None

    def fold(self, tel) -> dict | None:
        """Read ``tel`` (on this thread) and fold deltas into counters."""
        if tel is None:
            return None
        vals = telemetry_ints(tel)
        with self._lock:
            last = self._last if self._last is not None else {}
            for f in self._SCALARS:
                delta = vals[f] - last.get(f, 0)
                if delta > 0:
                    self._counters[f].inc(delta)
            for b, v in enumerate(vals["bucket_hwm"]):
                self._hwm.labels(bucket=str(b)).set_max(v)
            if self._capacity:
                for b, v in enumerate(vals.get("occ_hwm", ())):
                    self._occ_frac.labels(bucket=str(b)).set(
                        v / self._capacity)
            self._last = vals
        return vals
