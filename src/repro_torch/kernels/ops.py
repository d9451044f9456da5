"""Entry points of the hand-written kernels, one wrapper per kernel.

Port of ``repro/kernels/ops.py``. Dispatch is by the device of the
tensors: a CPU tensor goes to the plain version in ``ref.py``; a CUDA
tensor launches the kernel (``csrc/*.cu``, built by ``build.py``) or
raises. There is no fallback from one to the other. Each wrapper checks
device, dtype, shape and contiguity, launches on PyTorch's current
stream without synchronising, raises if the C entry point returns a
non-zero ``cudaError_t``, and adds one to its launch count
(``launch_counts()``) for every launch, and only then.

``topn_select`` / ``topn_merge`` are plain torch (the candidate set of a
merge is ``n_i * top_n``, too small for a kernel).

``swa_attention`` (K7) is bound as the custom operator
``torch.ops.repro_torch.swa_attention``: its fake implementation gives
the output's shape (a trace under ``FakeTensorMode``, as the dry-run's,
never builds or launches the kernel) and its FLOP formula
(``torch.utils.flop_counter``) counts the pairs the window and the
causal mask keep times ``4 * D`` a head (``swa_pairs``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref
from repro_torch.kernels.ref import topn_select

__all__ = ["masked_scores", "isgd_update", "factor_update", "fused_topn",
           "dics_update", "dics_topn", "swa_attention", "topn_select",
           "topn_merge", "launch_counts", "reset_launch_counts", "swa_pairs",
           "MAX_K",
           "MAX_TOP_N", "MAX_K_NN", "SWA_HEAD_DIMS"]

MAX_K = 32       # factor width the kernels hold in a warp / a smem row
MAX_TOP_N = 32   # running list length fused_topn / dics_topn keep per lane
MAX_K_NN = 32    # neighbour list length dics_topn keeps per candidate
SWA_HEAD_DIMS = (32, 64, 80, 96, 128)   # head widths K7 is built for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "factor_update": [_P] * 17 + [_I] * 5 + [_F, _F, _I, _P],
    "masked_scores": [_P] * 4 + [_I] * 4 + [_P],
    "fused_topn": [_P] * 6 + [_I] * 5 + [_P],
    "dics_update": [_P] * 15 + [_I] * 4 + [_P],
    "dics_topn": [_P] * 7 + [_I] * 5 + [_P],
    "isgd_update": [_P] * 5 + [_I] * 4 + [_F, _F, _P],
    "swa_attention": [_P] * 4 + [_I] * 8 + [_P],
}

_launches = {name: 0 for name in _ARGTYPES}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _entry(name: str):
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _launches[name] += 1


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors; CUDA tensors must share one device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _check(t: torch.Tensor, name: str, shape, dtypes) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """bool -> uint8 view, no copy."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


_F32 = (torch.float32,)
_I32 = (torch.int32,)
_MASK = (torch.bool, torch.uint8)


def masked_scores(u_vecs, item_vecs, mask):
    """Masked scoring for every worker: f32[W, B, I], -inf where masked.

    u_vecs f32[W, B, k]; item_vecs f32[W, I, k]; mask bool/uint8 [W, B, I].
    Kernel: ``csrc/masked_scores.cu`` (4 items a thread, a CTA walking 16
    rows of a 1,024-item strip; 4-byte mask loads and float4 stores where
    I is a multiple of 4, scalar ones elsewhere); plain version
    ``ref.masked_scores``.
    """
    if _on_cpu(u_vecs, item_vecs, mask):
        return ref.masked_scores(u_vecs, item_vecs, mask)
    w, b, k = u_vecs.shape
    i = item_vecs.shape[1]
    if k > MAX_K:
        raise ValueError(f"masked_scores: k={k} > {MAX_K}")
    _check(u_vecs, "u_vecs", (w, b, k), _F32)
    _check(item_vecs, "item_vecs", (w, i, k), _F32)
    _check(mask, "mask", (w, b, i), _MASK)
    out = torch.empty((w, b, i), dtype=torch.float32, device=u_vecs.device)
    _launch("masked_scores", u_vecs.device, u_vecs.data_ptr(),
            item_vecs.data_ptr(), _bytes(mask).data_ptr(), out.data_ptr(),
            w, b, i, k)
    return out


def isgd_update(user_tab, item_tab, u_slots, i_slots, valid, *, eta: float,
                lam: float):
    """Factors-only sequential ISGD micro-batch, IN PLACE
    (``repro/kernels/ops.py:71``): per event, in order and only where
    ``valid``, ``err = 1 - u.i`` and the rank-1 update of both rows.

    user_tab f32[U, k]; item_tab f32[I, k] (``k <= MAX_K``, taken as it
    is: no lane padding); u_slots / i_slots i32[E]; valid bool/uint8 [E].
    An event whose slot lies outside its table changes nothing, on either
    version. Such slots fall outside the parity contract with
    ``repro.kernels.ops.isgd_update``, which wraps a negative slot to the
    last row and, for a slot past the end, clamps its gather to the last
    row and drops its scatter. Kernel: ``csrc/isgd_update.cu``, one CTA
    taking the events in staged chunks: each event linked to the previous
    one on its user and item row, then replayed by 32 warps as those
    finish (every row's events in the batch's order, so the result is
    the sequential one bit for bit). Returns the (mutated) ``(user_tab,
    item_tab)``.
    """
    if _on_cpu(user_tab, item_tab, u_slots, i_slots, valid):
        return ref.isgd_apply(user_tab, item_tab, u_slots, i_slots, valid,
                              eta=eta, lam=lam)
    u, k = user_tab.shape
    i = item_tab.shape[0]
    e = u_slots.shape[0]
    if k > MAX_K:
        raise ValueError(f"isgd_update: k={k} > {MAX_K}")
    _check(user_tab, "user_tab", (u, k), _F32)
    _check(item_tab, "item_tab", (i, k), _F32)
    _check(u_slots, "u_slots", (e,), _I32)
    _check(i_slots, "i_slots", (e,), _I32)
    _check(valid, "valid", (e,), _MASK)
    if e == 0:
        return user_tab, item_tab
    _launch("isgd_update", user_tab.device, user_tab.data_ptr(),
            item_tab.data_ptr(), u_slots.data_ptr(), i_slots.data_ptr(),
            _bytes(valid).data_ptr(), u, i, k, e, float(eta), float(lam))
    return user_tab, item_tab


def factor_update(user_vecs, item_vecs, rated, tabs, events, *, eta: float,
                  lam: float):
    """Complete factor-model micro-batch update of every worker, IN PLACE
    (ISGD, or pairwise BPR when ``events`` carries ``j_slots``).

    See ``ref.factor_apply`` for the contract; any bucket width ``E``;
    ``j_slots`` within ``[0, I)``. Kernel: ``csrc/factor_update.cu``, both
    modes staging each worker's bucket on a cluster of CTAs and replaying
    it in shared memory (``csrc/bucket_stage.cuh``); pairwise mode (the
    BPR-MF path) also works out each negative's live tenant and rated
    byte before the replay. Returns the (mutated) ``(user_vecs,
    item_vecs, rated, tabs)``.
    """
    ev_u, ev_i, u_slots, i_slots, j_slots, init_u, init_i = events
    if _on_cpu(user_vecs, item_vecs, rated, ev_u, init_u, *tabs):
        return ref.factor_apply(user_vecs, item_vecs, rated, tabs, events,
                                eta=eta, lam=lam)
    w, u, k = user_vecs.shape
    i = item_vecs.shape[1]
    e = ev_u.shape[1]
    if k > MAX_K:
        raise ValueError(f"factor_update: k={k} > {MAX_K}")
    pairwise = j_slots is not None
    if not pairwise:
        j_slots = i_slots  # read by the kernel only in pairwise mode
    _check(user_vecs, "user_vecs", (w, u, k), _F32)
    _check(item_vecs, "item_vecs", (w, i, k), _F32)
    _check(rated, "rated", (w, u, i), _MASK)
    uid, iid, ufq, ifq, uts, its, clock = tabs
    for name, t, n in (("user_ids", uid, u), ("item_ids", iid, i),
                       ("user_freq", ufq, u), ("item_freq", ifq, i),
                       ("user_ts", uts, u), ("item_ts", its, i)):
        _check(t, name, (w, n), _I32)
    _check(clock, "clock", (w,), _I32)
    for name, t in (("ev_u", ev_u), ("ev_i", ev_i), ("u_slots", u_slots),
                    ("i_slots", i_slots), ("j_slots", j_slots)):
        _check(t, name, (w, e), _I32)
    _check(init_u, "init_u", (w, e, k), _F32)
    _check(init_i, "init_i", (w, e, k), _F32)
    _launch("factor_update", user_vecs.device,
            user_vecs.data_ptr(), item_vecs.data_ptr(),
            _bytes(rated).data_ptr(), uid.data_ptr(), iid.data_ptr(),
            ufq.data_ptr(), ifq.data_ptr(), uts.data_ptr(), its.data_ptr(),
            clock.data_ptr(), ev_u.data_ptr(), ev_i.data_ptr(),
            u_slots.data_ptr(), i_slots.data_ptr(), j_slots.data_ptr(),
            init_u.data_ptr(), init_i.data_ptr(), w, u, i, k, e,
            float(eta), float(lam), int(pairwise))
    return user_vecs, item_vecs, rated, tabs


def fused_topn(u_vecs, item_vecs, mask, item_ids, *, top_n: int):
    """Fused serve leaf for every worker: masked scoring + top-N.

    u_vecs f32[W, B, k]; item_vecs f32[W, I, k]; mask bool/uint8
    [W, B, I]; item_ids i32[W, I]. Returns (ids i32[W, B, n], scores
    f32[W, B, n]) with ``n = min(top_n, I)``, ordered (score desc, id
    asc) exactly as ``masked_scores`` + ``topn_select``. Kernel:
    ``csrc/fused_topn.cu`` (one CTA per 8 queries of a worker, strided
    over its rows; passes of 1,024 items staged in shared memory by
    cp.async, byte loads where a source is not 16-byte aligned; 4 items a
    thread scored against the 8 queries; one running top-N a query, one
    entry a lane, held in its warp; one shared list for rows without a
    candidate, an exact pass for rows with 1 to N - 1); plain version
    ``ref.fused_topn``.
    """
    if _on_cpu(u_vecs, item_vecs, mask, item_ids):
        return ref.fused_topn(u_vecs, item_vecs, mask, item_ids, top_n)
    w, b, k = u_vecs.shape
    i = item_vecs.shape[1]
    n = min(top_n, i)
    if k > MAX_K or n > MAX_TOP_N:
        raise ValueError(f"fused_topn: k={k} (max {MAX_K}), "
                         f"top_n={n} (max {MAX_TOP_N})")
    _check(u_vecs, "u_vecs", (w, b, k), _F32)
    _check(item_vecs, "item_vecs", (w, i, k), _F32)
    _check(mask, "mask", (w, b, i), _MASK)
    _check(item_ids, "item_ids", (w, i), _I32)
    out_ids = torch.empty((w, b, n), dtype=torch.int32, device=u_vecs.device)
    out_sc = torch.empty((w, b, n), dtype=torch.float32, device=u_vecs.device)
    _launch("fused_topn", u_vecs.device, u_vecs.data_ptr(),
            item_vecs.data_ptr(),
            _bytes(mask).data_ptr(), item_ids.data_ptr(), out_ids.data_ptr(),
            out_sc.data_ptr(), w, b, i, k, n)
    return out_ids, out_sc


def dics_update(co, item_cnt, rated, tabs, events, *, live=None):
    """DICS micro-batch update of every worker (Eq. 6 statistics and
    bookkeeping), IN PLACE.

    co f32[W, I, I]; item_cnt f32[W, I]; rated bool/uint8 [W, U, I]; tabs
    as ``factor_update``; events ``(ev_u, ev_i, u_slots, i_slots)`` i32
    [W, E]; ``live`` an optional 0-d bool tensor on the same device:
    when false the call changes nothing (read by the kernel, so the host
    never waits for it). See ``ref.dics_apply`` for the contract; any
    bucket width ``E``. Kernel: ``csrc/dics_update.cu``, each worker's
    bucket staged on a cluster of CTAs and replayed in shared memory
    (``csrc/bucket_stage.cuh``). Returns the (mutated) ``(co, item_cnt,
    rated, tabs)``.
    """
    ev_u, ev_i, u_slots, i_slots = events
    extra = () if live is None else (live,)
    if _on_cpu(co, item_cnt, rated, ev_u, *tabs, *extra):
        return ref.dics_apply(co, item_cnt, rated, tabs, events, live=live)
    w, u, i = rated.shape
    e = ev_u.shape[1]
    _check(co, "co", (w, i, i), _F32)
    _check(item_cnt, "item_cnt", (w, i), _F32)
    _check(rated, "rated", (w, u, i), _MASK)
    uid, iid, ufq, ifq, uts, its, clock = tabs
    for name, t, n in (("user_ids", uid, u), ("item_ids", iid, i),
                       ("user_freq", ufq, u), ("item_freq", ifq, i),
                       ("user_ts", uts, u), ("item_ts", its, i)):
        _check(t, name, (w, n), _I32)
    _check(clock, "clock", (w,), _I32)
    for name, t in (("ev_u", ev_u), ("ev_i", ev_i), ("u_slots", u_slots),
                    ("i_slots", i_slots)):
        _check(t, name, (w, e), _I32)
    live_ptr = None
    if live is not None:
        _check(live, "live", (), (torch.bool,))
        live_ptr = _bytes(live).data_ptr()
    _launch("dics_update", co.device, co.data_ptr(), item_cnt.data_ptr(),
            _bytes(rated).data_ptr(), uid.data_ptr(), iid.data_ptr(),
            ufq.data_ptr(), ifq.data_ptr(), uts.data_ptr(), its.data_ptr(),
            clock.data_ptr(), ev_u.data_ptr(), ev_i.data_ptr(),
            u_slots.data_ptr(), i_slots.data_ptr(), live_ptr, w, u, i, e)
    return co, item_cnt, rated, tabs


def dics_topn(co, item_cnt, hist, known, item_ids, *, top_n: int, k_nn: int):
    """DICS serve leaf for every worker: Eq. 6 similarity, Eq. 7
    neighbour mass over each query's history, candidate rule and top-N.

    co f32[W, I, I]; item_cnt f32[W, I]; hist bool/uint8 [W, B, I]
    (known-masked rated rows); known bool [W, B]; item_ids i32[W, I].
    Returns (ids i32[W, B, n], scores f32[W, B, n]), ``n = min(top_n,
    I)``, equal to ``ref.dics_topn``. Kernel: ``csrc/dics_topn.cu`` (one
    CTA per 8 queries of a worker).
    """
    if _on_cpu(co, item_cnt, hist, known, item_ids):
        return ref.dics_topn(co, item_cnt, hist.bool(), known.bool(),
                             item_ids, top_n, k_nn)
    w, b, i = hist.shape
    n = min(top_n, i)
    k = min(k_nn, i)
    if n > MAX_TOP_N or k > MAX_K_NN or n < 1 or k < 1:
        raise ValueError(f"dics_topn: top_n={n} (1..{MAX_TOP_N}), "
                         f"k_nn={k} (1..{MAX_K_NN})")
    _check(co, "co", (w, i, i), _F32)
    _check(item_cnt, "item_cnt", (w, i), _F32)
    _check(hist, "hist", (w, b, i), _MASK)
    _check(known, "known", (w, b), _MASK)
    _check(item_ids, "item_ids", (w, i), _I32)
    out_ids = torch.empty((w, b, n), dtype=torch.int32, device=co.device)
    out_sc = torch.empty((w, b, n), dtype=torch.float32, device=co.device)
    _launch("dics_topn", co.device, co.data_ptr(), item_cnt.data_ptr(),
            _bytes(hist).data_ptr(), _bytes(known).data_ptr(),
            item_ids.data_ptr(), out_ids.data_ptr(), out_sc.data_ptr(),
            w, b, i, n, k)
    return out_ids, out_sc


_SWA_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def swa_attention(q, k, v, *, window: int | None = None, causal: bool = True):
    """Flash sliding-window attention with GQA (``repro/kernels/ops.py:272``).

    q [B, Hq, S, D]; k, v [B, Hkv, S, D]; one type, f32 or bf16; ``D`` in
    ``SWA_HEAD_DIMS``; any ``S`` (the kernel masks a ragged tail itself).
    Returns [B, Hq, S, D] in q's type; see ``ref.swa_attention`` for the
    contract. Kernel: ``csrc/swa_attention.cu`` (bf16: TMA-fed K / V ring
    and wgmma on Hopper, masks on boundary tiles only, see
    ``ref.swa_tile_classes``; f32 on FMA units); plain version
    ``ref.swa_attention``.
    """
    return torch.ops.repro_torch.swa_attention(q, k, v, window, causal)


@torch.library.custom_op("repro_torch::swa_attention", mutates_args=())
def _swa_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int], causal: bool) -> torch.Tensor:
    """K7 on CUDA tensors, ``ref.swa_attention`` on CPU tensors."""
    if _on_cpu(q, k, v):
        return ref.swa_attention(q, k, v, window=window, causal=causal)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if d not in SWA_HEAD_DIMS:
        raise ValueError(f"swa_attention: head_dim {d}, expected one of "
                         f"{SWA_HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"swa_attention: {hq} q heads over {hkv} kv heads")
    if window is not None and not 0 <= window < 2**31:
        raise ValueError(f"swa_attention: window {window}")
    if q.dtype not in _SWA_TYPES:
        raise ValueError(f"swa_attention: dtype {q.dtype}, expected one of "
                         f"{tuple(_SWA_TYPES)}")
    if s > 65535 * 16:
        raise ValueError(f"swa_attention: S={s} beyond the launch grid")
    _check(q, "q", (b, hq, s, d), (q.dtype,))
    _check(k, "k", (b, hkv, s, d), (q.dtype,))
    _check(v, "v", (b, hkv, s, d), (q.dtype,))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"swa_attention: {name} not 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch("swa_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, hq, hkv, s, d,
            -1 if window is None else int(window), int(causal),
            _SWA_TYPES[q.dtype])
    return out


@_swa_attention_op.register_fake
def _(q, k, v, window, causal):
    return torch.empty_like(q)


def swa_pairs(s: int, window: int | None, causal: bool) -> int:
    """(query, key) pairs one head of K7 computes: key ``j`` of query
    ``i`` when ``j <= i`` (causal) and ``i - j < window``."""
    if window is None or window >= s:
        return s * (s + 1) // 2 if causal else s * s
    if causal:
        return window * (window + 1) // 2 + (s - window) * window
    return s * s - (s - window) * (s - window + 1) // 2


@register_flop_formula(torch.ops.repro_torch.swa_attention)
def _swa_flops(q_shape, k_shape, v_shape, window, causal, *args,
               out_shape=None, **kwargs) -> int:
    """Q.K^T and P.V over the kept pairs: 4 * D FLOPs a pair a head."""
    b, hq, s, d = q_shape
    return b * hq * swa_pairs(s, window, causal) * 4 * d


def topn_merge(ids, scores, top_n: int):
    """Merge partial top-N lists along axis -2 into one list
    (``repro/kernels/ops.py:256``): splits partition the item space, so a
    flat re-selection over the ``P * N`` candidates is exact."""
    flat_ids = ids.reshape(ids.shape[:-2] + (-1,))
    flat_scores = scores.reshape(scores.shape[:-2] + (-1,))
    return topn_select(flat_scores, flat_ids, top_n)
