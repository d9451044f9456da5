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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ref import topn_select

__all__ = ["masked_scores", "factor_update", "fused_topn", "topn_select",
           "topn_merge", "launch_counts", "reset_launch_counts",
           "MAX_K", "MAX_TOP_N"]

MAX_K = 32       # factor width the kernels hold in a warp / a smem row
MAX_TOP_N = 32   # running list length fused_topn keeps per lane

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "factor_update": [_P] * 17 + [_I] * 5 + [_F, _F, _I, _P],
    "masked_scores": [_P] * 4 + [_I] * 4 + [_P],
    "fused_topn": [_P] * 6 + [_I] * 5 + [_P],
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
    Kernel: ``csrc/masked_scores.cu``; plain version ``ref.masked_scores``.
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


def factor_update(user_vecs, item_vecs, rated, tabs, events, *, eta: float,
                  lam: float):
    """Complete factor-model micro-batch update of every worker, IN PLACE
    (ISGD, or pairwise BPR when ``events`` carries ``j_slots``).

    See ``ref.factor_apply`` for the contract. Kernel:
    ``csrc/factor_update.cu``, one CTA per worker. Returns the (mutated)
    ``(user_vecs, item_vecs, rated, tabs)``.
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
    ``csrc/fused_topn.cu``; plain version ``ref.fused_topn``.
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


def topn_merge(ids, scores, top_n: int):
    """Merge partial top-N lists along axis -2 into one list
    (``repro/kernels/ops.py:256``): splits partition the item space, so a
    flat re-selection over the ``P * N`` candidates is exact."""
    flat_ids = ids.reshape(ids.shape[:-2] + (-1,))
    flat_scores = scores.reshape(scores.shape[:-2] + (-1,))
    return topn_select(flat_scores, flat_ids, top_n)
