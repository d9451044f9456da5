"""Attention: GQA with sliding windows, its forward through the flash kernel.

Port of ``repro/models/layers/attention.py`` (:35-200). The full-sequence
attention of training and prefill goes through ``ops.swa_attention``
(kernel K7, ``kernels/csrc/swa_attention.cu``): the JAX module computes
the same function in chunked jnp (``_sdpa`` over q blocks, :88) and
names the Pallas kernel as the TPU form of that schedule. K7 has no
backward, and JAX trains through its jnp chunks, not through the Pallas
kernel; so ``SwaAttention`` (an ``autograd.Function``) runs K7 forward
and a plain PyTorch backward recomputed per q chunk on JAX's schedule
(``_swa_backward``). Without it the kernel's output, written through raw
pointers, would carry no gradient to ``wq`` / ``wk`` / ``wv``. Decode has
no kernel in JAX and stays plain PyTorch here: one new token against a
rolling buffer of ``window`` slots (SWA) or the full context, with slot
positions tracked explicitly so the mask is exact across wraparound.

The decode cache is updated IN PLACE (``decode_attention`` writes the new
slot, its position and the length into the tensors it is given).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.module import ParamDecl

__all__ = ["attn_decl", "attention", "decode_attention", "KVCache",
           "init_cache", "cache_decl", "SwaAttention", "q_chunk"]

NEG_INF = -1e30


def attn_decl(cfg) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamDecl((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamDecl((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDecl((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDecl((h, dh, d), ("heads", "head_dim", "embed")),
    }


class KVCache(NamedTuple):
    k: torch.Tensor        # [..., B, Hkv, C, Dh] bf16 (roped)
    v: torch.Tensor        # [..., B, Hkv, C, Dh]
    pos: torch.Tensor      # [..., B, C] i32 absolute position per slot, -1 empty
    length: torch.Tensor   # [..., B] i32 next absolute position


def cache_decl(cfg, batch: int, cache_len: int, *, seq_shard: bool,
               dtype="bfloat16") -> dict:
    """One layer's cache declarations with their logical axes
    (``attention.py:52``); ``seq_shard`` puts the slots on
    ``"cache_seq"`` (sharded over ``model`` when the KV heads cannot be)."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    seq_axis = "cache_seq" if seq_shard else "seq"
    return {
        "k": ParamDecl((batch, kv, cache_len, dh),
                       ("batch", "kv_heads", seq_axis, "head_dim"),
                       init="zeros", dtype=dtype),
        "v": ParamDecl((batch, kv, cache_len, dh),
                       ("batch", "kv_heads", seq_axis, "head_dim"),
                       init="zeros", dtype=dtype),
        "pos": ParamDecl((batch, cache_len), ("batch", seq_axis),
                         init="zeros", dtype="int32"),
        "length": ParamDecl((batch,), ("batch",), init="zeros",
                            dtype="int32"),
    }


def init_cache(cfg, batch: int, cache_len: int, device=None) -> KVCache:
    """An empty one-layer cache: every slot at position -1 (masked)."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    shape = (batch, kv, cache_len, dh)
    return KVCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        pos=torch.full((batch, cache_len), -1, dtype=torch.int32,
                       device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _qkv(params, x, positions, cfg):
    """Projections in x's type (bf16; f32 weights cast at use), then rope
    on q and k. x [B, S, D] -> q [B, H, S, Dh], k / v [B, Hkv, S, Dh]."""
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bhsk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bhsk", x, params["wv"].to(x.dtype))
    q = apply_rope(q, positions, theta=cfg.rope_theta, rope_pct=cfg.rope_pct)
    k = apply_rope(k, positions, theta=cfg.rope_theta, rope_pct=cfg.rope_pct)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """Plain decode attention (``attention.py:88``) in f32.
    q [B, G, Hkv, qc, Dh]; k / v [B, Hkv, C, Dh]; mask [B, 1, 1, qc, C]."""
    logits = torch.einsum("bghsk,bhtk->bghst", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bghst,bhtk->bghsk", p, v.float())


def q_chunk(s: int, q_chunk_max: int) -> int:
    """JAX's q block: the largest divisor of ``s`` not above
    ``q_chunk_max`` (``attention.py:130``)."""
    qc = min(q_chunk_max, s)
    while s % qc:
        qc -= 1
    return qc


def _swa_backward(q, k, v, dout, window, causal, qc):
    """Gradients of ``ref.swa_attention`` at (q, k, v) for ``dout``, in
    f32, a q chunk at a time on JAX's schedule (``chunk_fn``,
    ``attention.py:135``): chunks of ``qc`` rows, each against a key slab
    of ``min(S, window + qc)`` starting at ``clip(q_start + qc - slab, 0,
    S - slab)``, or against every key without a window or without a
    causal bound (a row's keys then reach past its chunk); f32 logits,
    the softmax recomputed, a row with no visible key giving 0. dq is
    written chunk by chunk, dk / dv accumulated over the slabs in f32; no
    [B, H, S, S] tensor is made. Returns dq, dk, dv in q's type."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = d ** -0.5
    slab = s if window is None or not causal else min(s, window + qc)
    qg = q.view(b, hkv, g, s, d)
    dog = dout.view(b, hkv, g, s, d)
    dq = torch.empty_like(q).view(b, hkv, g, s, d)
    dk = torch.zeros((b, hkv, s, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, s, qc):
        k0 = min(max(q0 + qc - slab, 0), s - slab)
        qpos = torch.arange(q0, q0 + qc, device=q.device)[:, None]
        kpos = torch.arange(k0, k0 + slab, device=q.device)[None, :]
        mask = torch.ones((qc, slab), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        kc = k[:, :, k0:k0 + slab].float()
        vc = v[:, :, k0:k0 + slab].float()
        qf = qg[:, :, :, q0:q0 + qc].float()
        do = dog[:, :, :, q0:q0 + qc].float()
        logits = torch.einsum("bhgqd,bhtd->bhgqt", qf, kc) * scale
        p = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        p = torch.where(mask.any(-1, keepdim=True), p, 0.0)
        del logits
        dv[:, :, k0:k0 + slab] += torch.einsum("bhgqt,bhgqd->bhtd", p, do)
        dp = torch.einsum("bhgqd,bhtd->bhgqt", do, vc)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
        del p, dp
        dq[:, :, :, q0:q0 + qc] = torch.einsum("bhgqt,bhtd->bhgqd", ds, kc)
        dk[:, :, k0:k0 + slab] += torch.einsum("bhgqt,bhgqd->bhtd", ds, qf)
    return dq.view(b, hq, s, d), dk.to(k.dtype), dv.to(v.dtype)


class SwaAttention(torch.autograd.Function):
    """``ops.swa_attention`` (K7 on the card, its plain version on the
    CPU) with a gradient: the plain backward of ``_swa_backward``.
    Saves q / k / v only; a CUDA input launches the kernel or raises."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, qc):
        ctx.save_for_backward(q, k, v)
        ctx.args = (window, causal, qc)
        return ops.swa_attention(q, k, v, window=window, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _swa_backward(q, k, v, dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def attention(params, x, positions, cfg, *, window=None, causal=None):
    """Full-sequence attention (training and prefill), ``attention.py:100``.

    x [B, S, D] -> (y [B, S, D], (k, v)); k (roped) and v [B, Hkv, S, Dh]
    are returned for the decode cache. One ``ops.swa_attention`` launch,
    through ``SwaAttention`` (its backward: JAX's q chunks of
    ``cfg.q_chunk``).
    """
    window = cfg.window if window is None else window
    causal = cfg.causal if causal is None else causal
    q, k, v = _qkv(params, x, positions, cfg)
    out = SwaAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                             window, causal, q_chunk(q.shape[2], cfg.q_chunk))
    y = torch.einsum("bhsk,hkd->bsd", out.to(x.dtype),
                     params["wo"].to(x.dtype))
    return y, (k, v)


def decode_attention(params, x, cache: KVCache, cfg):
    """Single-token decode step (``attention.py:166``), IN PLACE on
    ``cache``. x [B, 1, D] -> y [B, 1, D].

    The cache stores roped keys. Slot ``length % cache_len`` takes the new
    key, value and position (a rolling buffer when the cache holds the
    last ``window`` positions); keys count when ``pos >= 0``, within the
    window, and not after the query.
    """
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    scale = dh ** -0.5
    cache_len = cache.k.shape[2]

    positions = cache.length[:, None]  # [B, 1]
    q, k_new, v_new = _qkv(params, x, positions, cfg)

    slot = (cache.length % cache_len).long()
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, :, slot] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[bidx, :, slot] = v_new[:, :, 0].to(cache.v.dtype)
    cache.pos[bidx, slot] = cache.length

    length = cache.length[:, None]
    valid = cache.pos >= 0  # [B, C]
    if cfg.window is not None:
        valid &= cache.pos > (length - cfg.window)
    valid &= cache.pos <= length

    qg = q.reshape(b, hkv, g, 1, dh).transpose(1, 2)
    out = _sdpa(qg, cache.k, cache.v, valid[:, None, None, None, :], scale)
    out = out.transpose(1, 2).reshape(b, h, 1, dh)
    y = torch.einsum("bhsk,hkd->bsd", out.to(x.dtype),
                     params["wo"].to(x.dtype))
    cache.length.add_(1)
    return y
