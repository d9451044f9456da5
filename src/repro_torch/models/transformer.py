"""Decoder and encoder stacks for the architecture zoo (port of
``repro/models/transformer.py`` :47-352).

One block grammar covers the six families:

  dense / vlm / audio : ln -> attention -> ln -> (swiglu | gelu) FFN
  moe                 : ln -> attention -> ln -> MoE (+ shared experts)
  hybrid (hymba)      : ln -> [attention ∥ mamba], mixed as
                        0.5 * (attn * beta_attn + mamba * beta_mamba)
                        -> ln -> swiglu FFN
  ssm (xlstm)         : groups of (p - 1) mLSTM blocks + 1 sLSTM block

The audio family (hubert) takes layer norms and a GeLU MLP, every other
family RMS norms. A ``first_dense`` MoE model (moonshot) has a dense
layer 0 whose SwiGLU is ``d_expert * 4`` wide (``transformer.py:99``),
held apart as JAX's ``layer0``. A VLM model also holds the patch
``projector`` and an audio model ``frame_proj`` and ``mask_embed``
(``models/factory.py`` uses them). The stack is a ``ModuleList`` of
blocks, layer 0 first (xLSTM: a ``ModuleList`` of groups), run in a
Python loop (the JAX package scans over stacked layer parameters;
PyTorch runs eagerly, so there is nothing to gain from a scan here).
Parameters keep the JAX layouts and f32 type and are cast to bf16 at
each use, as the JAX model casts them.

Decode caches, stacked over layers and updated IN PLACE by
``decode_step``: a ``KVCache`` (dense, MoE, VLM); a ``HybridCache`` (the
``KVCache`` and the layers' ``MambaState``s); an ``XlstmCache`` (every
group's mLSTM and sLSTM states, JAX's nested ``groups`` layout).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import module as mod
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import mamba as mamba_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import xlstm as xlstm_lib
from repro_torch.models.layers.mlp import (gelu_mlp, gelu_mlp_decl, swiglu,
                                           swiglu_decl)
from repro_torch.models.layers.norms import (layernorm, layernorm_decl,
                                             rmsnorm, rmsnorm_decl)
from repro_torch.models.module import ParamDecl

__all__ = ["model_decl", "Transformer", "embed_tokens", "logits_from_hidden",
           "forward_full", "decode_step", "check_family", "HybridCache",
           "XlstmCache", "cache_decls"]

PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


class HybridCache(NamedTuple):
    """hymba's decode cache: the rolling K/V buffer and each layer's mamba
    state, leaves stacked [L, ...] (JAX: ``k, v, pos, length, mamba``)."""
    kv: attn_lib.KVCache
    mamba: mamba_lib.MambaState


class XlstmCache(NamedTuple):
    """xLSTM's decode cache: mLSTM states [G, p - 1, B, ...] and sLSTM
    states [G, B, D] (JAX: ``{"mlstm": {c, n}, "slstm": {c, n, h}}``
    stacked over groups)."""
    mlstm: xlstm_lib.MlstmState
    slstm: xlstm_lib.SlstmState


def check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"known: {PORTED_FAMILIES}")


def _norm_decl(cfg):
    return (layernorm_decl if cfg.family == "audio" else rmsnorm_decl)(
        cfg.d_model)


def _norm(cfg):
    return layernorm if cfg.family == "audio" else rmsnorm


def _block_decl(cfg, dense_ff: int | None = None) -> dict:
    """One block; an MoE model's blocks hold ``moe`` unless ``dense_ff``
    asks for a SwiGLU of that width (the ``first_dense`` layer 0)."""
    d = {"ln1": _norm_decl(cfg), "attn": attn_lib.attn_decl(cfg),
         "ln2": _norm_decl(cfg)}
    if cfg.family == "moe" and dense_ff is None:
        d["moe"] = moe_lib.moe_decl(cfg)
    elif cfg.family == "audio":
        d["mlp"] = gelu_mlp_decl(cfg.d_model, cfg.d_ff)
    else:
        d["mlp"] = swiglu_decl(cfg.d_model, dense_ff or cfg.d_ff)
    if cfg.family == "hybrid":
        d["mamba"] = mamba_lib.mamba_decl(cfg)
        d["beta_attn"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
        d["beta_mamba"] = ParamDecl((cfg.d_model,), ("embed",),
                                     init="ones")
    return d


def _xlstm_group_decl(cfg) -> dict:
    p = cfg.xlstm.slstm_period
    one_m = {"ln": rmsnorm_decl(cfg.d_model), "cell": xlstm_lib.mlstm_decl(cfg)}
    one_s = {"ln": rmsnorm_decl(cfg.d_model), "cell": xlstm_lib.slstm_decl(cfg)}
    return {"mlstm": mod.stacked(one_m, p - 1, "layers"), "slstm": one_s}


def model_decl(cfg) -> dict:
    """The JAX declaration tree (``transformer.py:81``), layers stacked;
    a ``first_dense`` model's layer 0 is ``layer0``, outside the stack;
    xLSTM's groups stacked with their mLSTM blocks stacked inside."""
    check_family(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    decl = {
        "embed": ParamDecl((v, d), ("vocab", "embed"), scale=1.0),
        "final_norm": _norm_decl(cfg),
        "head": ParamDecl((d, v), ("embed", "vocab")),
    }
    if cfg.family == "ssm":
        p = cfg.xlstm.slstm_period
        if cfg.n_layers % p:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers in groups "
                             f"of {p}")
        decl["groups"] = mod.stacked(_xlstm_group_decl(cfg),
                                     cfg.n_layers // p, "layers")
        return decl
    n_stacked = cfg.n_layers
    if cfg.moe is not None and cfg.moe.first_dense:
        decl["layer0"] = _block_decl(cfg, dense_ff=cfg.moe.d_expert * 4)
        n_stacked -= 1
    decl["layers"] = mod.stacked(_block_decl(cfg), n_stacked, "layers")
    if cfg.vlm_patches:
        decl["projector"] = {
            "w1": ParamDecl((cfg.vlm_d_vision, d), (None, "embed")),
            "w2": ParamDecl((d, d), ("embed", None))}
    if cfg.audio_frontend:
        decl["frame_proj"] = ParamDecl((cfg.d_frame, d), (None, "embed"))
        decl["mask_embed"] = ParamDecl((d,), ("embed",), init="normal",
                                       scale=0.02)
    return decl


class ParamTree(nn.Module):
    """A nested parameter dict in the JAX layout (one layer's ``ln1``,
    ``attn/{wq,wk,wv,wo}``, ``ln2``, ``mlp``, ``moe``, ``mamba``,
    ``beta_*``, or an xLSTM block's ``ln`` and ``cell``): leaves are
    trainable Parameters over the given tensors' storage (a layer's
    leaf is a view of the stacked tensor, so an in-place update writes
    the stack), dicts sub-trees, read as ``tree.name`` or
    ``tree["name"]``. Serving runs under ``torch.no_grad``
    (``factory._prefill`` / ``_decode``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: views of every leaf's row ``i``."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class XlstmGroup(nn.Module):
    """One xLSTM group: ``mlstm``, a ``ModuleList`` of p - 1 blocks, then
    ``slstm``."""

    def __init__(self, tree: dict):
        super().__init__()
        n_m = next(iter(tree["mlstm"]["ln"].values())).shape[0]
        self.mlstm = nn.ModuleList(ParamTree(_layer(tree["mlstm"], j))
                                   for j in range(n_m))
        self.slstm = ParamTree(tree["slstm"])


class Transformer(nn.Module):
    """Embedding, the stack, final norm and head, and a VLM's projector
    or an audio model's frame projection and mask embedding."""

    def __init__(self, tree: dict, cfg):
        """``tree`` holds the JAX parameter layout with layers stacked
        ``[L, ...]`` (a ``first_dense`` model's ``layer0`` apart; xLSTM's
        ``groups`` stacked ``[G, ...]``); each block's parameters are
        views of one layer."""
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.head = nn.Parameter(tree["head"])
        self.final_norm = ParamTree(tree["final_norm"])
        if cfg.family == "ssm":
            n_groups = cfg.n_layers // cfg.xlstm.slstm_period
            self.groups = nn.ModuleList(
                XlstmGroup(_layer(tree["groups"], g)) for g in range(n_groups))
            return
        first = [tree["layer0"]] if "layer0" in tree else []
        self.layers = nn.ModuleList(ParamTree(t) for t in first + [
            _layer(tree["layers"], i)
            for i in range(cfg.n_layers - len(first))])
        if "projector" in tree:
            self.projector = ParamTree(tree["projector"])
        if "frame_proj" in tree:
            self.frame_proj = nn.Parameter(tree["frame_proj"])
            self.mask_embed = nn.Parameter(tree["mask_embed"])


def embed_tokens(params, tokens, cfg):
    """``transformer.py:124``: rows of the embedding, in bf16 (the JAX
    model casts the table, then gathers: the same values)."""
    return params.embed[tokens].to(torch.bfloat16)


def logits_from_hidden(params, x, cfg):
    x = _norm(cfg)(params.final_norm, x, cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params.head.to(x.dtype))


def _ffn(lp, xn, cfg):
    """The block's feed-forward: (output, aux loss or None)."""
    if hasattr(lp, "moe"):
        return moe_lib.moe_apply(lp.moe, xn, cfg, getattr(lp, "batch", None))
    if cfg.family == "audio":
        return gelu_mlp(lp.mlp, xn), None
    return swiglu(lp.mlp, xn), None


def _mix(lp, attn_out, mamba_out, x):
    """hymba's per-channel mix of its two branches, in x's type."""
    return 0.5 * (attn_out * lp.beta_attn.to(x.dtype)
                  + mamba_out * lp.beta_mamba.to(x.dtype))


def _unit(tree):
    """A block's (or an xLSTM group's) parameters as the compute reads
    them. In a sharded model's view (``sharding.fsdp``) a unit is a
    ``fsdp.Unit``, whose ``gather`` returns its parameters whole (and the
    step's ``batch`` split, which an MoE block reads); it runs here,
    inside the remat region, so that the backward's recompute gathers
    again."""
    gather = getattr(tree, "gather", None)
    return tree if gather is None else gather()


def _block_full(lp, x, positions, cfg):
    """One block over the full sequence. Returns (x, {"k", "v"} and, for
    hymba, "mamba", aux)."""
    lp = _unit(lp)
    norm = _norm(cfg)
    xn = norm(lp.ln1, x, cfg.norm_eps)
    attn_out, (k, v) = attn_lib.attention(lp.attn, xn, positions, cfg)
    entries = {"k": k, "v": v}
    if cfg.family == "hybrid":
        mamba_out, entries["mamba"] = mamba_lib.mamba_scan(lp.mamba, xn, cfg)
        x = x + _mix(lp, attn_out, mamba_out, x)
    else:
        x = x + attn_out
    ff, aux = _ffn(lp, norm(lp.ln2, x, cfg.norm_eps), cfg)
    return x + ff, entries, aux


def _xlstm_group_full(group, x, cfg):
    """One group over the full sequence (``transformer.py:178``). Returns
    (x, [MlstmState per mLSTM block], SlstmState)."""
    group = _unit(group)
    states = []
    for blk in group.mlstm:
        y, st = xlstm_lib.mlstm_apply(blk.cell, rmsnorm(blk.ln, x,
                                                        cfg.norm_eps), cfg)
        x = x + y
        states.append(st)
    blk = group.slstm
    y, sst = xlstm_lib.slstm_apply(blk.cell, rmsnorm(blk.ln, x, cfg.norm_eps),
                                   cfg)
    return x + y, states, sst


def forward_full(params, x, positions, cfg, *, collect_cache: bool = False):
    """Run the stack over a full sequence (``transformer.py:196``).

    Returns (hidden, entries, aux_sum). With ``collect_cache`` (prefill)
    ``entries`` is the list of each layer's ``{"k", "v"}`` [B, Hkv, S,
    Dh] (layer 0 first; hymba's also ``"mamba"``, its final
    ``MambaState``), or for xLSTM each group's (mLSTM states, sLSTM
    state); else None. ``aux_sum`` is the f32 sum of the MoE layers'
    load-balance losses (0 for the other families). Each attention layer
    launches ``ops.swa_attention`` once. With ``cfg.remat`` and grad
    enabled (training) each block, or each xLSTM group, runs under
    activation checkpointing: its forward runs again in the backward
    pass, so an attention layer launches K7 twice a training step.
    """
    entries = [] if collect_cache else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    if cfg.family == "ssm":
        for group in params.groups:
            if remat:
                x = _checkpoint(_xlstm_group_train, group, x, cfg)
                continue
            x, mstates, sstate = _xlstm_group_full(group, x, cfg)
            if collect_cache:
                entries.append((mstates, sstate))
        return x, entries, aux_sum
    for lp in params.layers:
        if remat:
            x, aux = _checkpoint(_block_train, lp, x, positions, cfg)
        else:
            x, e, aux = _block_full(lp, x, positions, cfg)
            if collect_cache:
                entries.append(e)
        if aux is not None:
            aux_sum = aux_sum + aux
    return x, entries, aux_sum


def _block_train(lp, x, positions, cfg):
    """``_block_full`` without the cache entries: (x, aux)."""
    x, _, aux = _block_full(lp, x, positions, cfg)
    return x, aux


def _xlstm_group_train(group, x, cfg):
    """``_xlstm_group_full`` without the states: x."""
    return _xlstm_group_full(group, x, cfg)[0]


def _checkpoint(fn, *args):
    """``fn(*args)`` with its activations dropped and recomputed in the
    backward pass (``jax.checkpoint``, ``transformer.py:206``, ``:221``):
    the block's forward, K7 included, runs twice a training step. The
    blocks draw no random numbers, so no RNG state is kept."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _copy_state(dst, src) -> None:
    """Write a NamedTuple of tensors into another's, IN PLACE."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _block_decode(lp, x, cfg, cache: attn_lib.KVCache, mamba=None):
    """``transformer.py:236``: an MoE block routes the step's B tokens
    as one group, whose capacity drops none of them; hymba's block steps
    its mamba state (``mamba``, updated in place) beside the attention."""
    lp = _unit(lp)
    norm = _norm(cfg)
    xn = norm(lp.ln1, x, cfg.norm_eps)
    attn_out = attn_lib.decode_attention(lp.attn, xn, cache, cfg)
    if mamba is not None:
        mamba_out, new = mamba_lib.mamba_decode_step(lp.mamba, xn, cfg, mamba)
        _copy_state(mamba, new)
        x = x + _mix(lp, attn_out, mamba_out, x)
    else:
        x = x + attn_out
    ff, _ = _ffn(lp, norm(lp.ln2, x, cfg.norm_eps), cfg)
    return x + ff


def _xlstm_group_decode(group, x, cfg, mlstm, slstm):
    """``transformer.py:266``: one group's step; ``mlstm`` ([p - 1, ...]
    leaves) and ``slstm`` are updated in place."""
    group = _unit(group)
    for j, blk in enumerate(group.mlstm):
        st = xlstm_lib.MlstmState(*(t[j] for t in mlstm))
        y, new = xlstm_lib.mlstm_decode(blk.cell, rmsnorm(blk.ln, x,
                                                          cfg.norm_eps),
                                        cfg, st)
        _copy_state(st, new)
        x = x + y
    blk = group.slstm
    y, new = xlstm_lib.slstm_decode(blk.cell, rmsnorm(blk.ln, x, cfg.norm_eps),
                                    cfg, slstm)
    _copy_state(slstm, new)
    return x + y


def decode_step(params, x, cfg, caches):
    """One-token decode through the stack (``transformer.py:287``).
    x [B, 1, D]; ``caches`` (a ``KVCache``, ``HybridCache`` or
    ``XlstmCache``, stacked over all layers, layer 0 first) updated IN
    PLACE. Returns (x, caches)."""
    if isinstance(caches, XlstmCache):
        for g, group in enumerate(params.groups):
            x = _xlstm_group_decode(
                group, x, cfg, xlstm_lib.MlstmState(*(t[g] for t in
                                                      caches.mlstm)),
                xlstm_lib.SlstmState(*(t[g] for t in caches.slstm)))
        return x, caches
    hybrid = isinstance(caches, HybridCache)
    kv = caches.kv if hybrid else caches
    for i, lp in enumerate(params.layers):
        mamba = (mamba_lib.MambaState(*(t[i] for t in caches.mamba))
                 if hybrid else None)
        x = _block_decode(lp, x, cfg, attn_lib.KVCache(*(t[i] for t in kv)),
                          mamba)
    return x, caches


def _attn_cache_len(cfg, context_len: int) -> int:
    if cfg.window is not None:
        return min(cfg.window, context_len)
    return context_len


def cache_decls(cfg, batch: int, context_len: int, *,
                seq_shard: bool = False):
    """The decode cache's declarations in JAX's tree
    (``transformer.py:320``): xLSTM's group states stacked over groups
    (mLSTM's also over the group's blocks); else ``(cache0, stacked)``,
    ``cache0`` a ``first_dense`` model's layer 0 (or None) and
    ``stacked`` the other layers' ``k``, ``v``, ``pos``, ``length`` (and
    hymba's ``mamba``), stacked. The port's caches stack every layer in
    one ``KVCache`` (``core.convert.caches_from_numpy`` maps one layout to
    the other); each layer's leaves and axes are these."""
    clen = _attn_cache_len(cfg, context_len)
    if cfg.family == "ssm":
        p = cfg.xlstm.slstm_period
        group = {"mlstm": mod.stacked(xlstm_lib.mlstm_state_decl(cfg, batch),
                                      p - 1, "layers"),
                 "slstm": xlstm_lib.slstm_state_decl(cfg, batch)}
        return mod.stacked(group, cfg.n_layers // p, "layers")
    entry = attn_lib.cache_decl(cfg, batch, clen, seq_shard=seq_shard)
    if cfg.family == "hybrid":
        entry["mamba"] = mamba_lib.mamba_state_decl(cfg, batch)
    n_stacked, cache0 = cfg.n_layers, None
    if cfg.moe is not None and cfg.moe.first_dense:
        cache0 = attn_lib.cache_decl(cfg, batch, clen, seq_shard=seq_shard)
        n_stacked -= 1
    return cache0, mod.stacked(entry, n_stacked, "layers")
