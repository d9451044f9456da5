"""The decoder stack, dense and MoE families (port of
``repro/models/transformer.py`` :47-318).

A block is ``ln -> attention -> ln -> FFN``, with residuals; the FFN is a
SwiGLU (dense) or ``moe_apply`` (MoE, with its load-balance aux loss).
A ``first_dense`` MoE model (moonshot) has a dense layer 0 whose SwiGLU
is ``d_expert * 4`` wide (``transformer.py:99``), held apart as JAX's
``layer0``. The stack is a ``ModuleList`` of blocks, layer 0 first, run
in a Python loop (the JAX package scans over stacked layer parameters;
PyTorch runs eagerly, so there is nothing to gain from a scan here).
Parameters keep the JAX layouts and f32 type and are cast to bf16 at
each use, as the JAX model casts them.

Other families (hybrid/mamba, xLSTM, VLM, audio) raise
``NotImplementedError``: they come with ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import module as mod
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers.mlp import swiglu, swiglu_decl
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_decl
from repro_torch.models.module import ParamDecl

__all__ = ["model_decl", "Transformer", "embed_tokens", "logits_from_hidden",
           "forward_full", "decode_step", "check_family"]

PORTED_FAMILIES = ("dense", "moe")


def check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP Queue 1 item 16)")


def _block_decl(cfg, dense_ff: int | None = None) -> dict:
    """One block; an MoE model's blocks hold ``moe`` unless ``dense_ff``
    asks for a SwiGLU of that width (the ``first_dense`` layer 0)."""
    d = {"ln1": rmsnorm_decl(cfg.d_model), "attn": attn_lib.attn_decl(cfg),
         "ln2": rmsnorm_decl(cfg.d_model)}
    if cfg.family == "moe" and dense_ff is None:
        d["moe"] = moe_lib.moe_decl(cfg)
    else:
        d["mlp"] = swiglu_decl(cfg.d_model, dense_ff or cfg.d_ff)
    return d


def model_decl(cfg) -> dict:
    """The JAX declaration tree (``transformer.py:81``), layers stacked;
    a ``first_dense`` model's layer 0 is ``layer0``, outside the stack."""
    check_family(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    decl = {
        "embed": ParamDecl((v, d), scale=1.0),
        "final_norm": rmsnorm_decl(d),
        "head": ParamDecl((d, v)),
    }
    n_stacked = cfg.n_layers
    if cfg.moe is not None and cfg.moe.first_dense:
        decl["layer0"] = _block_decl(cfg, dense_ff=cfg.moe.d_expert * 4)
        n_stacked -= 1
    decl["layers"] = mod.stacked(_block_decl(cfg), n_stacked)
    return decl


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """A nested parameter dict in the JAX layout (one layer's ``ln1/scale``,
    ``attn/{wq,wk,wv,wo}``, ``ln2/scale``, ``mlp/{w_gate,w_up,w_down}`` or
    ``moe/{router,w_gate,w_up,w_down,shared?}``): leaves are frozen
    Parameters, dicts sub-trees, read as ``tree.name`` or ``tree["name"]``."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, _frozen(value))

    def __getitem__(self, name: str):
        return getattr(self, name)


class Transformer(nn.Module):
    """Embedding, a ``ModuleList`` of blocks, final norm and head."""

    def __init__(self, tree: dict, cfg):
        """``tree`` holds the JAX parameter layout with layers stacked
        ``[L, ...]`` (and a ``first_dense`` model's ``layer0``); each
        block's parameters are views of one layer."""
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = _frozen(tree["embed"])
        self.head = _frozen(tree["head"])
        self.final_norm = ParamTree(tree["final_norm"])

        def layer(tree_l, i):
            return {k: layer(v, i) if isinstance(v, dict) else v[i]
                    for k, v in tree_l.items()}

        first = [tree["layer0"]] if "layer0" in tree else []
        self.layers = nn.ModuleList(ParamTree(t) for t in first + [
            layer(tree["layers"], i)
            for i in range(cfg.n_layers - len(first))])


def embed_tokens(params, tokens, cfg):
    """``transformer.py:124``: rows of the embedding, in bf16 (the JAX
    model casts the table, then gathers: the same values)."""
    return params.embed[tokens].to(torch.bfloat16)


def logits_from_hidden(params, x, cfg):
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params.head.to(x.dtype))


def _ffn(lp, xn, cfg):
    """The block's feed-forward: (output, aux loss or None)."""
    if hasattr(lp, "moe"):
        return moe_lib.moe_apply(lp.moe, xn, cfg)
    return swiglu(lp.mlp, xn), None


def _block_full(lp, x, positions, cfg):
    """One block over the full sequence. Returns (x, {"k", "v"}, aux)."""
    xn = rmsnorm(lp.ln1, x, cfg.norm_eps)
    attn_out, (k, v) = attn_lib.attention(lp.attn, xn, positions, cfg)
    x = x + attn_out
    ff, aux = _ffn(lp, rmsnorm(lp.ln2, x, cfg.norm_eps), cfg)
    return x + ff, {"k": k, "v": v}, aux


def forward_full(params, x, positions, cfg, *, collect_cache: bool = False):
    """Run the stack over a full sequence (``transformer.py:196``).

    Returns (hidden, entries, aux_sum): ``entries`` is the list of each
    layer's ``{"k", "v"}`` [B, Hkv, S, Dh] (layer 0 first) when
    ``collect_cache`` (prefill), else None; ``aux_sum`` the f32 sum of
    the MoE layers' load-balance losses (0 for the dense family). Each
    layer launches ``ops.swa_attention`` once.
    """
    entries = [] if collect_cache else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, e, aux = _block_full(lp, x, positions, cfg)
        if aux is not None:
            aux_sum = aux_sum + aux
        if collect_cache:
            entries.append(e)
    return x, entries, aux_sum


def _block_decode(lp, x, cfg, cache: attn_lib.KVCache):
    """``transformer.py:236``: an MoE block routes the step's B tokens
    as one group, whose capacity drops none of them."""
    xn = rmsnorm(lp.ln1, x, cfg.norm_eps)
    x = x + attn_lib.decode_attention(lp.attn, xn, cache, cfg)
    ff, _ = _ffn(lp, rmsnorm(lp.ln2, x, cfg.norm_eps), cfg)
    return x + ff


def decode_step(params, x, cfg, caches: attn_lib.KVCache):
    """One-token decode through the stack (``transformer.py:287``).
    x [B, 1, D]; ``caches`` stacked over all layers ([L, ...] leaves,
    layer 0 first), updated IN PLACE. Returns (x, caches)."""
    for i, lp in enumerate(params.layers):
        x = _block_decode(lp, x, cfg, attn_lib.KVCache(*(t[i] for t in caches)))
    return x, caches


def _attn_cache_len(cfg, context_len: int) -> int:
    if cfg.window is not None:
        return min(cfg.window, context_len)
    return context_len
