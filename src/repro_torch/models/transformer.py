"""The decoder stack, dense family (port of ``repro/models/transformer.py``
:124-318).

A block is ``ln -> attention -> ln -> SwiGLU``, with residuals; the stack
is a ``ModuleList`` of blocks run in a Python loop (the JAX package scans
over stacked layer parameters; PyTorch runs eagerly, so there is nothing
to gain from a scan here). Parameters keep the JAX layouts and f32 type
and are cast to bf16 at each use, as the JAX model casts them.

Other families (MoE, hybrid/mamba, xLSTM, VLM, audio) raise
``NotImplementedError``: they come with ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import module as mod
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.mlp import swiglu, swiglu_decl
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_decl
from repro_torch.models.module import ParamDecl

__all__ = ["model_decl", "Transformer", "embed_tokens", "logits_from_hidden",
           "forward_full", "decode_step", "check_family"]


def check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP Queue 1 item 16)")


def _block_decl(cfg) -> dict:
    return {"ln1": rmsnorm_decl(cfg.d_model), "attn": attn_lib.attn_decl(cfg),
            "ln2": rmsnorm_decl(cfg.d_model),
            "mlp": swiglu_decl(cfg.d_model, cfg.d_ff)}


def model_decl(cfg) -> dict:
    """The JAX declaration tree (``transformer.py:81``), layers stacked."""
    check_family(cfg)
    v, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": ParamDecl((v, d), scale=1.0),
        "final_norm": rmsnorm_decl(d),
        "head": ParamDecl((d, v)),
        "layers": mod.stacked(_block_decl(cfg), cfg.n_layers),
    }


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _param_dict(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in tree.items()})


class Block(nn.Module):
    """One layer's parameters, in the JAX layouts: ``ln1/scale``,
    ``attn/{wq,wk,wv,wo}``, ``ln2/scale``, ``mlp/{w_gate,w_up,w_down}``."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in ("ln1", "attn", "ln2", "mlp"):
            setattr(self, name, _param_dict(tree[name]))


class Transformer(nn.Module):
    """Embedding, a ``ModuleList`` of blocks, final norm and head."""

    def __init__(self, tree: dict, cfg):
        """``tree`` holds the JAX parameter layout with layers stacked
        ``[L, ...]``; each block's parameters are views of one layer."""
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = _frozen(tree["embed"])
        self.head = _frozen(tree["head"])
        self.final_norm = _param_dict(tree["final_norm"])
        layers = tree["layers"]

        def layer(tree_l, i):
            return {k: layer(v, i) if isinstance(v, dict) else v[i]
                    for k, v in tree_l.items()}

        self.layers = nn.ModuleList(
            Block(layer(layers, i)) for i in range(cfg.n_layers))


def embed_tokens(params, tokens, cfg):
    """``transformer.py:124``: rows of the embedding, in bf16 (the JAX
    model casts the table, then gathers: the same values)."""
    return params.embed[tokens].to(torch.bfloat16)


def logits_from_hidden(params, x, cfg):
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params.head.to(x.dtype))


def _block_full(lp, x, positions, cfg):
    """One block over the full sequence. Returns (x, {"k", "v"})."""
    xn = rmsnorm(lp.ln1, x, cfg.norm_eps)
    attn_out, (k, v) = attn_lib.attention(lp.attn, xn, positions, cfg)
    x = x + attn_out
    xn = rmsnorm(lp.ln2, x, cfg.norm_eps)
    return x + swiglu(lp.mlp, xn), {"k": k, "v": v}


def forward_full(params, x, positions, cfg, *, collect_cache: bool = False):
    """Run the stack over a full sequence (``transformer.py:220``).

    Returns (hidden, entries): ``entries`` is the list of each layer's
    ``{"k", "v"}`` [B, Hkv, S, Dh] when ``collect_cache`` (prefill), else
    None. Each layer launches ``ops.swa_attention`` once.
    """
    entries = [] if collect_cache else None
    for lp in params.layers:
        x, e = _block_full(lp, x, positions, cfg)
        if collect_cache:
            entries.append(e)
    return x, entries


def _block_decode(lp, x, cfg, cache: attn_lib.KVCache):
    xn = rmsnorm(lp.ln1, x, cfg.norm_eps)
    x = x + attn_lib.decode_attention(lp.attn, xn, cache, cfg)
    xn = rmsnorm(lp.ln2, x, cfg.norm_eps)
    return x + swiglu(lp.mlp, xn)


def decode_step(params, x, cfg, caches: attn_lib.KVCache):
    """One-token decode through the stack (``transformer.py:287``).
    x [B, 1, D]; ``caches`` stacked over layers ([L, ...] leaves), updated
    IN PLACE. Returns (x, caches)."""
    for i, lp in enumerate(params.layers):
        x = _block_decode(lp, x, cfg, attn_lib.KVCache(*(t[i] for t in caches)))
    return x, caches


def _attn_cache_len(cfg, context_len: int) -> int:
    if cfg.window is not None:
        return min(cfg.window, context_len)
    return context_len
