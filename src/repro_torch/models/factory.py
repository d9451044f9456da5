"""Model factory: ``build(cfg, device)`` -> a ``ModelBundle``.

Port of ``repro/models/factory.py`` for serving: ``init`` (parameters
from an explicit ``torch.Generator``), ``prefill`` (full-sequence forward
-> last-position logits + decode caches, ``:158``), ``decode`` (one token
-> greedy next token + caches, ``:211``) and ``cache_len``. ``prefill``
takes the batch dict of every family (``_embed_inputs``, ``:51``):
``tokens``; a VLM's ``tokens`` and ``patches``; an audio model's
``frames`` and ``mask`` (the encoder's prefill: its caches are never
decoded). The decode caches are stacked over layers (``k``/``v`` [L, B,
Hkv, C, Dh] bf16, ``pos`` [L, B, C], ``length`` [L, B]), the JAX
package's layout (which keeps a ``first_dense`` model's layer 0 apart):
a ``KVCache``, hymba's ``HybridCache`` (the ``KVCache`` and its layers'
mamba states) or xLSTM's ``XlstmCache`` (its states, which are its
caches); ``decode`` updates them IN PLACE.

``loss_fn`` and ``train_step`` come with the training slice (ROADMAP
Queue 1 item 16.4). Everything runs on ``device`` ("cuda" unless the
caller asks for the CPU, as the tests do); without a card a CUDA bundle
raises.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import module as mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.layers.mamba import MambaState
from repro_torch.models.layers.xlstm import MlstmState, SlstmState

__all__ = ["ModelBundle", "build"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    decls: dict
    init: Callable            # generator -> Transformer
    prefill: Callable         # (params, batch) -> (logits_last, caches)
    decode: Callable          # (params, caches, tokens) -> (next, caches)
    cache_len: Callable       # context_len -> decode cache slots


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: build(cfg, device='cpu') to run "
                           "on the CPU")
    return device


def _init(generator: torch.Generator, *, decls, cfg, device):
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, model on {device}")
    return tfm.Transformer(mod.init_params(decls, generator, device), cfg)


def _embed_inputs(params, batch, cfg):
    """(x [B, S, D] bf16, positions [S]) for a full-sequence pass
    (``factory.py:51``): an audio model's frames through ``frame_proj``,
    ``mask_embed`` where masked; a VLM's patches through the projector
    (GeLU, tanh form as ``jax.nn.gelu``'s default), placed before the
    token embeddings, positions over both; else the tokens."""
    device = params.embed.device

    def get(name):
        return torch.as_tensor(batch[name], device=device)

    if cfg.audio_frontend:
        x = get("frames").to(torch.bfloat16) @ params.frame_proj.to(
            torch.bfloat16)
        x = torch.where(get("mask")[..., None],
                        params.mask_embed.to(x.dtype), x)
    elif cfg.vlm_patches:
        tok_emb = tfm.embed_tokens(params, get("tokens"), cfg)
        proj = params.projector
        p = get("patches").to(torch.bfloat16)
        p = F.gelu(p @ proj.w1.to(torch.bfloat16), approximate="tanh")
        p = p @ proj.w2.to(torch.bfloat16)
        x = torch.cat([p, tok_emb], dim=1)
    else:
        x = tfm.embed_tokens(params, get("tokens"), cfg)
    return x, torch.arange(x.shape[1], device=device)


@torch.no_grad()
def _prefill(params, batch, cfg):
    """Full-context forward; returns (last-position logits [B, 1, V] bf16,
    decode caches)."""
    x, positions = _embed_inputs(params, batch, cfg)
    h, entries, _ = tfm.forward_full(params, x, positions, cfg,
                                     collect_cache=True)
    logits = tfm.logits_from_hidden(params, h[:, -1:], cfg)
    if cfg.family == "ssm":
        return logits, _xlstm_cache(entries)
    return logits, _to_decode_cache(entries, cfg, x.shape[1])


def _xlstm_cache(entries) -> tfm.XlstmCache:
    """Each group's (mLSTM states, sLSTM state) -> the stacked cache."""
    return tfm.XlstmCache(
        mlstm=MlstmState(*(torch.stack([torch.stack([getattr(st, f)
                                                     for st in m])
                                        for m, _ in entries])
                           for f in MlstmState._fields)),
        slstm=SlstmState(*(torch.stack([getattr(s, f) for _, s in entries])
                           for f in SlstmState._fields)))


def _to_decode_cache(entries, cfg, s: int):
    """Prefill K/V of every layer -> the stacked decode cache
    (``factory.py:176``), layer 0 first (JAX keeps a ``first_dense``
    model's layer 0 apart, ``(caches0, stacked)``; ``core.convert`` maps
    between the two). With a window shorter than the prompt the cache is
    a rolling buffer: keep the last ``window`` positions, then roll so
    that position ``p`` sits in slot ``p % window``, as decode writes.
    Without a window it holds exactly the prompt's S slots, as JAX's
    does: the first decode step writes slot ``S % S = 0`` and so evicts
    position 0 (the reference's rule, copied). hymba's final mamba
    states ride beside it (a ``HybridCache``).

    The roll is ``start % window`` forward. JAX's (``factory.py:189``)
    rolls the other way, which is the same only when S is a multiple of
    the window; otherwise its first decode step overwrites a key inside
    the window instead of the oldest one. The port puts each position in
    slot ``p % window``, so prefill + decode equals a full pass at any S
    (``tests/test_torch_llm_families.py``)."""
    clen = tfm._attn_cache_len(cfg, s)
    start = s - clen
    k = torch.stack([e["k"][:, :, start:] for e in entries])  # [L,B,Hkv,C,Dh]
    v = torch.stack([e["v"][:, :, start:] for e in entries])
    pos_lin = torch.arange(start, s, dtype=torch.int32, device=k.device)
    if clen < s:
        roll = start % clen
        k = torch.roll(k, roll, dims=3)
        v = torch.roll(v, roll, dims=3)
        pos_lin = torch.roll(pos_lin, roll)
    n_layers, b = k.shape[0], k.shape[1]
    kv = KVCache(
        k=k.to(torch.bfloat16).contiguous(),
        v=v.to(torch.bfloat16).contiguous(),
        pos=pos_lin.expand(n_layers, b, clen).contiguous(),
        length=torch.full((n_layers, b), s, dtype=torch.int32,
                          device=k.device))
    if "mamba" not in entries[0]:
        return kv
    return tfm.HybridCache(kv=kv, mamba=MambaState(
        *(torch.stack([getattr(e["mamba"], f) for e in entries])
          for f in MambaState._fields)))


@torch.no_grad()
def _decode(params, caches, tokens, cfg):
    """tokens [B, 1] -> (next token [B, 1] i32, caches updated in place)."""
    x = tfm.embed_tokens(params, tokens, cfg)
    h, caches = tfm.decode_step(params, x, cfg, caches)
    logits = tfm.logits_from_hidden(params, h, cfg)[..., : cfg.vocab]
    return torch.argmax(logits, dim=-1).to(torch.int32), caches


def build(cfg: ArchConfig, device="cuda") -> ModelBundle:
    decls = tfm.model_decl(cfg)   # raises for an unknown family
    device = _device(device)
    return ModelBundle(
        cfg=cfg,
        device=device,
        decls=decls,
        init=partial(_init, decls=decls, cfg=cfg, device=device),
        prefill=partial(_prefill, cfg=cfg),
        decode=partial(_decode, cfg=cfg),
        cache_len=partial(tfm._attn_cache_len, cfg),
    )
