"""Model factory: ``build(cfg, device)`` -> a ``ModelBundle``.

Port of ``repro/models/factory.py``: ``init`` (parameters from an
explicit ``torch.Generator``), ``loss_fn`` (family-aware: LM next-token
CE, VLM text-region CE, audio masked prediction, ``:94``),
``train_step`` (gradient-accumulation microbatches + AdamW, ``:123``),
``prefill`` (full-sequence forward -> last-position logits + decode
caches, ``:158``), ``decode`` (one token -> greedy next token + caches,
``:211``), ``cache_len``, and for the dry-run and the sharding rules
``input_specs`` / ``input_axes`` (``:225-259``: one batch of an
``InputShape`` as ``(shape, torch dtype)`` pairs and its logical axes)
and ``cache_decls`` (the decode cache's declarations). Every step takes
the batch dict of its family (``_embed_inputs``, ``:51``): ``tokens``; a
VLM's ``tokens`` and ``patches``; an audio model's ``frames``, ``mask``
and, to train, ``targets`` (an encoder's prefill caches are never
decoded). The decode caches are stacked over layers (``k``/``v`` [L, B,
Hkv, C, Dh] bf16, ``pos`` [L, B, C], ``length`` [L, B]), the JAX package's layout (which
keeps a ``first_dense`` model's layer 0 apart): a ``KVCache``, hymba's
``HybridCache`` (the ``KVCache`` and its layers' mamba states) or
xLSTM's ``XlstmCache`` (its states, which are its caches); ``decode``
updates them IN PLACE.

Training updates the model's parameters IN PLACE (``optim.adamw``):
``train_step`` returns the model it was given. Its gradients come from
``torch.autograd.grad`` over every parameter (an unused one, such as an
audio model's token ``embed``, gets zeros, as in JAX), the attention's
through ``layers.attention.SwaAttention``. Everything runs on ``device``
("cuda" unless the caller asks for the CPU, as the tests do); without a
card a CUDA bundle raises.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import module as mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.layers.mamba import MambaState
from repro_torch.models.layers.xlstm import MlstmState, SlstmState
from repro_torch.optim import adamw_update

__all__ = ["ModelBundle", "build"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    decls: dict
    init: Callable            # generator -> Transformer
    loss_fn: Callable         # (params, batch) -> (loss, metrics)
    train_step: Callable      # (params, opt, batch, step, micro) -> ...
    prefill: Callable         # (params, batch) -> (logits_last, caches)
    decode: Callable          # (params, caches, tokens) -> (next, caches)
    cache_len: Callable       # context_len -> decode cache slots
    input_specs: Callable     # (shape) -> {name: (shape, torch dtype)}
    input_axes: Callable      # (shape) -> {name: logical-axes tuple}
    cache_decls: Callable     # (batch, context_len, seq_shard) -> decls


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
    device = params.head.device

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


def _nll(logits, targets, mask, vocab: int):
    """(sum of the masked CE, the mask's count), f32, over a padded-vocab
    logit tensor (``factory.py:82``): the pad columns at -1e30."""
    logits = logits.float()
    if logits.shape[-1] > vocab:
        logits = logits.index_fill(-1, torch.arange(
            vocab, logits.shape[-1], device=logits.device), -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum(), mask.sum()


def _loss(params, batch, cfg, *, total=None):
    """``factory.py:94``: (total = ce + 0.01 * aux, {"ce", "aux"}), ce the
    mean over the mask's positions. ``total`` (a sharded step's): the
    count of the whole batch from this rank's (its sum over the ranks),
    so that the rank's ce is its share of the whole batch's mean."""
    x, positions = _embed_inputs(params, batch, cfg)
    h, _, aux = tfm.forward_full(params, x, positions, cfg)
    logits = tfm.logits_from_hidden(params, h, cfg)
    device = logits.device

    if cfg.audio_frontend:
        mask = torch.as_tensor(batch["mask"], device=device).float()
        targets = torch.as_tensor(batch["targets"], device=device)
        nll, count = _nll(logits, targets, mask, cfg.vocab)
    else:
        toks = torch.as_tensor(batch["tokens"], device=device)
        # A VLM's text region follows its patches.
        text = logits[:, cfg.vlm_patches:-1]
        nll, count = _nll(text, toks[:, 1:], torch.ones(
            toks[:, 1:].shape, dtype=torch.float32, device=device), cfg.vocab)
    if total is not None:
        count = total(count.detach())
    loss = nll / torch.clamp(count, min=1.0)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


def _split(x, n: int, i: int):
    """Microbatch ``i`` of ``n``: rows ``[i * b / n, (i + 1) * b / n)``
    (JAX's reshape to ``[n, b / n, ...]``)."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} in {n} microbatches")
    return x[i * (b // n):(i + 1) * (b // n)]


def _train_step(params, opt, batch, step, cfg, *, microbatches: int = 1,
                peak_lr=3e-4):
    """``factory.py:123``: gradients over every parameter (summed in f32
    over ``microbatches`` and divided), then one AdamW step at ``lr =
    peak_lr`` (the trainer feeds the schedule there; ``step`` is unused,
    as in JAX). Updates ``params`` and ``opt`` IN PLACE; returns
    (params, opt, metrics): ``loss``, ``gnorm`` and, from the loss,
    ``ce`` and ``aux`` (with microbatches: the mean loss and 0). Every
    metric is a 0-d tensor on the device: nothing is read on the host."""
    leaves = list(params.parameters())

    def grads_of(b):
        loss, metrics = _loss(params, b, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), metrics, list(grads)

    if microbatches == 1:
        loss, metrics, grads = grads_of(batch)
        metrics = {k: t.detach() for k, t in metrics.items()}
    else:
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(microbatches):
            mb = {k: _split(x, microbatches, i) for k, x in batch.items()}
            mb_loss, _, mb_grads = grads_of(mb)
            torch._foreach_add_(grads, mb_grads)
            loss = loss + mb_loss
            del mb_grads
        torch._foreach_div_(grads, float(microbatches))
        loss = loss / microbatches
        metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
    params, opt, gnorm = adamw_update(grads, opt, params, lr=peak_lr)
    return params, opt, dict(metrics, loss=loss, gnorm=gnorm)


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


def _input_arrays(cfg, shape: InputShape):
    """(specs, axes) for one global batch of ``shape``
    (``factory.py:225``): ``{name: (shape, torch dtype)}`` and ``{name:
    logical axes}``."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return ({"tokens": ((b, 1), torch.int32)},
                {"tokens": ("batch", "seq")})
    if cfg.audio_frontend:
        return ({"frames": ((b, s, cfg.d_frame), torch.float32),
                 "mask": ((b, s), torch.bool),
                 "targets": ((b, s), torch.int32)},
                {"frames": ("batch", "seq", None),
                 "mask": ("batch", "seq"),
                 "targets": ("batch", "seq")})
    if cfg.vlm_patches:
        return ({"tokens": ((b, s - cfg.vlm_patches), torch.int32),
                 "patches": ((b, cfg.vlm_patches, cfg.vlm_d_vision),
                             torch.float32)},
                {"tokens": ("batch", "seq"),
                 "patches": ("batch", "seq", None)})
    return {"tokens": ((b, s), torch.int32)}, {"tokens": ("batch", "seq")}


def build(cfg: ArchConfig, device="cuda") -> ModelBundle:
    decls = tfm.model_decl(cfg)   # raises for an unknown family
    device = _device(device)
    return ModelBundle(
        cfg=cfg,
        device=device,
        decls=decls,
        init=partial(_init, decls=decls, cfg=cfg, device=device),
        loss_fn=partial(_loss, cfg=cfg),
        train_step=partial(_train_step, cfg=cfg),
        prefill=partial(_prefill, cfg=cfg),
        decode=partial(_decode, cfg=cfg),
        cache_len=partial(tfm._attn_cache_len, cfg),
        input_specs=lambda shape: _input_arrays(cfg, shape)[0],
        input_axes=lambda shape: _input_arrays(cfg, shape)[1],
        cache_decls=partial(tfm.cache_decls, cfg),
    )
