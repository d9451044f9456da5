"""The sharded program: a rank's blocks of the model, gathered where used.

JAX shards its step by GSPMD, a compiler pass; the port runs the plain
PyTorch counterpart (fully sharded data parallel) over a mesh bound to a
process group (``ctx.bind_mesh``), with JAX's layout:

* At rest, each rank holds the block of every parameter, and of AdamW's
  ``m`` and ``v``, that ``specs.param_specs`` gives its coordinates
  (:func:`shard_model`: each whole tensor is drawn, sliced and dropped,
  one at a time, so a rank's blocks equal the one-process model's).
* A unit's parameters are gathered when it runs (``ctx.gather``: an
  all-gather per sharded dim): each block of the stack (an xLSTM group),
  a :class:`Unit` in the step's view of the model, inside
  ``transformer``'s block functions, so that remat's recompute gathers
  again; the embedding, head, final norm and a VLM's projector (an audio
  model's frame projection) once a step. The whole tensors are freed
  after use.
* The batch is split over the batch axes (``("pod", "data")``, or an
  override's), contiguous rows; activations and caches are whole on
  every rank of a batch block.
* Each gradient is reduce-scattered back to its block (summed over the
  batch axes).

The step's mathematics is JAX's unsharded step: the loss the mean over
the whole batch (the count summed over the ranks: hubert's span mask and
phi-3's text region give ranks other counts), the clip by the global
gradient norm (each element counted once: a block replicated over some
axes is counted by the rank at coordinate 0 of those axes), and MoE
groups, capacity and aux loss those of the whole batch
(``layers.moe.moe_apply``, handed the step's ``ctx.BatchShard`` by the
block's gathered view). Tensor-parallel compute (heads, ff or
experts split over ``model``) is not done: the ranks of a batch block
compute the same activations.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core import convert
from repro_torch.models import factory
from repro_torch.models import module as mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_update
from repro_torch.sharding import ctx
from repro_torch.sharding import specs as specs_lib

__all__ = ["Gathered", "Unit", "shard_model", "shard_bytes",
           "resident_bytes", "batch_layout", "local_batch", "train_step",
           "prefill", "decode", "gathered_state"]


class Gathered(dict):
    """A unit's whole parameters, read as ``tree.name`` or
    ``tree["name"]`` (the compute's view of a ``ParamTree``)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def _lookup(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def shard_model(cfg, mesh, *, generator=None, params=None, device=None,
                overrides=None) -> tfm.Transformer:
    """This rank's model: a ``Transformer`` over its blocks of the
    parameters (``mesh``'s coordinates of the rank). With ``generator``,
    the blocks of ``init_params``'s draws (every whole tensor is drawn in
    the same order, sliced, and dropped); with ``params`` (the JAX
    layout's tree of numpy arrays, as ``convert.params_from_numpy``
    takes), the blocks of those; with neither, uninitialised blocks (the
    dry-run's)."""
    decls = tfm.model_decl(cfg)
    specs = specs_lib.param_specs(decls, mesh, overrides)
    coords = ctx.rank_coords(mesh)
    device = torch.device(device if device is not None else
                          generator.device if generator is not None
                          else "cpu")
    tree: dict = {}
    for path, d in mod._leaves(decls):
        keys = path.split("/")
        spec = _lookup(specs, keys)
        index = specs_lib.shard_slices(spec, d.shape, mesh, coords)
        if params is not None:
            block = torch.tensor(np.asarray(_lookup(params, keys),
                                            np.float32)[index], device=device)
        elif generator is not None:
            whole = mod.materialize(d, generator, device)
            block = whole[index].clone()
            del whole
        else:
            block = torch.empty(specs_lib.local_shape(spec, d.shape, mesh),
                                dtype=mod.torch_dtype(d.dtype), device=device)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = block
    model = tfm.Transformer(tree, cfg)
    for p, (path, idx) in zip(model.parameters(), convert._paths(model)):
        p.spec = specs_lib.PartitionSpec(*_lookup(specs, path)[len(idx):])
    model.mesh, model.overrides = mesh, overrides
    return model


def _gather_module(module: nn.Module, shard: ctx.BatchShard):
    """A unit's parameters whole (under autograd), in its tree; their
    gradients are summed over ``shard``'s batch axes."""
    if isinstance(module, nn.ModuleList):
        return [_gather_module(m, shard) for m in module]
    out = Gathered({n: ctx.gather(p, p.spec, shard.mesh, shard.axes)
                    for n, p in module.named_parameters(recurse=False)})
    for n, child in module.named_children():
        out[n] = _gather_module(child, shard)
    return out


class Unit:
    """A block of the stack (an xLSTM group) in a step's view of the
    model: ``gather()`` (``transformer._unit`` calls it when the block
    runs) returns its parameters whole, with ``batch`` the step's
    ``ctx.BatchShard``."""

    def __init__(self, module: nn.Module, shard: ctx.BatchShard):
        self.module, self.shard = module, shard

    def gather(self) -> Gathered:
        out = _gather_module(self.module, self.shard)
        out.batch = self.shard
        return out


def _top(model, axes):
    """The model as the compute reads it in a step whose batch is split
    over ``axes``: the embedding (unless an audio model's, which is
    unused), head, final norm and a VLM's projector or an audio model's
    frame projection and mask embedding gathered; the units (a
    :class:`Unit` each) gather themselves when they run."""
    cfg = model.cfg
    shard = ctx.BatchShard(model.mesh, tuple(axes))
    view = Gathered()
    for name, child in model.named_children():
        if name in ("layers", "groups"):
            view[name] = [Unit(u, shard) for u in child]
        else:
            view[name] = _gather_module(child, shard)
    for name, p in model.named_parameters(recurse=False):
        if name == "embed" and cfg.audio_frontend:
            continue
        view[name] = ctx.gather(p, p.spec, shard.mesh, shard.axes)
    return view


def shard_bytes(cfg, mesh, overrides=None) -> int:
    """Bytes of one rank's parameter blocks (the model's declarations at
    the rank's local shapes)."""
    decls = tfm.model_decl(cfg)
    specs = specs_lib.param_specs(decls, mesh, overrides)
    total = 0
    for path, d in mod._leaves(decls):
        shape = specs_lib.local_shape(_lookup(specs, path.split("/")),
                                      d.shape, mesh)
        total += int(np.prod(shape)) * mod.torch_dtype(d.dtype).itemsize
    return total


def resident_bytes(model, opt=None) -> int:
    """Bytes this rank holds of the parameters (and AdamW's ``m``, ``v``)."""
    ts = list(model.parameters())
    if opt is not None:
        ts += list(opt.m) + list(opt.v)
    return sum(t.numel() * t.element_size() for t in ts)


def batch_layout(mesh, batch: int, overrides=None):
    """(batch axes, this rank's rows) of a batch of ``batch`` rows: the
    axes ``ACT_RULES`` give its ``"batch"`` dim (none when ``batch`` does
    not split), contiguous blocks in block order."""
    entry = specs_lib.resolve_spec(("batch",), (batch,), mesh,
                                   specs_lib.ACT_RULES, overrides)[0]
    n, i = specs_lib.block_index(entry, mesh, ctx.rank_coords(mesh))
    return specs_lib.entry_axes(entry), slice(i * batch // n,
                                              (i + 1) * batch // n)


def local_batch(batch: dict, mesh, device, overrides=None):
    """(this rank's rows of ``batch`` as tensors on ``device``, the batch
    axes)."""
    b = next(iter(batch.values())).shape[0]
    axes, rows = batch_layout(mesh, b, overrides)
    return {k: v[rows].to(device, copy=True) if torch.is_tensor(v)
            else torch.as_tensor(v[rows], device=device)
            for k, v in batch.items()}, axes


def _loss(model, batch, cfg, axes):
    mesh = model.mesh
    return factory._loss(_top(model, axes), batch, cfg, total=lambda c: (
        ctx.all_reduce(c, axes, mesh)))


def _grads(model, leaves, batch, cfg, axes):
    """(loss, metrics, gradient blocks) of this rank's rows ``batch``
    (split over ``axes``)."""
    loss, metrics = _loss(model, batch, cfg, axes)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), metrics, list(grads)


def _global_norm(model, grads):
    """The gradients' norm over every element of the whole model: the
    sum of squares of the blocks this rank owns (coordinate 0 of every
    axis its spec does not split), summed over the mesh."""
    mesh = model.mesh
    coords = ctx.rank_coords(mesh)
    owned = [g for p, g in zip(model.parameters(), grads)
             if all(coords[a] == 0 for a in mesh.axis_names
                    if a not in specs_lib.spec_axes(p.spec))]
    sq = (torch.stack(torch._foreach_norm(owned)) ** 2).sum() if owned \
        else grads[0].new_zeros((), dtype=torch.float32)
    return torch.sqrt(ctx.all_reduce(sq.float(), mesh.axis_names, mesh))


def train_step(model, opt, batch, step, cfg, *, microbatches: int = 1,
               peak_lr=3e-4):
    """``factory._train_step`` on this rank's blocks. ``batch`` is the
    WHOLE batch (numpy or tensors; every rank builds the same): split
    into ``microbatches`` of contiguous rows as JAX does, each split over
    the batch axes. Updates the blocks and ``opt`` IN PLACE; returns
    (model, opt, metrics): ``loss``, ``gnorm``, ``ce`` and ``aux`` of
    the whole batch, on every rank."""
    mesh, overrides = model.mesh, model.overrides
    leaves = list(model.parameters())
    device = leaves[0].device
    grads, loss = None, torch.zeros((), dtype=torch.float32, device=device)
    for i in range(microbatches):
        mb = {k: factory._split(x, microbatches, i) for k, x in batch.items()}
        local, axes = local_batch(mb, mesh, device, overrides)
        mb_loss, metrics, mb_grads = _grads(model, leaves, local, cfg, axes)
        if grads is None:
            grads = mb_grads
        else:
            torch._foreach_add_(grads, mb_grads)
        loss = loss + mb_loss
        del mb_grads
    if microbatches > 1:
        torch._foreach_div_(grads, float(microbatches))
        loss = loss / microbatches
        parts = torch.stack([loss, torch.zeros_like(loss)])
    else:
        parts = torch.stack([loss, metrics["ce"].detach(),
                             metrics["aux"].detach()])
    parts = ctx.all_reduce(parts, axes, mesh)
    gnorm = _global_norm(model, grads)
    model, opt, _ = adamw_update(grads, opt, model, lr=peak_lr, gnorm=gnorm)
    ce, aux = (parts[0], parts[1]) if microbatches > 1 else parts[1:]
    return model, opt, {"loss": parts[0], "ce": ce, "aux": aux,
                        "gnorm": gnorm}


def prefill(model, batch, cfg, axes):
    """``factory._prefill`` of this rank's rows ``batch`` (split over
    ``axes``): (last-position logits, decode caches) of those rows."""
    return factory._prefill(_top(model, axes), batch, cfg)


def decode(model, caches, tokens, cfg, axes):
    """``factory._decode`` of this rank's rows: tokens [b, 1] and their
    caches (updated in place)."""
    return factory._decode(_top(model, axes), caches, tokens, cfg)


@torch.no_grad()
def gathered_state(model, opt=None) -> dict:
    """The whole ``{"params", "opt"}`` tree in the JAX layout (numpy, as
    ``convert.params_to_numpy`` / ``opt_to_numpy`` give the one-process
    model's), gathered on every rank (each must call it)."""
    mesh = model.mesh
    params = list(model.parameters())

    def whole(ts):
        return [ctx.gather_full(t.detach(), p.spec, mesh)
                for t, p in zip(ts, params)]

    out = {"params": convert._to_tree(model, whole(params))}
    if opt is not None:
        out["opt"] = {"m": convert._to_tree(model, whole(opt.m)),
                      "v": convert._to_tree(model, whole(opt.v)),
                      "count": np.asarray(convert._host(opt.count),
                                          np.int32)}
    return out
