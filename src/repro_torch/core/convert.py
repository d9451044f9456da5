"""Carry state across the JAX package and this one.

The recommender has no model weights: its trained state is its
parameters. These helpers move that state as a flat mapping of numpy arrays keyed by
the JAX ``DisgdState`` / ``DicsState`` / ``Tables`` field names — what
``jax.tree.map(np.asarray, result.final_states)`` gives, flattened with
``flatten_state``. The container is picked by its fields: a ``co`` leaf
means DICS. Shapes carry over unchanged (one worker, or stacked
``[n_c, ...]``), and so do the storage policies' encoded leaves
(``core.storage``): packed ``rated`` (uint32), quantized ``co`` (uint16
or int8) with its ``co_scale``, and bf16 tables. The DICS ``co_scale``
is ``None`` in compute form and then absent from the mapping. numpy has
no bfloat16 of its own: ``states_to_numpy`` gives a bf16 table as its
uint16 bit pattern, and ``states_from_numpy`` takes either that (a
uint16 factor table, or a uint16 ``co`` without ``co_scale``) or JAX's
``ml_dtypes`` bfloat16 arrays, moved through a uint16 view.

For the LM zoo, ``params_from_numpy`` builds the port's model from the
JAX parameter pytree mapped to numpy, whatever its family: layers
stacked ``[L, ...]``, an MoE block's ``moe/shared``, a ``first_dense``
model's ``layer0``, hymba's ``mamba/*`` and ``beta_*``, xLSTM's nested
``groups`` (``[G, p - 1, ...]`` mLSTM and ``[G, ...]`` sLSTM leaves), a
VLM's ``projector/{w1,w2}``, an audio model's ``frame_proj``,
``mask_embed`` and layer norms' ``scale`` and ``bias``.
``params_to_numpy`` gives the model back in that layout (layers stacked
again: the model's leaves are per-layer views), and ``opt_to_numpy`` /
``opt_from_numpy`` move the AdamW state (``{"m", "v", "count"}``, the
moments in the parameters' layout), so a checkpoint of the port's
training reads in the JAX package and the other way round.
``caches_from_numpy`` / ``caches_to_numpy`` move a decode cache both
ways, so a JAX prefill can feed the port's decode: JAX's ``(caches0,
stacked)`` pair (``caches0`` a ``first_dense`` model's layer 0, else
``None``; each ``{"k", "v", "pos", "length"}``, hymba's with
``"mamba": {"ssm", "conv"}``, ``stacked`` over the other layers) against
the port's one ``KVCache`` (or ``HybridCache``) over all layers; and
xLSTM's ``{"mlstm": {"c", "n"}, "slstm": {"c", "n", "h"}}`` stacked over
groups against its ``XlstmCache``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.state import DicsState, DisgdState, Tables
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.layers.mamba import MambaState
from repro_torch.models.layers.xlstm import MlstmState, SlstmState
from repro_torch.models.transformer import (HybridCache, Transformer,
                                            XlstmCache)
from repro_torch.optim import AdamWState

__all__ = ["flatten_state", "to_tensor", "states_from_numpy",
           "states_to_numpy", "params_from_numpy", "params_to_numpy",
           "opt_from_numpy", "opt_to_numpy", "caches_from_numpy",
           "caches_to_numpy"]

_HEAVY = {DisgdState: ("user_vecs", "item_vecs", "rated"),
          DicsState: ("co", "item_cnt", "rated", "co_scale")}
_FACTORS = ("user_vecs", "item_vecs")
# Leaf dtypes a storage policy stores, carried as they are.
_ENCODED = (torch.uint32, torch.uint16, torch.int8, torch.bfloat16)


def _container(fields) -> type:
    return DicsState if "co" in fields else DisgdState


def flatten_state(state) -> dict:
    """Any ``DisgdState``- or ``DicsState``-shaped tuple (this package's,
    or the JAX package's mapped to numpy) -> ``{field name: leaf}``; a
    ``None`` ``co_scale`` is left out."""
    heavy = _HEAVY[_container(state._fields)]
    out = {**state.tables._asdict(),
           **{name: getattr(state, name, None) for name in heavy}}
    return {k: v for k, v in out.items() if v is not None}


def to_tensor(x, device="cuda") -> torch.Tensor:
    """A numpy array (or a tensor) as a tensor on ``device``, its dtype
    kept; numpy bfloat16 (``ml_dtypes``) arrives as ``torch.bfloat16``."""
    if torch.is_tensor(x):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x)).to(device)


def states_from_numpy(mapping: Mapping[str, np.ndarray], device="cuda"):
    """Build this package's ``DisgdState`` or ``DicsState`` from numpy
    leaves (compute form or a storage policy's encoding)."""
    quantized = "co_scale" in mapping

    def leaf(name):
        t = to_tensor(mapping[name], device)
        if name in Tables._fields:
            return t.to(torch.int32)
        if t.dtype == torch.uint16 and (name in _FACTORS or not quantized):
            return t.view(torch.bfloat16)          # bf16 bits
        if t.dtype in _ENCODED:
            return t
        if name == "rated":
            return t.to(torch.bool)
        return t.to(torch.float32)

    cls = _container(mapping)
    heavy = [name for name in _HEAVY[cls] if name in mapping]
    return cls(Tables(*(leaf(f) for f in Tables._fields)),
               *(leaf(name) for name in heavy))


def states_to_numpy(state) -> dict:
    """The reverse: ``{field name: numpy array}`` on the host (copies,
    never views of the live tensors); a bf16 table as its uint16 bits."""
    def host(t):
        t = t.detach().to("cpu", copy=True)
        return (t.view(torch.uint16) if t.dtype == torch.bfloat16
                else t).numpy()

    return {name: host(t) for name, t in flatten_state(state).items()}


def params_from_numpy(tree: Mapping, cfg, device="cuda"):
    """The JAX parameter pytree as nested dicts of numpy arrays -> the
    port's ``Transformer`` on ``device`` (f32, the JAX layouts)."""
    def leaf(x):
        if isinstance(x, Mapping):
            return {k: leaf(v) for k, v in x.items()}
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    return Transformer(leaf(tree), cfg)


def _jax_path(name: str, first_dense: bool) -> tuple[tuple, tuple]:
    """A ``Transformer`` parameter's dotted name -> (its key path in the
    JAX tree, its index in the stacked leaf): ``layers.i.*`` ->
    ``layers/*[i]`` (``layer0/*`` and ``layers/*[i - 1]`` for a
    ``first_dense`` model), ``groups.g.mlstm.j.*`` -> ``groups/mlstm/*[g,
    j]``, ``groups.g.slstm.*`` -> ``groups/slstm/*[g]``; the rest as it
    is."""
    parts = name.split(".")
    if parts[0] == "layers":
        i, rest = int(parts[1]), tuple(parts[2:])
        if first_dense:
            return (("layer0",) + rest, ()) if i == 0 else \
                (("layers",) + rest, (i - 1,))
        return ("layers",) + rest, (i,)
    if parts[0] == "groups":
        g = int(parts[1])
        if parts[2] == "mlstm":
            return ("groups", "mlstm") + tuple(parts[4:]), (g, int(parts[3]))
        return ("groups", "slstm") + tuple(parts[3:]), (g,)
    return tuple(parts), ()


def _paths(model: Transformer) -> list:
    """``_jax_path`` of each parameter, in ``model.parameters()`` order."""
    moe = model.cfg.moe
    first_dense = moe is not None and moe.first_dense
    return [_jax_path(n, first_dense) for n, _ in model.named_parameters()]


def _to_tree(model: Transformer, values) -> dict:
    """Per-parameter tensors (aligned with ``model.parameters()``) ->
    the JAX tree of f32 numpy arrays, stacked leaves rebuilt."""
    groups: dict = {}
    for (path, idx), t in zip(_paths(model), values):
        groups.setdefault(path, []).append((idx, _host(t)))
    tree: dict = {}
    for path, items in groups.items():
        if items[0][0]:
            shape = tuple(max(i[d] for i, _ in items) + 1
                          for d in range(len(items[0][0])))
            leaf = np.empty(shape + items[0][1].shape, np.float32)
            for i, a in items:
                leaf[i] = a
        else:
            leaf = items[0][1]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _from_tree(model: Transformer, tree, device) -> list:
    """The JAX tree -> one f32 tensor per parameter, in
    ``model.parameters()`` order."""
    out = []
    for path, idx in _paths(model):
        node = tree
        for key in path:
            node = node[key]
        out.append(torch.tensor(np.asarray(node, dtype=np.float32)[idx],
                                device=device))
    return out


def params_to_numpy(model: Transformer) -> dict:
    """The port's model -> the JAX parameter pytree as nested dicts of
    f32 numpy arrays (copies), layers stacked ``[L, ...]``."""
    return _to_tree(model, model.parameters())


def opt_to_numpy(opt: AdamWState, model: Transformer) -> dict:
    """The AdamW state of ``model`` -> JAX's ``opt._asdict()``: ``m`` and
    ``v`` in the parameters' layout, ``count`` an int32 scalar."""
    return {"m": _to_tree(model, opt.m), "v": _to_tree(model, opt.v),
            "count": np.asarray(_host(opt.count), np.int32)}


def opt_from_numpy(tree: Mapping, model: Transformer,
                   device="cuda") -> AdamWState:
    """JAX's ``{"m", "v", "count"}`` (numpy) -> the ``AdamWState`` of
    ``model`` on ``device``."""
    return AdamWState(
        m=_from_tree(model, tree["m"], device),
        v=_from_tree(model, tree["v"], device),
        count=torch.tensor(np.asarray(tree["count"]), dtype=torch.int32,
                           device=device))


_CACHE_DTYPES = {"k": torch.bfloat16, "v": torch.bfloat16,
                 "pos": torch.int32, "length": torch.int32}


def caches_from_numpy(tree, device="cuda"):
    """JAX's decode cache as numpy arrays -> the port's: ``(caches0,
    stacked)`` (``k``/``v`` any float type) -> the stacked ``KVCache``,
    a ``caches0`` (a ``first_dense`` model's layer 0) becoming layer 0,
    and a ``HybridCache`` where ``stacked`` holds ``mamba``; xLSTM's
    group states -> an ``XlstmCache``. The recurrent states keep JAX's
    types (f32, and the conv history in bf16 after a prefill)."""
    if isinstance(tree, Mapping):
        return XlstmCache(
            mlstm=MlstmState(*(to_tensor(tree["mlstm"][f], device)
                               for f in MlstmState._fields)),
            slstm=SlstmState(*(to_tensor(tree["slstm"][f], device)
                               for f in SlstmState._fields)))
    caches0, stacked = tree

    def leaf(f):
        t = np.asarray(stacked[f], dtype=np.float32 if f in ("k", "v")
                       else np.int32)
        if caches0 is not None:
            t = np.concatenate([np.asarray(caches0[f], dtype=t.dtype)[None],
                                t])
        return torch.tensor(t, device=device).to(_CACHE_DTYPES[f])

    kv = KVCache(**{f: leaf(f) for f in _CACHE_DTYPES})
    if "mamba" not in stacked:
        return kv
    return HybridCache(kv=kv, mamba=MambaState(
        *(to_tensor(stacked["mamba"][f], device)
          for f in MambaState._fields)))


def _host(t) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.is_floating_point() else t).numpy()


def caches_to_numpy(caches, *, first_dense: bool = False):
    """The port's decode cache -> JAX's, numpy arrays on the host (floats
    as float32): a ``KVCache`` -> ``(caches0, stacked)`` of ``{"k", "v",
    "pos", "length"}`` (``caches0`` layer 0 with ``first_dense``, else
    None); a ``HybridCache`` -> ``(None, stacked)`` with ``"mamba":
    {"ssm", "conv"}``; an ``XlstmCache`` -> ``{"mlstm": {"c", "n"},
    "slstm": {"c", "n", "h"}}``."""
    if isinstance(caches, XlstmCache):
        return {name: {f: _host(t) for f, t in state._asdict().items()}
                for name, state in caches._asdict().items()}
    kv = caches.kv if isinstance(caches, HybridCache) else caches
    out = {f: _host(getattr(kv, f)) for f in _CACHE_DTYPES}
    if isinstance(caches, HybridCache):
        out["mamba"] = {f: _host(t) for f, t in
                        caches.mamba._asdict().items()}
    if first_dense:
        return ({f: a[0] for f, a in out.items()},
                {f: a[1:] for f, a in out.items()})
    return None, out
