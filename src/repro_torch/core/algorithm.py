"""Registry of streaming-recommender algorithms: DISGD, DICS and plugins.

Port of the registry in ``repro/core/algorithm.py``: ``register`` (:161),
``get_algorithm`` (:174), ``registered`` (:191), ``infer_algorithm``
(:196) and the two in-tree algorithms ``DisgdAlgorithm`` /
``DicsAlgorithm`` (:242-308), with the regrid / checkpoint hooks of
JAX's base class (:135-153: ``extract_logical``, ``build_states``,
``state_template``) on a shared base, ``Algorithm``. Plugins
(BPR-MF, ``repro_torch/algos``) register themselves when that package
is imported, which ``repro_torch/__init__.py`` does eagerly. The engine,
the pipeline and the serving plane look an algorithm up by its
``StreamConfig.algorithm`` key here and call its hooks; nothing outside
this module compares algorithm names.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import dics as dics_lib
from repro_torch.core import disgd as disgd_lib
from repro_torch.core import serve as serve_lib
from repro_torch.core import state as state_lib

__all__ = ["Algorithm", "DisgdAlgorithm", "DicsAlgorithm", "register",
           "get_algorithm", "registered", "infer_algorithm"]


class Algorithm:
    """The hooks every registered algorithm shares: regrid and the
    checkpoint schema, over the public state containers (``core/state``).
    Override them only for a state of another shape."""

    name = ""

    def extract_logical(self, states, grid, storage=None, workers=None):
        """Stacked ``[n_c, ...]`` states -> grid-portable ``LogicalState``
        (``workers``: the grid's workers the stack holds, default all)."""
        from repro_torch.core import regrid as regrid_lib

        return regrid_lib.extract_logical(states, grid, storage=storage,
                                          workers=workers)

    def build_states(self, logical, *, src, dst, u_cap: int, i_cap: int,
                     merge: str = "fresh", storage=None, workers=None,
                     relations=None):
        """``LogicalState`` -> stacked states for the target grid
        (``workers``: the destination's workers to build, default all;
        ``relations``: ``rated`` and ``co`` as live entries)."""
        from repro_torch.core import regrid as regrid_lib

        return regrid_lib.build_states(logical, src=src, dst=dst,
                                       u_cap=u_cap, i_cap=i_cap, merge=merge,
                                       storage=storage, workers=workers,
                                       relations=relations)

    def state_template(self, hyper, storage=None):
        """One worker's checkpoint schema in ``storage``'s resident
        encoding: a state of ``meta`` tensors (shapes and dtypes, nothing
        allocated on any device)."""
        from repro_torch.core import storage as storage_lib

        return storage_lib.encode_template(
            self.init_state(hyper, device="meta"), storage)


class DisgdAlgorithm(Algorithm):
    """DISGD — distributed incremental SGD matrix factorization (Alg. 2)."""

    name = "disgd"

    def default_hyper(self) -> disgd_lib.DisgdHyper:
        return disgd_lib.DisgdHyper()

    def init_state(self, hyper, *, batch: tuple = (), device="cuda",
                   storage=None):
        """Zero state of ``batch`` workers, in ``storage``'s encoding."""
        return state_lib.init_disgd_state(hyper.u_cap, hyper.i_cap, hyper.k,
                                          batch=batch, device=device,
                                          storage=storage)

    def make_worker_step(self, hyper, key: torch.Tensor) -> Callable:
        """The eager reference worker (``backend="scan"``)."""
        def step(state, events):
            return disgd_lib.disgd_worker_step(state, events, hyper, key)

        return step

    def make_cuda_worker_step(self, hyper, key: torch.Tensor) -> Callable:
        """The kernel worker (``backend="cuda"``)."""
        return disgd_lib.make_cuda_worker(hyper, key)

    def make_serve_leaf(self, *, top_n: int, g: int, u_cap: int, k_nn: int,
                        use_kernel: bool, storage=None) -> Callable:
        """``leaf(states, user_ids[W, B]) -> (ids, scores, known)``: every
        worker's partial top-N over its own item split. ``k_nn`` is a DICS
        knob and is ignored; ``storage`` is the states' resident policy
        (the leaf decodes the gathered rows only)."""
        del k_nn

        def leaf(states, user_ids):
            return serve_lib.partial_topn(states, user_ids, top_n=top_n, g=g,
                                          u_cap=u_cap, use_kernel=use_kernel,
                                          storage=storage)

        return leaf


class DicsAlgorithm(Algorithm):
    """DICS — distributed incremental item-based cosine CF (Alg. 3)."""

    name = "dics"

    def default_hyper(self) -> dics_lib.DicsHyper:
        return dics_lib.DicsHyper()

    def init_state(self, hyper, *, batch: tuple = (), device="cuda",
                   storage=None):
        """Zero state of ``batch`` workers, in ``storage``'s encoding."""
        return state_lib.init_dics_state(hyper.u_cap, hyper.i_cap,
                                         batch=batch, device=device,
                                         storage=storage)

    def make_worker_step(self, hyper, key: torch.Tensor) -> Callable:
        """The eager reference worker (``backend="scan"``). DICS draws no
        random numbers: ``key`` is unused."""
        del key

        def step(state, events):
            return dics_lib.dics_worker_step(state, events, hyper)

        return step

    def make_cuda_worker_step(self, hyper, key: torch.Tensor) -> Callable:
        """The kernel worker (``backend="cuda"``)."""
        del key
        return dics_lib.make_cuda_worker(hyper)

    def make_serve_leaf(self, *, top_n: int, g: int, u_cap: int, k_nn: int,
                        use_kernel: bool, storage=None) -> Callable:
        """``leaf(states, user_ids[W, B]) -> (ids, scores, known)``: the
        Eq. 6/7 partial top-N of every worker's item split; ``storage``
        is the states' resident policy."""
        def leaf(states, user_ids):
            return dics_lib.dics_partial_topn(
                states, user_ids, top_n=top_n, k_nn=k_nn, g=g, u_cap=u_cap,
                use_kernel=use_kernel, storage=storage)

        return leaf


_REGISTRY: dict = {}


def register(algo):
    """Register an algorithm instance under ``algo.name`` (latest wins);
    returns it."""
    if not getattr(algo, "name", ""):
        raise ValueError(f"{type(algo).__name__} has no name")
    _REGISTRY[algo.name] = algo
    return algo


def get_algorithm(name: str):
    """Resolve a registry key to its algorithm."""
    algo = _REGISTRY.get(name)
    if algo is None:
        raise KeyError(f"no registered algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)}. Plug one in via "
                       "repro_torch.core.algorithm.register(...)")
    return algo


def registered() -> tuple[str, ...]:
    """Registered algorithm names (plugins included), sorted."""
    return tuple(sorted(_REGISTRY))


def infer_algorithm(states) -> str:
    """The canonical registry key of a bare state's container (``"dics"``
    for ``DicsState``, ``"disgd"`` for ``DisgdState``); callers that know
    better (the session) pass the key themselves."""
    if isinstance(states, state_lib.DicsState):
        return "dics"
    if isinstance(states, state_lib.DisgdState):
        return "disgd"
    raise TypeError(f"cannot infer an algorithm for {type(states)}; "
                    "pass algorithm=... explicitly")


register(DisgdAlgorithm())
register(DicsAlgorithm())
