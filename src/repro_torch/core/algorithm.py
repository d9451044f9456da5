"""Registry of streaming-recommender algorithms: DISGD, DICS and plugins.

Port of the registry in ``repro/core/algorithm.py``: ``register`` (:161),
``get_algorithm`` (:174), ``registered`` (:191) and the two in-tree
algorithms ``DisgdAlgorithm`` / ``DicsAlgorithm`` (:242-308). Plugins
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

__all__ = ["DisgdAlgorithm", "DicsAlgorithm", "register", "get_algorithm",
           "registered"]


class DisgdAlgorithm:
    """DISGD — distributed incremental SGD matrix factorization (Alg. 2)."""

    name = "disgd"

    def default_hyper(self) -> disgd_lib.DisgdHyper:
        return disgd_lib.DisgdHyper()

    def init_state(self, hyper, *, batch: tuple = (), device="cuda"):
        """Zero state of ``batch`` workers."""
        return state_lib.init_disgd_state(hyper.u_cap, hyper.i_cap, hyper.k,
                                          batch=batch, device=device)

    def make_worker_step(self, hyper, key: torch.Tensor) -> Callable:
        """The eager reference worker (``backend="scan"``)."""
        def step(state, events):
            return disgd_lib.disgd_worker_step(state, events, hyper, key)

        return step

    def make_cuda_worker_step(self, hyper, key: torch.Tensor) -> Callable:
        """The kernel worker (``backend="cuda"``)."""
        return disgd_lib.make_cuda_worker(hyper, key)

    def make_serve_leaf(self, *, top_n: int, g: int, u_cap: int, k_nn: int,
                        use_kernel: bool) -> Callable:
        """``leaf(states, user_ids[W, B]) -> (ids, scores, known)``: every
        worker's partial top-N over its own item split. ``k_nn`` is a DICS
        knob and is ignored."""
        del k_nn

        def leaf(states, user_ids):
            return serve_lib.partial_topn(states, user_ids, top_n=top_n, g=g,
                                          u_cap=u_cap, use_kernel=use_kernel)

        return leaf


class DicsAlgorithm:
    """DICS — distributed incremental item-based cosine CF (Alg. 3)."""

    name = "dics"

    def default_hyper(self) -> dics_lib.DicsHyper:
        return dics_lib.DicsHyper()

    def init_state(self, hyper, *, batch: tuple = (), device="cuda"):
        """Zero state of ``batch`` workers."""
        return state_lib.init_dics_state(hyper.u_cap, hyper.i_cap,
                                         batch=batch, device=device)

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
                        use_kernel: bool) -> Callable:
        """``leaf(states, user_ids[W, B]) -> (ids, scores, known)``: the
        Eq. 6/7 partial top-N of every worker's item split."""
        def leaf(states, user_ids):
            return dics_lib.dics_partial_topn(
                states, user_ids, top_n=top_n, k_nn=k_nn, g=g, u_cap=u_cap,
                use_kernel=use_kernel)

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


register(DisgdAlgorithm())
register(DicsAlgorithm())
