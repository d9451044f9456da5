"""Registry of streaming-recommender algorithms (DISGD only, so far).

Port of the registry in ``repro/core/algorithm.py``, modelled on
``DisgdAlgorithm`` (:242-274). The engine, the pipeline and the serving
plane look an algorithm up by its ``StreamConfig.algorithm`` key here and
call its hooks; nothing outside this module compares algorithm names.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import disgd as disgd_lib
from repro_torch.core import serve as serve_lib
from repro_torch.core import state as state_lib

__all__ = ["DisgdAlgorithm", "get_algorithm"]


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

    def make_serve_leaf(self, *, top_n: int, g: int, u_cap: int,
                        use_kernel: bool) -> Callable:
        """``leaf(states, user_ids[W, B]) -> (ids, scores, known)``: every
        worker's partial top-N over its own item split."""
        def leaf(states, user_ids):
            return serve_lib.partial_topn(states, user_ids, top_n=top_n, g=g,
                                          u_cap=u_cap, use_kernel=use_kernel)

        return leaf


_REGISTRY = {algo.name: algo for algo in (DisgdAlgorithm(),)}


def get_algorithm(name: str):
    """Resolve a registry key to its algorithm."""
    algo = _REGISTRY.get(name)
    if algo is None:
        raise KeyError(f"no registered algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)} (BPR and DICS come in later "
                       "slices of the port)")
    return algo
