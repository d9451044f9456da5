"""End-to-end S&R streaming pipeline (paper Figure 1/2).

Port of ``repro/core/pipeline.py``: ``StreamConfig`` (:49) with the same
fields and ``bucket_capacity`` plus a ``device``, ``StreamResult`` (:88),
``init_states`` (:178) and ``run_stream`` (:188). ``run_stream`` runs
the device loop of ``core/engine.py`` with one of two workers:

  * ``backend="cuda"`` (alias ``"pallas"``, the JAX package's name) —
    the kernel worker, ``disgd.make_cuda_worker``;
  * ``backend="scan"`` — the eager reference worker,
    ``disgd.disgd_worker_step``, inside the same loop.

What later slices of the port bring raises ``ValueError`` naming the
slice: the ``host`` and ``shard_map`` backends, forgetting policies,
drift control and storage policies. ``telemetry`` is accepted; the
result's ``telemetry`` is ``None`` until the observability slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import routing
from repro_torch.core.evaluator import RecallAccumulator

__all__ = ["StreamConfig", "StreamResult", "init_states", "run_stream"]

_BACKENDS = {"cuda": "cuda", "pallas": "cuda", "scan": "scan"}
_LATER = {
    "host": "the host-loop slice (ROADMAP Queue 1, after this slice)",
    "shard_map": "the multi-GPU slice (ROADMAP Queue 1 item 14)",
}


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    # Registry key into repro_torch.core.algorithm.
    algorithm: str = "disgd"
    grid: routing.GridSpec = routing.GridSpec(1, 0)
    micro_batch: int = 2048
    capacity_factor: float = 2.0             # bucket capacity vs fair share
    forgetting: Any = None                   # None / policy "none" only
    hyper: Any = None                        # DisgdHyper (caps etc.)
    seed: int = 0
    record_every: int = 4                    # occupancy snapshot cadence
    backend: str = "cuda"                    # "cuda" (= "pallas") | "scan"
    carry_slots: int = 0                     # overflow re-queue size (0 = micro_batch)
    drift: Any = None                        # not in this slice
    telemetry: bool = True                   # accepted; no counters yet
    storage: Any = None                      # not in this slice
    device: str = "cuda"

    def resolved_hyper(self):
        h = self.hyper
        if h is None:
            h = algorithm_lib.get_algorithm(self.algorithm).default_hyper()
        return h._replace(n_i=self.grid.n_i, g=self.grid.g)

    @property
    def bucket_capacity(self) -> int:
        fair = self.micro_batch / self.grid.n_c
        return max(8, int(np.ceil(fair * self.capacity_factor)))


@dataclasses.dataclass
class StreamResult:
    """What one ``run_stream`` call measured and produced."""

    recall: RecallAccumulator
    user_occupancy: list      # [(events_processed, np[n_c])]
    item_occupancy: list
    events_processed: int
    dropped: int
    wall_seconds: float
    load_history: list        # per-batch worker loads (skew diagnostics)
    # Final worker states [n_c, ...] on cfg.device: the input to the
    # serving plane (repro_torch.serve.plane.grid_topn).
    final_states: Any = None
    forgets: int = 0
    drift_flags: Any = None
    final_detector: Any = None
    telemetry: Any = None     # None until the observability slice

    @property
    def throughput(self) -> float:
        return self.events_processed / max(self.wall_seconds, 1e-9)

    def occupancy_summary(self):
        """Mean per-worker live entries at end of stream (paper's metric)."""
        u = self.user_occupancy[-1][1] if self.user_occupancy else np.zeros(1)
        i = self.item_occupancy[-1][1] if self.item_occupancy else np.zeros(1)
        return {
            "user_mean": float(np.mean(u)), "user_max": int(np.max(u)),
            "item_mean": float(np.mean(i)), "item_max": int(np.max(i)),
            "user_total": int(np.sum(u)), "item_total": int(np.sum(i)),
        }


def init_states(cfg: StreamConfig):
    """Zero states of every worker, stacked ``[n_c, ...]`` on cfg.device."""
    return algorithm_lib.get_algorithm(cfg.algorithm).init_state(
        cfg.resolved_hyper(), batch=(cfg.grid.n_c,), device=cfg.device)


def _resolve_backend(cfg: StreamConfig) -> str:
    if cfg.backend in _LATER:
        raise ValueError(f"backend={cfg.backend!r} is not ported yet; it "
                         f"comes with {_LATER[cfg.backend]}")
    if cfg.backend not in _BACKENDS:
        raise ValueError(f"unknown backend {cfg.backend!r}; ported: "
                         f"{sorted(_BACKENDS)}")
    policy = getattr(cfg.forgetting, "policy", cfg.forgetting)
    if policy not in (None, "none"):
        raise ValueError(f"forgetting policy {policy!r} is not ported yet; "
                         "it comes with the forgetting and drift slice "
                         "(ROADMAP Queue 1 item 9)")
    if cfg.drift is not None:
        raise ValueError("drift control is not ported yet; it comes with "
                         "the forgetting and drift slice (ROADMAP Queue 1 "
                         "item 9)")
    if cfg.storage is not None:
        raise ValueError("storage policies are not ported yet; they come "
                         "with the storage slice (ROADMAP Queue 1 item 11)")
    return _BACKENDS[cfg.backend]


def run_stream(users: np.ndarray, items: np.ndarray, cfg: StreamConfig,
               initial_states=None,
               initial_carry=(None, None)) -> StreamResult:
    """Run the full prequential stream; returns curves + paper metrics.

    ``initial_states``/``initial_carry`` resume mid-stream (for example
    from ``core.convert.states_from_numpy``); the states must be shaped
    for ``cfg.grid`` and are updated in place.
    """
    from repro_torch.core import engine

    backend = _resolve_backend(cfg)
    return engine.run_stream_device(
        np.asarray(users), np.asarray(items), cfg, backend,
        initial_states=initial_states, initial_carry=initial_carry)
