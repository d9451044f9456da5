"""Splitting & Replication routing (paper Algorithm 1), on tensors.

Port of ``repro/core/routing.py``: ``GridSpec`` (:53), ``route_key``
(:96), the capacity-bucketed dispatch ``bucket_dispatch`` (:131) and
its numpy version ``bucket_dispatch_np`` (:164), which the ``host``
loop buckets with.
Every event ``<u, i>`` goes to exactly one of ``n_c = n_i * g`` workers,
``key = (i mod n_i) * g + (u mod g)``; a micro-batch is grouped into
fixed-capacity per-worker buckets, so each worker processes a static
``[capacity]`` slice. Outputs are exactly the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GridSpec", "route_key", "bucket_dispatch", "bucket_dispatch_np"]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The S&R worker grid: ``n_i`` item splits x ``g = n_i + w`` user
    groups (``w = 0`` is the paper's ``n_c = n_i**2``)."""

    n_i: int
    w: int = 0

    @property
    def g(self) -> int:
        """Number of user groups (grid columns)."""
        return self.n_i + self.w

    @property
    def n_c(self) -> int:
        """Total number of workers, ``n_i * g``."""
        return self.n_i * self.g

    @property
    def shape(self) -> tuple[int, int]:
        """(n_i, g): grid rows x columns."""
        return (self.n_i, self.g)

    @classmethod
    def rect(cls, n_i: int, g: int) -> "GridSpec":
        """A grid named by its (item splits, user groups) shape."""
        return cls(n_i=n_i, w=g - n_i)

    def __post_init__(self):
        if self.n_i < 1 or self.g < 1:
            raise ValueError(f"invalid grid: n_i={self.n_i}, w={self.w}")


def route_key(u: torch.Tensor, i: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """Vectorized Algorithm 1: worker key(s) for user/item id tensors."""
    return (i % grid.n_i) * grid.g + (u % grid.g)


def bucket_dispatch(keys: torch.Tensor, n_workers: int, capacity: int):
    """Group a micro-batch of events into fixed-capacity per-worker buckets.

    Args:
      keys: int[B] worker key per event; ``n_workers`` marks an invalid
        event, which takes no capacity and adds no load.
      n_workers / capacity: bucket grid shape.

    Returns:
      buckets: int32[n_workers, capacity] indices into the micro-batch,
        ``-1`` where padded.
      kept: bool[B] False where the event's bucket position is past
        ``capacity`` (True for invalid keys, as in the JAX version; the
        engine ANDs it with validity).
      load: int32[n_workers] per-worker event counts before capacity.

    No host synchronisation: the position of an event in its bucket is
    the exclusive cumsum of same-key predecessors, and overflow scatters
    into a dump slot past the end, which is cut off (JAX's ``mode="drop"``).
    """
    b = keys.shape[0]
    workers = torch.arange(n_workers, device=keys.device, dtype=keys.dtype)
    onehot = (keys[:, None] == workers[None, :]).to(torch.int32)  # [B, W]
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    kept = pos < capacity
    load = onehot.sum(0, dtype=torch.int32)

    size = n_workers * capacity
    slot = keys.to(torch.int64) * capacity + torch.clamp(pos, max=capacity - 1)
    slot = torch.where(kept & (slot < size), slot, size)
    flat = torch.full((size + 1,), -1, dtype=torch.int32, device=keys.device)
    flat[slot] = torch.arange(b, dtype=torch.int32, device=keys.device)
    return flat[:size].reshape(n_workers, capacity), kept, load


def bucket_dispatch_np(keys: np.ndarray, n_workers: int, capacity: int):
    """Host (numpy) version of ``bucket_dispatch`` for the ``host`` loop:
    the same ``(buckets, kept, load)`` for in-range ``keys``, with
    ``kept`` False for every event past its bucket's capacity (the
    caller re-queues those)."""
    keys = np.asarray(keys, dtype=np.int64)
    load = np.bincount(keys, minlength=n_workers).astype(np.int32)
    # Position of each event in its bucket: its rank among same-key
    # events in stream order (a stable sort by key).
    order = np.argsort(keys, kind="stable")
    starts = np.concatenate([[0], np.cumsum(load)[:-1]])
    pos = np.empty(keys.shape[0], dtype=np.int64)
    pos[order] = np.arange(keys.shape[0]) - starts[keys[order]]
    kept = pos < capacity
    buckets = np.full((n_workers, capacity), -1, dtype=np.int32)
    buckets[keys[kept], pos[kept]] = np.flatnonzero(kept)
    return buckets, kept, load
