"""Execution-tile registry: cached autotune winners per (op, algo, backend).

Port of ``repro/kernels/tiles.py``: the same registry, fallback chain and
JSON files (either package loads the other's). ``DEFAULTS`` keeps the
JAX package's rows, CPU winners keyed ``"cpu"``; no autotune has run on
the GPU, so the wildcard rows answer for ``"gpu"``.

The knobs recorded here are the EXECUTION tiles the loop feeds the
kernels: the micro-batch size (how many events amortize one dispatch)
and the per-bucket capacity factor (how much padding headroom each
worker bucket gets before events drop). An autotune sweep records its
winner per (algorithm, backend, platform); callers look winners up with
:func:`best_tile` through a wildcard fallback chain, so a shape that was
never swept still gets the nearest measured default. :func:`record`
overrides a row at runtime and :func:`save` / :func:`load` persist them.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

__all__ = ["DEFAULTS", "best_tile", "record", "save", "load", "reset"]

Key = Tuple[str, str, str, str]  # (op, algorithm, backend, platform)

# Measured on the reference CPU host (bench_kernels --autotune, mb in
# {128, 256, 512} x capacity_factor in {1.0, 1.25, 2.0}; zero-drop
# winners, throughput breaking ties — full sweep table in the README).
# Factor models amortize dispatch hardest (mb=512); DICS's O(i_cap^2)
# update prefers small buckets. The pallas fast path scores at bucket
# start, so its recall tolerance widens with mb (0.555 -> 0.519 for
# DISGD at mb 128 -> 512); the registry optimizes throughput and leaves
# the recall-sensitive operating point to the caller's explicit mb.
DEFAULTS: Dict[Key, Dict[str, Any]] = {
    ("engine", "*", "*", "*"): {"micro_batch": 512, "capacity_factor": 1.25},
    ("engine", "disgd", "scan", "cpu"): {
        "micro_batch": 512, "capacity_factor": 1.0},
    ("engine", "disgd", "pallas", "cpu"): {
        "micro_batch": 512, "capacity_factor": 1.0},
    ("engine", "bpr", "scan", "cpu"): {
        "micro_batch": 128, "capacity_factor": 1.25},
    ("engine", "bpr", "pallas", "cpu"): {
        "micro_batch": 512, "capacity_factor": 1.0},
    ("engine", "dics", "scan", "cpu"): {
        "micro_batch": 256, "capacity_factor": 1.0},
    ("engine", "dics", "pallas", "cpu"): {
        "micro_batch": 128, "capacity_factor": 1.25},
    ("serve", "*", "*", "*"): {"block_b": 128, "block_i": 512},
    ("serve", "dics", "*", "*"): {"block_p": 128},
}

_tuned: Dict[Key, Dict[str, Any]] = {}


def _chain(op: str, algorithm: str, backend: str, platform: str):
    for key in (
        (op, algorithm, backend, platform),
        (op, algorithm, backend, "*"),
        (op, algorithm, "*", platform),
        (op, algorithm, "*", "*"),
        (op, "*", backend, "*"),
        (op, "*", "*", "*"),
    ):
        yield key


def best_tile(op: str, algorithm: str = "*", backend: str = "*",
              platform: str = "*") -> Dict[str, Any]:
    """Winning tile dict for the most specific matching key (tuned beats
    shipped defaults); ``{}`` when nothing matches."""
    for key in _chain(op, algorithm, backend, platform):
        if key in _tuned:
            return dict(_tuned[key])
    for key in _chain(op, algorithm, backend, platform):
        if key in DEFAULTS:
            return dict(DEFAULTS[key])
    return {}


def record(op: str, algorithm: str, backend: str, platform: str,
           tile: Dict[str, Any]) -> None:
    """Cache an autotune winner for this process (and later ``save``)."""
    _tuned[(op, algorithm, backend, platform)] = dict(tile)


def reset() -> None:
    _tuned.clear()


def save(path) -> None:
    """Persist tuned winners as JSON (keys joined with '/')."""
    payload = {"/".join(k): v for k, v in sorted(_tuned.items())}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def load(path) -> None:
    """Load winners saved by :func:`save` into the tuned cache."""
    with open(path) as f:
        payload = json.load(f)
    for joined, tile in payload.items():
        op, algorithm, backend, platform = joined.split("/")
        _tuned[(op, algorithm, backend, platform)] = dict(tile)
