"""Assigned input shapes and per-(arch, shape) run plans.

A copy of ``repro/configs/shapes.py``: the dry-run's shapes, its plan
(run or the reason to skip) and the training microbatches that keep a
device's activations within its budget.
"""

from __future__ import annotations

import dataclasses

__all__ = ["InputShape", "SHAPES", "plan_for", "microbatches_for"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def plan_for(cfg, shape: InputShape) -> str:
    """'run' or a skip reason."""
    if shape.kind == "decode" and not cfg.decoder:
        return "skip: encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("skip: full-attention architecture; 500k dense KV cache "
                "is out of scope per assignment (no sub-quadratic variant)")
    return "run"


def microbatches_for(cfg, shape: InputShape, n_data_shards: int) -> int:
    """Gradient-accumulation microbatches so activations fit HBM.

    Budget ~2 GiB of bf16 residual-stream checkpoints per device:
    local_batch * seq * d_model * n_layers * 2B per microbatch.
    """
    if shape.kind != "train":
        return 1
    local_batch = max(1, shape.global_batch // n_data_shards)
    per_item = shape.seq_len * cfg.d_model * cfg.n_layers * 2
    budget = 2 * 2**30
    max_items = max(1, budget // per_item)
    micro = 1
    while local_batch // micro > max_items or local_batch % micro:
        micro += 1
        while local_batch % micro and micro < local_batch:
            micro += 1
    return micro
