"""Beyond-paper optimized presets: a copy of ``repro/configs/optimized.py``.

The paper-faithful defaults stay in each arch config; these presets are
the variants the JAX package selected on its TPU dry-run (its numbers are
a TPU's, not this port's), kept so that both stay selectable and the
sharding rules resolve the same specs:

  * xlstm_350m / hymba_1p5b: the batch sharded over both mesh axes, and
    xLSTM's inner dims unsharded (their 25 / 4 heads do not divide a
    16-wide model axis);
  * the MoE archs: capacity factor 1.0.
"""

from __future__ import annotations

import dataclasses

__all__ = ["OPTIMIZED", "apply_optimized"]

# arch_id -> list of (dotted field, value)
OPTIMIZED: dict = {
    "xlstm_350m": [
        ("sharding_overrides",
         (("inner", ()), ("batch", (("data", "model"),)))),
    ],
    "hymba_1p5b": [
        ("sharding_overrides", (("batch", (("data", "model"),)),)),
    ],
    "dbrx_132b": [
        ("moe.capacity_factor", 1.0),
    ],
    "olmoe_1b_7b": [
        ("moe.capacity_factor", 1.0),
    ],
    "moonshot_v1_16b_a3b": [
        ("moe.capacity_factor", 1.0),
    ],
}


def apply_optimized(cfg):
    """Return the optimized variant of ``cfg`` (identity if no preset)."""
    for key, val in OPTIMIZED.get(cfg_id(cfg), []):
        if "." in key:
            head, sub = key.split(".", 1)
            inner = dataclasses.replace(getattr(cfg, head), **{sub: val})
            cfg = dataclasses.replace(cfg, **{head: inner})
        else:
            cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


def cfg_id(cfg) -> str:
    """Map a config's display name back to its registry id."""
    return cfg.name.replace("-", "_").replace(".", "p")
