"""stablelm-3b — dense decoder [hf:stabilityai/stablelm-2-1_6b family].
A copy of ``repro/configs/stablelm_3b.py``.

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304, partial rotary
(25% of head dim, stablelm-2 style). Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b",
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab=50304,
        rope_pct=0.25,
        q_chunk=1024,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-smoke",
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=503,
        rope_pct=0.25,
        q_chunk=32,
        remat=False,
    )
