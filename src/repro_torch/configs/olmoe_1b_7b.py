"""olmoe-1b-7b — 64 experts top-8 MoE [arXiv:2409.02060]. A copy of
``repro/configs/olmoe_1b_7b.py``.

16L d_model=2048 16H (GQA kv=16) per-expert d_ff=1024 vocab=50304.
"""

from repro_torch.configs.base import ArchConfig, MoeConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="olmoe-1b-7b",
        family="moe",
        source="arXiv:2409.02060",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        moe=MoeConfig(n_experts=64, top_k=8, d_expert=1024),
        q_chunk=512,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="olmoe-smoke",
        family="moe",
        source="arXiv:2409.02060 (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=503,
        moe=MoeConfig(n_experts=4, top_k=2, d_expert=64, group_size=32),
        q_chunk=32,
        remat=False,
    )
