"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].
A copy of ``repro/configs/dbrx_132b.py``.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""

from repro_torch.configs.base import ArchConfig, MoeConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        source="hf:databricks/dbrx-base",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        moe=MoeConfig(n_experts=16, top_k=4, d_expert=10752),
        q_chunk=512,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-smoke",
        family="moe",
        source="hf:databricks/dbrx-base (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=503,
        moe=MoeConfig(n_experts=4, top_k=2, d_expert=128, group_size=32),
        q_chunk=32,
        remat=False,
    )
