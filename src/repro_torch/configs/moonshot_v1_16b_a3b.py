"""moonshot-v1-16b-a3b — Moonlight (deepseek-v3-style MoE)
[hf:moonshotai/Moonlight-16B-A3B]. A copy of
``repro/configs/moonshot_v1_16b_a3b.py``.

48L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=163840,
MoE 64 routed experts top-6 + 2 shared experts, dense FFN in layer 0.
"""

from repro_torch.configs.base import ArchConfig, MoeConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        source="hf:moonshotai/Moonlight-16B-A3B",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=163_840,
        moe=MoeConfig(
            n_experts=64, top_k=6, d_expert=1408, n_shared=2, first_dense=True
        ),
        q_chunk=512,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-smoke",
        family="moe",
        source="hf:moonshotai/Moonlight-16B-A3B (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab=503,
        moe=MoeConfig(n_experts=4, top_k=2, d_expert=64, n_shared=1,
                      first_dense=True, group_size=32),
        q_chunk=32,
        remat=False,
    )
