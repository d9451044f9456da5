"""granite-34b — llama-arch code model with MQA [arXiv:2405.04324].
A copy of ``repro/configs/granite_34b.py``.

88L d_model=6144 48H (GQA kv=1, i.e. multi-query) d_ff=24576 vocab=49152.
Full attention -> long_500k skipped per assignment.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        source="arXiv:2405.04324",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        q_chunk=512,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="granite-smoke",
        family="dense",
        source="arXiv:2405.04324 (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        d_ff=512,
        vocab=503,
        q_chunk=32,
        remat=False,
    )
