"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]. A copy of ``repro/configs/h2o_danube_1p8b.py``.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096
(mistral-style rolling-buffer KV cache).
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-1.8b",
        family="dense",
        source="arXiv:2401.16818",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab=32000,
        window=4096,
        q_chunk=1024,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="danube-smoke",
        family="dense",
        source="arXiv:2401.16818 (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=503,
        window=32,
        q_chunk=32,
        remat=False,
    )
