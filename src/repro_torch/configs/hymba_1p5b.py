"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676].
A copy of ``repro/configs/hymba_1p5b.py``.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba runs attention and SSM (mamba) heads *in parallel* within each block
and uses sliding-window attention in all but a few global layers. Two
approximations, as in the JAX package: the paper's learnable
meta-tokens are out of scope, and *all* layers use SWA (the 3 global
layers would break the homogeneous scan-over-layers parameter stacking;
the mamba branch already provides unbounded-range mixing).
"""

from repro_torch.configs.base import ArchConfig, SsmConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        source="arXiv:2411.13676",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        ssm=SsmConfig(state_dim=16, conv_width=4, expand=2),
        window=1024,
        q_chunk=256,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="hymba-smoke",
        family="hybrid",
        source="arXiv:2411.13676 (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=5,
        n_kv_heads=1,
        d_ff=256,
        vocab=503,
        ssm=SsmConfig(state_dim=8, conv_width=4, expand=2, chunk=32),
        window=32,
        q_chunk=32,
        remat=False,
    )
