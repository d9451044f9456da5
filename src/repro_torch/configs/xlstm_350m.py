"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517]. A copy of
``repro/configs/xlstm_350m.py``.

24L d_model=1024 4H d_ff=0 vocab=50304. Attention-free: blocks are mLSTM
(matrix-memory, chunked-parallel linear recurrence) with one sLSTM
(scalar-memory, strictly sequential recurrence) per 6-block group —
the paper's a:b block-ratio scheme. d_ff=0 per assignment: the blocks'
internal up/down projections replace a separate FFN.
"""

from repro_torch.configs.base import ArchConfig, XlstmConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m",
        family="ssm",
        source="arXiv:2405.04517",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        xlstm=XlstmConfig(slstm_period=6, proj_factor=2.0, chunk=256),
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-smoke",
        family="ssm",
        source="arXiv:2405.04517 (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab=503,
        xlstm=XlstmConfig(slstm_period=2, proj_factor=2.0, chunk=32),
        remat=False,
    )
