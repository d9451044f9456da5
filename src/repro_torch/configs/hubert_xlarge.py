"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447]. A copy of
``repro/configs/hubert_xlarge.py``.

48L d_model=1280 16H d_ff=5120 vocab=504 (masked-prediction cluster
targets). Same backbone as wav2vec 2.0. The conv waveform feature
extractor is a stub per the assignment: the batch provides 512-dim
frame embeddings; a learned projection maps them to d_model. Bidirectional
(non-causal) self-attention; no decode shapes.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        source="arXiv:2106.07447",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab=504,
        causal=False,
        decoder=False,
        audio_frontend=True,
        d_frame=512,
        q_chunk=512,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="hubert-smoke",
        family="audio",
        source="arXiv:2106.07447 (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=64,
        causal=False,
        decoder=False,
        audio_frontend=True,
        d_frame=32,
        q_chunk=32,
        remat=False,
    )
