"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend
[hf:microsoft/Phi-3-vision-128k-instruct]. A copy of
``repro/configs/phi3_vision_4p2b.py``.

32L d_model=3072 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=32064.
Per the assignment, only the language/decoder transformer is implemented;
the vision encoder is a stub — the batch provides precomputed patch
embeddings (CLIP ViT-L/14 width 1024) which a learned 2-layer projector
maps into the embedding stream.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        source="hf:microsoft/Phi-3-vision-128k-instruct",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32064,
        vlm_patches=576,      # 336px CLIP ViT-L/14: 24x24 patches
        vlm_d_vision=1024,
        q_chunk=512,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="phi3v-smoke",
        family="vlm",
        source="hf:microsoft/Phi-3-vision-128k-instruct (reduced)",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=503,
        vlm_patches=16,
        vlm_d_vision=64,
        q_chunk=32,
        remat=False,
    )
