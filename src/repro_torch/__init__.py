"""PyTorch/CUDA port of the S&R streaming recommender (paper 2204.04633).

A second package beside the JAX reference ``repro``: it imports torch
and numpy, never jax and nothing of ``repro``. Its hot path runs on an
NVIDIA H100 through hand-written kernels (``repro_torch/kernels``); CPU
tensors take the plain PyTorch versions of those kernels.

This slice: DISGD trained prequentially over the Splitting & Replication
grid (``run_stream``) and grid top-N serving (``grid_topn``).
"""

from repro_torch.core.disgd import DisgdHyper
from repro_torch.core.pipeline import StreamConfig, StreamResult, run_stream
from repro_torch.core.routing import GridSpec
from repro_torch.core.serve import recommend_topn
from repro_torch.serve.plane import grid_topn

__all__ = ["StreamConfig", "StreamResult", "run_stream", "GridSpec",
           "DisgdHyper", "grid_topn", "recommend_topn"]
