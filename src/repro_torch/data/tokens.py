"""Synthetic token and feature pipelines for the LM zoo's serving path.

A numpy copy of ``repro/data/tokens.py`` (``TokenPipeline`` :20,
``_mask_spans`` :43, ``make_batch`` :57): the same generators and the
same draws, so a seed gives the JAX package's batches bit for bit. The
audio pipeline gives frame embeddings, HuBERT-style mask spans and
cluster targets; the VLM pipeline patch embeddings and text tokens.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline", "make_batch"]


@dataclasses.dataclass
class TokenPipeline:
    """Markov-chain LM data with a fixed random transition structure."""

    vocab: int
    seed: int = 0
    branching: int = 8  # candidate successors per token

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(
            0, self.vocab, size=(self.vocab, self.branching)
        )
        self._rng = np.random.default_rng(self.seed + 1)

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        toks = np.empty((batch, seq_len), dtype=np.int32)
        toks[:, 0] = self._rng.integers(0, self.vocab, size=batch)
        choices = self._rng.integers(0, self.branching, size=(batch, seq_len))
        for t in range(1, seq_len):
            toks[:, t] = self._succ[toks[:, t - 1], choices[:, t]]
        return toks


def _mask_spans(rng, batch: int, seq_len: int, *, p: float = 0.08,
                span: int = 10) -> np.ndarray:
    """HuBERT-style span masking: each frame starts a span of ``span``
    masked frames with probability ``p``."""
    mask = np.zeros((batch, seq_len), dtype=bool)
    starts = rng.random((batch, seq_len)) < p
    for b in range(batch):
        for s in np.nonzero(starts[b])[0]:
            mask[b, s:s + span] = True
    return mask


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0,
               pipeline: TokenPipeline | None = None) -> dict:
    """One batch for any family in the zoo (numpy): ``tokens``; a VLM's
    ``seq_len - vlm_patches`` tokens and its ``patches``; an audio
    model's ``frames``, ``mask`` and ``targets``."""
    rng = np.random.default_rng(seed)
    if cfg.audio_frontend:
        frames = rng.normal(size=(batch, seq_len, cfg.d_frame)).astype(
            np.float32)
        return {
            "frames": frames,
            "mask": _mask_spans(rng, batch, seq_len),
            "targets": rng.integers(
                0, cfg.vocab, size=(batch, seq_len)).astype(np.int32),
        }
    pipe = pipeline or TokenPipeline(cfg.vocab, seed)
    if cfg.vlm_patches:
        return {
            "tokens": pipe.sample(batch, seq_len - cfg.vlm_patches),
            "patches": rng.normal(
                size=(batch, cfg.vlm_patches, cfg.vlm_d_vision)
            ).astype(np.float32),
        }
    return {"tokens": pipe.sample(batch, seq_len)}
