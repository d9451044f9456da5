"""Synthetic token pipeline for the LM zoo's serving path.

A numpy copy of ``repro/data/tokens.py`` (``TokenPipeline`` :20,
``make_batch`` :57) for token LMs: the same generators and the same
draws, so a seed gives the JAX package's tokens bit for bit. Audio and
VLM batches come with those families (ROADMAP Queue 1 item 16).
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


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0,
               pipeline: TokenPipeline | None = None) -> dict:
    """One batch of prompts for a token LM (numpy)."""
    if cfg.audio_frontend or cfg.vlm_patches:
        raise NotImplementedError(
            f"{cfg.name}: audio and VLM batches come with their families "
            "(ROADMAP Queue 1 item 16)")
    pipe = pipeline or TokenPipeline(cfg.vocab, seed)
    return {"tokens": pipe.sample(batch, seq_len)}
