"""Threefry-2x32 counter PRNG that reproduces ``jax.random`` on tensors.

Port of the parts of ``jax._src.prng`` and ``jax._src.random`` that the
DISGD replica-consistent init vectors (``repro/core/disgd.py::init_vector``)
depend on, as JAX 0.9 computes them with ``jax_threefry_partitionable``
on:

  * ``key(seed)``      — ``threefry_seed``: the key words ``(seed >> 32,
    seed & 0xFFFFFFFF)``;
  * ``fold_in(k, d)``  — ``threefry_2x32(k, (0, d))``, bit for bit, for
    one key or a batch of keys;
  * ``split(k, n)``    — ``_threefry_split_foldlike``: new key ``m`` is
    ``threefry_2x32(k, (0, m))``, both words kept (so ``fold_in(k, m)``);
  * ``bits(k, n)``     — ``b1 ^ b2`` of the hash over counters
    ``(0, iota(n))``, bit for bit;
  * ``randint(k, lo, hi)`` — ``jax.random.randint(k, (), lo, hi)`` for
    int32, one draw per key: two keys by ``split``, 32 bits from each,
    combined modulo the span with every product and sum wrapped to 32
    bits as JAX's uint32 arithmetic wraps them;
  * ``normal(k, n)``   — ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``
    with XLA's f32 ``erfinv`` (the Giles polynomial). The polynomial
    runs as separate float32 ops, so it matches XLA to within a few ulp
    rather than bit for bit (XLA may contract ``p * w + c`` into FMAs).

Keys are int64 tensors of shape ``[..., 2]`` holding uint32 words. All
uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF``, so the same code
runs on the CPU and on the card (CUDA has no uint32 tensor kernels for
most of these ops).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["key", "fold_in", "split", "bits", "randint", "normal",
           "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's ErfInv32 (Giles, "Approximating the erfinv function").
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)`` as an int64 ``[2]`` tensor (seed >= 0)."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(k, data.astype(uint32))`` for every entry of
    ``data``: ``k`` is one key ``[2]`` or keys ``[..., 2]`` broadcasting
    against ``data``; returns keys of the broadcast shape ``+ (2,)``."""
    d = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)`` for each key of ``keys[..., 2]``;
    returns ``keys.shape[:-1] + (n, 2)``."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    return fold_in(keys[..., None, :], idx)


def bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(k, (n,))`` (uint32 in int64) for each key of
    ``keys[..., 2]``; returns ``keys.shape[:-1] + (n,)``."""
    counts = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(counts), counts)
    return b1 ^ b2


def randint(keys: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``jax.random.randint(k, (), lo, hi, int32)`` for each key of
    ``keys[..., 2]``: int64 draws in ``[lo, hi)`` of shape
    ``keys.shape[:-1]`` (``lo`` when ``hi <= lo``)."""
    span = hi - lo if hi > lo else 1
    # Two keys, 32 bits from each (counter (0, 0)), in one hash call.
    sub = split(keys)
    b1, b2 = threefry2x32(sub[..., 0], sub[..., 1],
                          torch.zeros_like(sub[..., 0]),
                          torch.zeros_like(sub[..., 0]))
    bits_ = b1 ^ b2
    hi_bits, lo_bits = bits_[..., 0], bits_[..., 1]
    # 2**32 mod span from its halves; uint32 products wrap (for a span
    # above 2**16 the multiplier's square wraps to 0).
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((((hi_bits % span) * mult) & _MASK) + lo_bits % span) & _MASK
    return lo + off % span


# f32 constants of jax.random.uniform / normal, as Python floats: scalars
# ride along as kernel arguments, where a 0-d tensor made from a host
# value would be a host-to-device copy and stall the stream loop.
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SPAN = float(np.float32(1.0) - np.float32(_LO))
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def _horner(coeffs, w):
    p = coeffs[1] + coeffs[0] * w
    for c in coeffs[2:]:
        p = c + p * w
    return p


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    # log1p in float64, rounded once to float32: PyTorch's f32 log1p on
    # the CPU takes a vectorized or a scalar path depending on how a
    # tensor is split, and the two differ in the last bits, which near
    # x = +-1 moves the result far enough to fail a 1e-6 comparison.
    w = (-torch.log1p(-(x * x).double())).float()
    # XLA selects each coefficient and w per element; evaluating both
    # polynomials and selecting gives every element the same f32 ops.
    p = torch.where(w < 5.0, _horner(_ERFINV_LT5, w - 2.5),
                    _horner(_ERFINV_GE5, torch.sqrt(w) - 3.0))
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, out)


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(k, (n,), float32)`` for each key of ``keys``."""
    b = bits(keys, n)
    # Mantissa trick of jax.random.uniform: 23 random bits under exponent 0.
    one_bits = (b >> 9) | 0x3F800000
    floats = one_bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(floats * _SPAN + _LO, min=_LO)
    return _SQRT2 * _erfinv_f32(u)
