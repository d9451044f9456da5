"""StoragePolicy — how worker-state tables are *stored*, not computed.

Port of ``repro/core/storage.py``. Every algorithm computes in f32 /
bool; the *resident* encoding of each table is a per-table choice
carried on ``StreamConfig.storage``:

  * ``factors`` — DISGD / BPR-MF factor matrices: ``"f32"`` or
    ``"bf16"`` (``torch.bfloat16``, rounded to nearest even);
  * ``co`` — the DICS co-rating counts: ``"f32"``, ``"bf16"``, or
    integer-quantized ``"uint16"`` / ``"int8"`` with one scale per row
    (exact while counts stay <= qmax);
  * ``rated`` — the rating-history bitmaps: ``"dense"`` bool or
    ``"packed"`` ``torch.uint32`` bitfields, little-endian, as JAX's
    words bit for bit (8x smaller).

Every consumer decodes -> computes in f32 / bool -> encodes at
micro-batch (or call) boundaries. The default policy short-circuits the
codecs to literal identities (``state_codecs``), so the default
configuration runs no codec operation at all.

Stored tables keep JAX's dtypes (``state_nbytes`` names them as JAX
does). PyTorch has few operations on ``uint16`` / ``uint32`` (no
shifts, sums or ``index_put``), so the codecs compute on signed or byte
views of the same memory (``signed``) and store the unsigned view.

Scales follow XLA's arithmetic, not the ideal one: JAX computes
``exp2(ceil(log2(max(rowmax / qmax, 1))))`` with ``log2(v) = log(v) /
log(2)`` and ``exp2(e) = exp(e * log(2))`` in f32, so a row maximum a
count above ``qmax * 2^e`` can keep exponent ``e``, and from ``e`` ~ 13
the scale is not an exact power of two. ``_row_scales`` takes ``log``
and ``exp`` in float64 of the same f32 operands and rounds once, which
gives XLA's exponents and scales on the CPU and on CUDA alike.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable

import torch

from repro_torch.core.state import DicsState, DisgdState, signed

__all__ = [
    "StoragePolicy",
    "StoragePolicyError",
    "packed_width",
    "pack_bits",
    "unpack_bits",
    "quantize_rows",
    "dequantize_rows",
    "encode_state",
    "decode_state",
    "encode_into",
    "in_compute_form",
    "round_trip",
    "state_codecs",
    "encode_template",
    "gather_rated",
    "decode_co",
    "factor_f32",
    "is_lossy",
    "table_arrays",
    "state_nbytes",
    "total_nbytes",
]

_FACTORS = ("f32", "bf16")
_CO = ("f32", "bf16", "uint16", "int8")
_RATED = ("dense", "packed")

# Quantized co-count dtypes and their integer ranges.
_QSPEC = {"uint16": (torch.uint16, 0, 65535), "int8": (torch.int8, -127, 127)}
# float32(log(2)), the constant XLA divides and multiplies by.
_LN2_F32 = float(torch.tensor(math.log(2.0), dtype=torch.float32))


class StoragePolicyError(ValueError):
    """A checkpoint's storage policy does not match the restoring config.

    Carries both policies. Migration is a regrid concern: restore under
    the checkpoint's policy, then ``StreamSession.rescale(...,
    storage=new_policy)`` re-encodes.
    """

    def __init__(self, checkpoint_policy: "StoragePolicy",
                 config_policy: "StoragePolicy"):
        self.checkpoint_policy = checkpoint_policy
        self.config_policy = config_policy
        super().__init__(
            f"checkpoint was written under storage policy "
            f"{checkpoint_policy} but the config asks for {config_policy}. "
            "Restore with the checkpoint's policy (StreamConfig(storage="
            f"{checkpoint_policy!r})), then migrate live via "
            "StreamSession.rescale(..., storage=<new policy>) — regrid is "
            "the re-encoding path.")


@dataclasses.dataclass(frozen=True)
class StoragePolicy:
    """Frozen per-table encoding spec (hashable)."""

    factors: str = "f32"   # "f32" | "bf16"
    co: str = "f32"        # "f32" | "bf16" | "uint16" | "int8"
    rated: str = "dense"   # "dense" | "packed"

    def __post_init__(self):
        if self.factors not in _FACTORS:
            raise ValueError(f"factors={self.factors!r}; one of {_FACTORS}")
        if self.co not in _CO:
            raise ValueError(f"co={self.co!r}; one of {_CO}")
        if self.rated not in _RATED:
            raise ValueError(f"rated={self.rated!r}; one of {_RATED}")

    @property
    def is_default(self) -> bool:
        return (self.factors == "f32" and self.co == "f32"
                and self.rated == "dense")

    @classmethod
    def compressed(cls, factors: str = "f32") -> "StoragePolicy":
        """Quantized co + packed rated. Lossless while co-counts stay <=
        65,535; ``factors="bf16"`` also halves the factor tables."""
        return cls(factors=factors, co="uint16", rated="packed")

    def describe(self) -> dict:
        """JSON-able descriptor (the checkpoint's ``storage`` record)."""
        return {"factors": self.factors, "co": self.co, "rated": self.rated}

    @classmethod
    def from_descriptor(cls, desc) -> "StoragePolicy":
        if desc is None:
            return cls()
        return cls(factors=str(desc["factors"]), co=str(desc["co"]),
                   rated=str(desc["rated"]))


def _policy(policy) -> StoragePolicy:
    return StoragePolicy() if policy is None else policy


# ---------------------------------------------------------------------------
# Bit-packed rated bitmaps: bool[..., I] <-> uint32[..., ceil(I/32)]
# ---------------------------------------------------------------------------

# One 64-bit product gathers the low bits of 8 bytes into the top byte:
# byte k (a 0 / 1 bool) times 2^(56 - 7k) lands on bit 56 + k, and no two
# of the 64 partial products share a bit, so nothing carries.
_GATHER_8 = 0x0102040810204080


def packed_width(n: int) -> int:
    """uint32 words needed for ``n`` bits."""
    return -(-n // 32)


def pack_bits(b: torch.Tensor, out: torch.Tensor | None = None,
              consume: bool = False):
    """bool[..., I] -> uint32[..., ceil(I/32)], little-endian: bit j of
    word w is ``b[..., 32 w + j]`` (JAX's words bit for bit).

    Each byte is the sum of 8 bools times 1, 2, ..., 128, taken as one
    int64 product per 8 bools, whose top byte it is; no ``[..., W, 32]``
    temporary. ``out`` (a uint32 tensor of the result's shape) receives
    the words in place; ``consume=True`` lets the product overwrite ``b``
    (a temporary the caller drops) instead of a new int64 tensor.
    """
    n = b.shape[-1]
    w = packed_width(n)
    if w == 0 or b.numel() == 0:
        words = torch.zeros(b.shape[:-1] + (w,), dtype=torch.int32,
                            device=b.device)
        if out is None:
            return words.view(torch.uint32)
        return out
    if w * 32 != n or not b.is_contiguous():
        pad = b.new_zeros(b.shape[:-1] + (w * 32,))
        pad[..., :n] = b
        b, consume = pad, True
    x = b.view(torch.uint8).view(torch.int64)
    x = x.mul_(_GATHER_8) if consume else x * _GATHER_8
    # Byte 7 of each little-endian product: the packed byte.
    words = x.view(torch.uint8)[..., 7::8].contiguous().view(torch.int32)
    if out is None:
        return words.view(torch.uint32)
    signed(out).copy_(words)
    return out


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """uint32[..., W] -> bool[..., n] (the inverse of :func:`pack_bits`),
    through one ``[..., 4 W, 8]`` uint8 temporary."""
    w = words.shape[-1]
    if words.numel() == 0:
        return torch.zeros(words.shape[:-1] + (n,), dtype=torch.bool,
                           device=words.device)
    by = signed(words).contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (by[..., None] >> shifts).bitwise_and_(1)
    bits = bits.view(words.shape[:-1] + (w * 32,)).view(torch.bool)
    return bits if n == w * 32 else bits[..., :n].contiguous()


# ---------------------------------------------------------------------------
# Per-row quantization: f32[..., R, C] <-> (int[..., R, C], f32[..., R])
# ---------------------------------------------------------------------------


def _row_scales(rowmax: torch.Tensor, qmax: int) -> torch.Tensor:
    """``exp2(ceil(log2(max(rowmax / qmax, 1))))`` as XLA computes it (see
    the module docstring), f32."""
    # Divisors as tensors on the rows' device (a fill, no host copy):
    # CUDA divides by a host scalar as a product with its reciprocal,
    # which is not IEEE division.
    def const(c):
        return torch.full((), c, dtype=torch.float32, device=rowmax.device)

    v = torch.clamp(rowmax / const(qmax), min=1.0)
    log2 = v.double().log().float() / const(_LN2_F32)
    arg = torch.ceil(log2) * _LN2_F32
    return arg.double().exp().float()


def quantize_rows(x: torch.Tensor, dtype: str):
    """Quantize along the last axis with one scale per row: ``(q,
    scale)``. The scale is exactly 1 while the row fits the integer range
    (integer rows round-trip losslessly) and about doubles as the row
    grows; rounding is half to even. A zero-size row has maximum 0 (JAX's
    ``initial=0``)."""
    dt, qmin, qmax = _QSPEC[dtype]
    if x.shape[-1]:
        rowmax = x.abs().amax(-1)
    else:
        rowmax = x.new_zeros(x.shape[:-1])
    scale = _row_scales(rowmax, qmax)
    q = torch.clamp(torch.round(x / scale[..., None]), qmin, qmax)
    q = q.to(torch.int32)
    if dt == torch.uint16:
        return q.to(torch.int16).view(torch.uint16), scale
    return q.to(dt), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if q.dtype == torch.uint16:
        q = q.view(torch.int16).to(torch.int32) & 0xFFFF
    return q.to(torch.float32) * scale[..., None]


# ---------------------------------------------------------------------------
# Whole-state codecs
# ---------------------------------------------------------------------------


def factor_f32(x: torch.Tensor) -> torch.Tensor:
    """Decode a (possibly bf16) factor table to the f32 compute form."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def decode_co(co: torch.Tensor, co_scale, policy) -> torch.Tensor:
    """Decode a stored co-count table to the f32 compute form."""
    if _policy(policy).co in _QSPEC:
        return dequantize_rows(co, co_scale)
    return factor_f32(co)


def gather_rated(rated: torch.Tensor, slots: torch.Tensor, policy=None,
                 i_cap: int | None = None) -> torch.Tensor:
    """The ``rated`` rows of a batch of user slots of every worker,
    decoded: stacked ``rated[W, U, ...]`` with ``slots[W, B]`` ->
    ``bool[W, B, I]``. Under a packed policy only the gathered ``[W, B,
    words]`` are unpacked, never the whole bitmap."""
    w = torch.arange(rated.shape[0], device=rated.device)[:, None]
    rows = signed(rated)[w, slots.long()]
    if _policy(policy).rated == "packed":
        rows = unpack_bits(rows, i_cap)
    return rows


def encode_state(states, policy):
    """Compute-form (f32 / bool) state -> policy-encoded resident state.
    Tables are shared, not copied; an encoded table is a new tensor."""
    policy = _policy(policy)
    if policy.is_default:
        return states
    out = states
    if isinstance(states, DisgdState):
        if policy.factors == "bf16":
            out = out._replace(user_vecs=out.user_vecs.to(torch.bfloat16),
                               item_vecs=out.item_vecs.to(torch.bfloat16))
    elif isinstance(states, DicsState):
        if policy.co == "bf16":
            out = out._replace(co=out.co.to(torch.bfloat16), co_scale=None)
        elif policy.co in _QSPEC:
            q, scale = quantize_rows(out.co, policy.co)
            out = out._replace(co=q, co_scale=scale)
    else:
        raise TypeError(f"unknown state type {type(states)}")
    if policy.rated == "packed":
        out = out._replace(rated=pack_bits(out.rated))
    return out


def decode_state(states, policy):
    """Policy-encoded resident state -> the f32 / bool compute form.
    Tables and tables already in compute form are shared; a decoded
    table is a new tensor."""
    policy = _policy(policy)
    if policy.is_default:
        return states
    out = states
    if isinstance(states, DisgdState):
        if policy.factors == "bf16":
            out = out._replace(user_vecs=factor_f32(out.user_vecs),
                               item_vecs=factor_f32(out.item_vecs))
    elif isinstance(states, DicsState):
        out = out._replace(co=decode_co(out.co, out.co_scale, policy),
                           co_scale=None)
    else:
        raise TypeError(f"unknown state type {type(states)}")
    if policy.rated == "packed":
        i_cap = out.tables.item_ids.shape[-1]
        out = out._replace(rated=unpack_bits(out.rated, i_cap))
    return out


def encode_into(resident, decoded, policy) -> None:
    """Encode the compute form ``decoded`` (``decode_state(resident)``,
    updated in place since) back into ``resident``'s tensors with
    ``copy_``: the in-place counterpart of :func:`encode_state`. Tables
    the two share are already written."""
    policy = _policy(policy)
    if policy.is_default:
        return
    if policy.rated == "packed":
        # The decoded bitmap is decode_state's temporary: pack over it.
        pack_bits(decoded.rated, out=resident.rated, consume=True)
    if isinstance(resident, DisgdState):
        if policy.factors == "bf16":
            resident.user_vecs.copy_(decoded.user_vecs)
            resident.item_vecs.copy_(decoded.item_vecs)
    elif policy.co == "bf16":
        resident.co.copy_(decoded.co)
    elif policy.co in _QSPEC:
        q, scale = quantize_rows(decoded.co, policy.co)
        signed(resident.co).copy_(signed(q))
        resident.co_scale.copy_(scale)


def round_trip(decoded, policy) -> None:
    """Round the lossy tables of a compute-form state to what their
    encoding keeps (bf16 factors, bf16 or quantized ``co``), in place:
    ``decode(encode(x))``. Packed ``rated`` and f32 tables decode to what
    they encode, and are left alone."""
    policy = _policy(policy)
    if isinstance(decoded, DisgdState):
        if policy.factors == "bf16":
            for t in (decoded.user_vecs, decoded.item_vecs):
                t.copy_(t.to(torch.bfloat16))
    elif policy.co == "bf16":
        decoded.co.copy_(decoded.co.to(torch.bfloat16))
    elif policy.co in _QSPEC:
        decoded.co.copy_(dequantize_rows(*quantize_rows(decoded.co,
                                                        policy.co)))


def in_compute_form(states, policy, fn):
    """``fn(decoded)`` on the compute form of the resident ``states``,
    then the result encoded back into them in place: JAX's ``enc(fn(dec(
    s)))`` for a ``fn`` that updates its state in place. Returns what
    ``fn`` returns; under the default policy ``fn(states)`` itself."""
    policy = _policy(policy)
    if policy.is_default:
        return fn(states)
    work = decode_state(states, policy)
    out = fn(work)
    encode_into(states, work, policy)
    return out


def is_lossy(policy) -> bool:
    """Whether :func:`round_trip` changes anything under ``policy``."""
    policy = _policy(policy)
    return policy.factors == "bf16" or policy.co != "f32"


def state_codecs(policy) -> tuple[Callable, Callable]:
    """``(decode, encode)`` for a policy; literal identities by default,
    so the default configuration runs no codec operation."""
    policy = _policy(policy)
    if policy.is_default:
        ident = lambda s: s  # noqa: E731 — the default policy's fast path
        return ident, ident
    return (partial(decode_state, policy=policy),
            partial(encode_state, policy=policy))


def encode_template(state, policy):
    """The resident schema of a compute-form ``state`` under ``policy``:
    a state of ``meta`` tensors (shapes and dtypes, no memory)."""
    policy = _policy(policy)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    tables = type(state.tables)(*(meta(t.shape, t.dtype)
                                  for t in state.tables))
    rated = state.rated
    rated = (meta(rated.shape[:-1] + (packed_width(rated.shape[-1]),),
                  torch.uint32) if policy.rated == "packed"
             else meta(rated.shape, torch.bool))
    if isinstance(state, DisgdState):
        f = torch.bfloat16 if policy.factors == "bf16" else torch.float32
        return DisgdState(tables, meta(state.user_vecs.shape, f),
                          meta(state.item_vecs.shape, f), rated)
    co_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}.get(
        policy.co) or _QSPEC[policy.co][0]
    co_scale = (meta(state.co.shape[:-1], torch.float32)
                if policy.co in _QSPEC else None)
    return DicsState(tables, meta(state.co.shape, co_dtype),
                     meta(state.item_cnt.shape, torch.float32), rated,
                     co_scale)


# ---------------------------------------------------------------------------
# Memory accounting (exact nbytes from tensor metadata, no sync)
# ---------------------------------------------------------------------------


def table_arrays(states) -> dict[str, torch.Tensor]:
    """Named tables of a (single or stacked) worker state."""
    out = dict(states.tables._asdict())
    if isinstance(states, DisgdState):
        out.update(user_vecs=states.user_vecs, item_vecs=states.item_vecs,
                   rated=states.rated)
    elif isinstance(states, DicsState):
        out.update(co=states.co, item_cnt=states.item_cnt,
                   rated=states.rated)
        if states.co_scale is not None:
            out["co_scale"] = states.co_scale
    else:
        raise TypeError(f"unknown state type {type(states)}")
    return out


def state_nbytes(states) -> dict[str, tuple[str, int]]:
    """Exact resident bytes per table: ``{table: (dtype, nbytes)}``, the
    dtype named as numpy names it (``"int32"``, ``"uint32"``,
    ``"bfloat16"``), from tensor metadata only (no device sync)."""
    return {name: (str(t.dtype).removeprefix("torch."),
                   t.numel() * t.element_size())
            for name, t in table_arrays(states).items()}


def total_nbytes(states) -> int:
    """Total resident bytes of a worker state."""
    return sum(n for _, n in state_nbytes(states).values())
