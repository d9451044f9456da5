"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro/models/layers/xlstm.py`` (arXiv:2405.04517, with the JAX
package's simplifications: sigmoid input gates, the normalizer
``max(|q . n|, 1)``):

  * **mLSTM** is a linear recurrence over a matrix state
    ``C_t = f_t C_{t-1} + i_t v_t k_t^T``, run chunkwise: a loop over
    chunks carries ``(C, n)`` per head, and inside a chunk the
    contributions come from masked decay matmuls (linear-attention
    style). The decay kernel ``exp(cum_l - cum_s)`` is masked with
    ``torch.where`` above the diagonal, where it may overflow, as JAX
    masks it with ``jnp.where``.
  * **sLSTM** has an elementwise-nonlinear recurrence, so it is a strict
    loop over time in f32. The input products ``x @ W`` of the four gates
    are taken for the whole sequence before the loop; the recurrent
    ``h @ R`` stays inside it.

JAX's module is jnp only; there is no kernel here either. Types follow
JAX's: projections in x's type (bf16), gates, states and the recurrences
in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.module import ParamDecl

__all__ = [
    "mlstm_decl", "mlstm_apply", "mlstm_decode", "MlstmState",
    "slstm_decl", "slstm_apply", "slstm_decode", "SlstmState",
    "init_mlstm_state", "init_slstm_state", "mlstm_state_decl",
    "slstm_state_decl",
]

GATES = ("i", "f", "z", "o")


class MlstmState(NamedTuple):
    c: torch.Tensor  # [..., B, H, Dh, Dh] f32
    n: torch.Tensor  # [..., B, H, Dh] f32


class SlstmState(NamedTuple):
    c: torch.Tensor  # [..., B, D] f32
    n: torch.Tensor  # [..., B, D]
    h: torch.Tensor  # [..., B, D]


def _mlstm_dims(cfg):
    d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)
    h = cfg.n_heads
    if d_inner % h:
        raise ValueError(f"{cfg.name}: d_inner {d_inner} over {h} heads")
    return d_inner, h, d_inner // h


def mlstm_decl(cfg) -> dict:
    d = cfg.d_model
    d_inner, h, _ = _mlstm_dims(cfg)
    return {
        "w_up": ParamDecl((d, 2 * d_inner), ("embed", "inner")),
        "w_q": ParamDecl((d_inner, d_inner), ("inner", None)),
        "w_k": ParamDecl((d_inner, d_inner), ("inner", None)),
        "w_v": ParamDecl((d_inner, d_inner), ("inner", None)),
        "w_i": ParamDecl((d_inner, h), ("inner", "heads"), scale=0.1),
        "w_f": ParamDecl((d_inner, h), ("inner", "heads"), scale=0.1),
        "b_f": ParamDecl((h,), ("heads",), init="ones", scale=2.0),
        "w_down": ParamDecl((d_inner, d), ("inner", "embed")),
    }


def mlstm_state_decl(cfg, batch: int) -> dict:
    """An mLSTM block's state declarations (``xlstm.py:72``)."""
    _, h, dh = _mlstm_dims(cfg)
    return {
        "c": ParamDecl((batch, h, dh, dh), ("batch", "heads", None, None),
                       init="zeros"),
        "n": ParamDecl((batch, h, dh), ("batch", "heads", None),
                       init="zeros"),
    }


def init_mlstm_state(cfg, batch: int, device=None) -> MlstmState:
    _, h, dh = _mlstm_dims(cfg)
    return MlstmState(
        c=torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        n=torch.zeros((batch, h, dh), dtype=torch.float32, device=device))


def _mlstm_qkvif(params, x, cfg):
    """q, k, v [B, H, S, Dh] f32 (q and k scaled by Dh^-1/2), the input
    gate and the log forget gate [B, H, S] f32, and the gate z [B, S,
    d_inner] in x's type (``xlstm.py:96``)."""
    d_inner, h, dh = _mlstm_dims(cfg)
    b, s, _ = x.shape
    xz = x @ params["w_up"].to(x.dtype)
    xi, z = xz[..., :d_inner], xz[..., d_inner:]

    def heads(w):
        y = xi @ w.to(x.dtype)
        return y.reshape(b, s, h, dh).transpose(1, 2).float()

    q = heads(params["w_q"]) * (dh ** -0.5)
    k = heads(params["w_k"]) * (dh ** -0.5)
    v = heads(params["w_v"])
    i_gate = torch.sigmoid((xi @ params["w_i"].to(x.dtype)).float()
                           ).transpose(1, 2)
    logf = F.logsigmoid((xi @ params["w_f"].to(x.dtype)).float()
                        + params["b_f"].float()).transpose(1, 2)
    return q, k, v, i_gate, logf, z


def mlstm_apply(params, x, cfg, state: MlstmState | None = None):
    """Chunkwise-parallel mLSTM (``xlstm.py:119``). x [B, S, D] -> (y,
    the final ``MlstmState``)."""
    b, s, _ = x.shape
    d_inner = _mlstm_dims(cfg)[0]
    chunk = min(cfg.xlstm.chunk, s)
    while s % chunk:  # the largest divisor of s not above the chunk size
        chunk -= 1
    if state is None:
        state = init_mlstm_state(cfg, b, x.device)

    q, k, v, i_gate, logf, z = _mlstm_qkvif(params, x, cfg)
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    c_in, n_in = state.c, state.n
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb, ib, fb = (q[:, :, sl], k[:, :, sl], v[:, :, sl],
                              i_gate[:, :, sl], logf[:, :, sl])
        cum = torch.cumsum(fb, dim=-1)                 # [B, H, L]
        total = cum[..., -1:]

        # The carried state's share.
        dec_q = torch.exp(cum)[..., None]              # [B, H, L, 1]
        h_inter = torch.einsum("bhld,bhde->bhle", qb, c_in) * dec_q
        dn_inter = torch.einsum("bhld,bhd->bhl", qb, n_in) * dec_q[..., 0]

        # Within the chunk: the masked decay kernel.
        ratio = cum[..., :, None] - cum[..., None, :]  # [B, H, L, L]
        kern = torch.where(tril, torch.exp(ratio), 0.0) * ib[..., None, :]
        qk = torch.einsum("bhld,bhsd->bhls", qb, kb)
        h_intra = torch.einsum("bhls,bhsd->bhld", kern * qk, vb)
        dn_intra = torch.sum(kern * qk, dim=-1)

        denom = torch.abs(dn_inter + dn_intra).clamp_min(1.0)[..., None]
        ys.append((h_inter + h_intra) / denom)

        # The state and normalizer at the chunk's end.
        dec_k = torch.exp(total - cum) * ib            # [B, H, L]
        kd = dec_k[..., None] * kb                     # [B, H, L, Dh]
        c_in = torch.exp(total)[..., None] * c_in + kd.transpose(-1, -2) @ vb
        n_in = torch.exp(total) * n_in + kd.sum(dim=2)
    y = torch.cat(ys, dim=2)                           # [B, H, S, Dh]
    y = y.transpose(1, 2).reshape(b, s, d_inner).to(x.dtype)
    y = y * F.silu(z)
    return y @ params["w_down"].to(x.dtype), MlstmState(c_in, n_in)


def mlstm_decode(params, x, cfg, state: MlstmState):
    """Single-step mLSTM (``xlstm.py:183``). x [B, 1, D]."""
    b = x.shape[0]
    d_inner = _mlstm_dims(cfg)[0]
    q, k, v, i_gate, logf, z = _mlstm_qkvif(params, x, cfg)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]            # [B, H, Dh]
    i_t, f_t = i_gate[:, :, 0], torch.exp(logf[:, :, 0])    # [B, H]
    c_new = f_t[..., None, None] * state.c + i_t[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_t[..., None] * state.n + i_t[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    dn = torch.abs(torch.einsum("bhd,bhd->bh", q, n_new)).clamp_min(1.0)
    y = (num / dn[..., None]).reshape(b, 1, d_inner).to(x.dtype)
    y = y * F.silu(z)
    return y @ params["w_down"].to(x.dtype), MlstmState(c_new, n_new)


# -- sLSTM ---------------------------------------------------------------------


def slstm_decl(cfg) -> dict:
    d = cfg.d_model
    decl = {}
    for gate in GATES:
        decl[f"w_{gate}"] = ParamDecl((d, d), ("embed", "inner"))
        decl[f"r_{gate}"] = ParamDecl((d, d), (None, "inner"), scale=0.5)
        decl[f"b_{gate}"] = ParamDecl((d,), ("inner",), init="zeros")
    decl["w_out"] = ParamDecl((d, d), ("inner", "embed"))
    return decl


def slstm_state_decl(cfg, batch: int) -> dict:
    """An sLSTM block's state declarations (``xlstm.py:209``)."""
    d = cfg.d_model
    return {k: ParamDecl((batch, d), ("batch", None), init="zeros")
            for k in ("c", "n", "h")}


def init_slstm_state(cfg, batch: int, device=None) -> SlstmState:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SlstmState(c=z, n=z.clone(), h=z.clone())


def _gate_weights(params, kind: str) -> torch.Tensor:
    """The four gates' ``w_*`` or ``r_*`` side by side, f32 [D, 4D]."""
    return torch.cat([params[f"{kind}_{g}"].float() for g in GATES], dim=1)


def _slstm_step(pre_x, st: SlstmState, r_cat, b_cat):
    """One sLSTM step (``xlstm.py:232``) from the input's gate products
    ``pre_x`` [B, 4D] (``x_t @ W``, f32)."""
    pre = pre_x + st.h @ r_cat + b_cat
    i, f, zc, o = pre.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c = f * st.c + i * torch.tanh(zc)
    n = f * st.n + i
    h = o * c / n.clamp_min(1.0)
    return SlstmState(c=c, n=n, h=h)


def slstm_apply(params, x, cfg, state: SlstmState | None = None):
    """Sequential sLSTM (``xlstm.py:253``). x [B, S, D] -> (y, the final
    ``SlstmState``)."""
    b, s, _ = x.shape
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    pre_x = x.float() @ _gate_weights(params, "w")          # [B, S, 4D]
    r_cat = _gate_weights(params, "r")
    b_cat = torch.cat([params[f"b_{g}"].float() for g in GATES])
    hs = []
    for t in range(s):
        state = _slstm_step(pre_x[:, t], state, r_cat, b_cat)
        hs.append(state.h)
    hs = torch.stack(hs, dim=1)                               # [B, S, D]
    return hs.to(x.dtype) @ params["w_out"].to(x.dtype), state


def slstm_decode(params, x, cfg, state: SlstmState):
    """Single-step sLSTM (``xlstm.py:267``). x [B, 1, D]."""
    st = _slstm_step(x[:, 0].float() @ _gate_weights(params, "w"), state,
                     _gate_weights(params, "r"),
                     torch.cat([params[f"b_{g}"].float() for g in GATES]))
    return st.h[:, None].to(x.dtype) @ params["w_out"].to(x.dtype), st
