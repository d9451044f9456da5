"""The port's recurrent and encoder layers against the JAX package's, on
the CPU: mamba (``mamba_scan``, ``mamba_decode_step``), mLSTM and sLSTM
(``*_apply``, ``*_decode``), ``layernorm`` and ``gelu_mlp``.

Each layer runs on the same weights (JAX's ``init_params`` of the
layer's declarations, key 0, carried across as f32 tensors) and the same
inputs, made from numpy seeds, in both packages. The layers' configs are
hymba-smoke's (d 128, state 8, chunk 32) and xlstm-smoke's (d 128, 2
heads, chunk 32).

Tolerances, stated where they are used:

* f32 inputs: every output and state within ``F32_TOL`` = 1e-5 of its
  own scale (``max |want|``): the two packages compute the same f32
  arithmetic and differ only in the order of adds (the scans' log-depth
  combining order, matmul sums) and in the last bit of ``exp``;
* bf16 inputs: outputs within the zoo's ``LOGIT_TOL`` = 0.15 of their
  scale and states within its ``KV_TOL`` = 3e-2 (atol and rtol on values
  divided by their scale), ``tests/test_torch_llm_zoo.py``'s contract:
  both round to bf16 at the same places but sum in other orders.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import module as jmod  # noqa: E402
from repro.models.layers import mamba as jmamba  # noqa: E402
from repro.models.layers import mlp as jmlp  # noqa: E402
from repro.models.layers import norms as jnorms  # noqa: E402
from repro.models.layers import xlstm as jxlstm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.layers import mamba, mlp, norms, xlstm  # noqa: E402

F32_TOL = 1e-5
LOGIT_TOL, KV_TOL = 0.15, 3e-2
B = 2


def _weights(decl, seed=0):
    """JAX's init of ``decl`` (key ``seed``): (jax arrays, torch f32)."""
    jp = jmod.init_params(decl, jax.random.key(seed))
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32)), jp)
    return jp, tp


def _x(seed, s, d, dtype):
    x = np.random.default_rng(seed).normal(size=(B, s, d)).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.tensor(x).to(getattr(torch, dtype)))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               rtol=tol, err_msg=what)


def _states_close(got, want, tol, what):
    for f in got._fields:
        _close(getattr(got, f), getattr(want, f), tol, f"{what}.{f}")


@pytest.fixture(scope="module")
def hymba():
    jcfg, cfg = (jax_smoke_config("hymba_1p5b"),
                 get_smoke_config("hymba_1p5b"))
    assert cfg.ssm.chunk == 32
    return jcfg, cfg, _weights(jmamba.mamba_decl(jcfg))


@pytest.fixture(scope="module")
def xl():
    jcfg, cfg = (jax_smoke_config("xlstm_350m"),
                 get_smoke_config("xlstm_350m"))
    return (jcfg, cfg, _weights(jxlstm.mlstm_decl(jcfg), 1),
            _weights(jxlstm.slstm_decl(jcfg), 2))


def _jmamba_state(st):
    return jmamba.MambaState(*(jnp.asarray(_np(t)) for t in st))


# S = 64 runs two chunks of 32; S = 48 is no multiple of the chunk, so
# both packages take its largest divisor below 32 (24).
@pytest.mark.parametrize("s", [64, 48])
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_scan_and_decode_match_jax_f32(hymba, s, carried):
    """``mamba_scan`` from a zero or a carried state (a first scan over 40
    positions), then ``mamba_decode_step`` chained after it for three
    tokens, each step's output and state held to JAX's."""
    jcfg, cfg, (jp, tp) = hymba
    d = cfg.d_model
    jstate = tstate = None
    if carried:
        jx0, tx0 = _x(9, 40, d, "float32")
        _, jstate = jax.jit(jmamba.mamba_scan, static_argnums=2)(jp, jx0,
                                                                  jcfg)
        _, tstate = mamba.mamba_scan(tp, tx0, cfg)
        _states_close(tstate, jstate, F32_TOL, "first scan")
    jx, tx = _x(s, s + 3, d, "float32")
    want, jst = jax.jit(jmamba.mamba_scan, static_argnums=2)(
        jp, jx[:, :s], jcfg, jstate)
    got, st = mamba.mamba_scan(tp, tx[:, :s], cfg, tstate)
    _close(got, want, F32_TOL, "scan output")
    _states_close(st, jst, F32_TOL, "scan state")
    step = jax.jit(jmamba.mamba_decode_step, static_argnums=2)
    for t in range(s, s + 3):
        want, jst = step(jp, jx[:, t:t + 1], jcfg, jst)
        got, st = mamba.mamba_decode_step(tp, tx[:, t:t + 1], cfg, st)
        _close(got, want, F32_TOL, f"decode output {t}")
        _states_close(st, jst, F32_TOL, f"decode state {t}")


def test_mamba_scan_matches_jax_bf16_and_under_a_bf16_scan(hymba):
    """bf16 activations, as the model runs them, with the f32 scan and
    with ``scan_dtype="bfloat16"`` (the intra-chunk scan in bf16, the
    chunk-boundary carry in f32, as JAX keeps it)."""
    jcfg, cfg, (jp, tp) = hymba
    jx, tx = _x(3, 96, cfg.d_model, "bfloat16")
    for scan_dtype in ("float32", "bfloat16"):
        jc, c = (dataclasses.replace(k, ssm=dataclasses.replace(
            k.ssm, scan_dtype=scan_dtype)) for k in (jcfg, cfg))
        want, jst = jax.jit(jmamba.mamba_scan, static_argnums=2)(jp, jx, jc)
        got, st = mamba.mamba_scan(tp, tx, c)
        assert got.dtype == torch.bfloat16 and st.conv.dtype == torch.bfloat16
        _close(got, want, LOGIT_TOL, scan_dtype)
        _states_close(st, jst, KV_TOL, scan_dtype)


def test_prefix_scan_is_the_sequential_recurrence():
    """The log-depth scan equals the recurrence s_t = a_t s_{t-1} + b_t
    run one position at a time (f64, so only the order of adds differs),
    at a length that is no power of two."""
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.uniform(0.5, 1.0, (2, 37, 3)))
    b = torch.tensor(rng.normal(size=(2, 37, 3)))
    want_a, want_b = torch.empty_like(a), torch.empty_like(b)
    pa, pb = torch.ones_like(a[:, 0]), torch.zeros_like(b[:, 0])
    for t in range(a.shape[1]):
        pa, pb = pa * a[:, t], pb * a[:, t] + b[:, t]
        want_a[:, t], want_b[:, t] = pa, pb
    got_a, got_b = mamba._prefix_scan(a.clone(), b.clone())
    torch.testing.assert_close(got_a, want_a, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_b, want_b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_apply_matches_jax_and_splits_with_the_state_carried(xl,
                                                                   dtype):
    """One call over 96 positions (3 chunks) against JAX's; two calls
    (64 + 32) with the state carried against one call, in both packages;
    then ``mlstm_decode`` for two tokens after the split run."""
    jcfg, cfg, (jp, tp), _ = xl
    out_tol, st_tol = ((F32_TOL, F32_TOL) if dtype == "float32"
                       else (LOGIT_TOL, KV_TOL))
    jx, tx = _x(21, 98, cfg.d_model, dtype)
    apply = jax.jit(jxlstm.mlstm_apply, static_argnums=2)
    want, jst = apply(jp, jx[:, :96], jcfg)
    got, st = xlstm.mlstm_apply(tp, tx[:, :96], cfg)
    _close(got, want, out_tol, "one call")
    _states_close(st, jst, st_tol, "one call")

    y1, st1 = xlstm.mlstm_apply(tp, tx[:, :64], cfg)
    y2, st2 = xlstm.mlstm_apply(tp, tx[:, 64:96], cfg, st1)
    # Split against whole, in the port: the chunks are the same 32
    # positions and f32 states, so only the rounding of the output's
    # bf16 cast may differ.
    _close(torch.cat([y1, y2], 1), got, out_tol, "split vs one call")
    _states_close(st2, st, F32_TOL, "split vs one call")
    jy1, jst1 = apply(jp, jx[:, :64], jcfg)
    jy2, jst2 = apply(jp, jx[:, 64:96], jcfg, jst1)
    _close(y2, jy2, out_tol, "split, second call")
    _states_close(st2, jst2, st_tol, "split, second call")

    step = jax.jit(jxlstm.mlstm_decode, static_argnums=2)
    for t in (96, 97):
        want, jst2 = step(jp, jx[:, t:t + 1], jcfg, jst2)
        got, st2 = xlstm.mlstm_decode(tp, tx[:, t:t + 1], cfg, st2)
        _close(got, want, out_tol, f"decode {t}")
        _states_close(st2, jst2, st_tol, f"decode {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_apply_and_decode_match_jax(xl, dtype):
    """``slstm_apply`` over 40 positions from a zero state and from a
    carried one, then ``slstm_decode`` for two tokens."""
    jcfg, cfg, _, (jp, tp) = xl
    out_tol, st_tol = ((F32_TOL, F32_TOL) if dtype == "float32"
                       else (LOGIT_TOL, KV_TOL))
    jx, tx = _x(31, 82, cfg.d_model, dtype)
    apply = jax.jit(jxlstm.slstm_apply, static_argnums=2)
    jst = st = None
    for lo, hi in ((0, 40), (40, 80)):
        want, jst = apply(jp, jx[:, lo:hi], jcfg, jst)
        got, st = xlstm.slstm_apply(tp, tx[:, lo:hi], cfg, st)
        _close(got, want, out_tol, f"apply {lo}")
        _states_close(st, jst, st_tol, f"apply {lo}")
    step = jax.jit(jxlstm.slstm_decode, static_argnums=2)
    for t in (80, 81):
        want, jst = step(jp, jx[:, t:t + 1], jcfg, jst)
        got, st = xlstm.slstm_decode(tp, tx[:, t:t + 1], cfg, st)
        _close(got, want, out_tol, f"decode {t}")
        _states_close(st, jst, st_tol, f"decode {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_gelu_mlp_match_jax(dtype):
    """hubert-smoke's widths (d 128, d_ff 256), with non-trivial scale,
    bias and biases (normal draws in place of the zeros / ones init).
    ``gelu_mlp`` takes the tanh form of GeLU, ``jax.nn.gelu``'s default."""
    rng = np.random.default_rng(41)
    d, d_ff = 128, 256
    ln = {"scale": rng.normal(1.0, 0.2, d), "bias": rng.normal(0, 0.2, d)}
    ff = {"w_in": rng.normal(0, d ** -0.5, (d, d_ff)),
          "b_in": rng.normal(0, 0.1, d_ff),
          "w_out": rng.normal(0, d_ff ** -0.5, (d_ff, d)),
          "b_out": rng.normal(0, 0.1, d)}
    jl, tl = ({k: f(np.float32(v)) for k, v in ln.items()}
              for f in (jnp.asarray, torch.tensor))
    jf, tf = ({k: f(np.float32(v)) for k, v in ff.items()}
              for f in (jnp.asarray, torch.tensor))
    jx, tx = _x(43, 24, d, dtype)
    tol = F32_TOL if dtype == "float32" else KV_TOL
    want = jax.jit(jnorms.layernorm)(jl, jx + 0.5)
    got = norms.layernorm(tl, tx + 0.5)
    assert got.dtype == tx.dtype
    _close(got, want, tol, "layernorm")
    want = jax.jit(jmlp.gelu_mlp)(jf, jx)
    got = mlp.gelu_mlp(tf, tx)
    _close(got, want, tol if dtype == "float32" else LOGIT_TOL, "gelu_mlp")
