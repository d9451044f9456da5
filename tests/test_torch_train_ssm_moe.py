"""The port's LM training against the JAX package on the CPU: hybrid
(hymba's mamba beside attention), xLSTM and MoE (olmoe) at their smoke
configs, then xLSTM under activation checkpointing, the attention
Function's gradient against ``jax.grad`` of JAX's attention, and the MoE
layer's gradient under random routers. ``tests/train_parity.py`` holds
the reference runs, the inputs and the model-level tolerances;
``tests/test_torch_train_families.py`` the other families.

Tolerances of this file, stated where they are used:

* the attention Function (q, k, v exact bf16 slices of x): dq, dk, dv
  within 1e-2 relative L2 of JAX's (JAX rounds dk / dv to bf16 a chunk
  at a time and sums the chunks in bf16; the port sums in f32);
* the MoE layer: relative L2 within ``MOE_LAYER_TOL`` = 2e-2 (bf16
  expert matmuls summed in other orders: below 1e-2 seen), after each
  token's k-th and (k+1)-th router probabilities are checked to be
  ``NEAR_TIE`` = 1e-6 apart (``tests/test_torch_moe.py``'s rule);
* remat against none: the same gradients to 1e-6 relative L2;
* the mamba, mLSTM and sLSTM layers alone on one bf16 input, every
  parameter's and the input's gradient: relative L2 within
  ``SSM_LAYER_TOL`` (sLSTM 1e-3: an f32 recurrence, 5.8e-5 seen, its bf16
  output projection; mLSTM 2e-2 and mamba 3e-2: bf16 projections and
  convolution rounded at the same places, summed in other orders, 5.9e-3
  and 1.1e-2 seen). At the model level the same layers' gradients carry
  the upstream bf16 differences through the recurrences (the families'
  ``GRAD_TOL``).
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import ArchConfig as JaxArchConfig  # noqa: E402
from repro.models import module as jmod  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers import mamba as jmamba  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro.models.layers import xlstm as jxlstm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models.layers import attention as attn_lib  # noqa: E402
from repro_torch.models.layers import mamba, moe, xlstm  # noqa: E402
from tests import train_parity as tp  # noqa: E402
from tests.train_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ["olmoe_1b_7b", "hymba_1p5b", "xlstm_350m"]
NEAR_TIE = 1e-6
MOE_LAYER_TOL = 2e-2
# layer -> (arch, JAX decl, JAX apply, port apply, tolerance)
SSM_LAYERS = {
    "mamba": ("hymba_1p5b", jmamba.mamba_decl, jmamba.mamba_scan,
              mamba.mamba_scan, 3e-2),
    "mlstm": ("xlstm_350m", jxlstm.mlstm_decl, jxlstm.mlstm_apply,
              xlstm.mlstm_apply, 2e-2),
    "slstm": ("xlstm_350m", jxlstm.slstm_decl, jxlstm.slstm_apply,
              xlstm.slstm_apply, 1e-3),
}


@pytest.fixture(scope="module")
def runs():
    """arch -> ``tp.jax_run(arch)``, each made on first use."""
    return {}


def _run(runs, arch):
    if arch not in runs:
        runs[arch] = tp.jax_run(arch)
    return runs[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(runs, arch):
    tp.check_loss(_run(runs, arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(runs, arch):
    tp.check_grads(_run(runs, arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(runs, arch):
    tp.check_step(_run(runs, arch), microbatches=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_train_step_matches_jax(runs, arch):
    tp.check_step(_run(runs, arch), microbatches=tp.MICROBATCHES)


def test_remat_gives_the_same_gradients(runs):
    """``cfg.remat`` checkpoints each xLSTM group: the same gradients as
    without it."""
    run = _run(runs, "xlstm_350m")
    plain = tp.leaves(tp.grads(*tp.model(run), run["batch"]))
    cfg = dataclasses.replace(run["cfg"], remat=True)
    remat = tp.leaves(tp.grads(*tp.model(run, cfg=cfg), run["batch"]))
    for (key, g), (_, w) in zip(remat, plain):
        assert tp.rel_l2(g, w) <= 1e-6, key


@pytest.mark.parametrize("layer", list(SSM_LAYERS))
def test_ssm_layer_gradients_match_jax(layer):
    """The mamba scan (out-of-place Hillis–Steele rounds), the chunkwise
    mLSTM and the sLSTM loop under autograd against ``jax.grad`` of
    JAX's layer, on the same parameters and bf16 input."""
    arch, decl, japply, apply, tol = SSM_LAYERS[layer]
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp = jmod.init_params(decl(jcfg), jax.random.key(3))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xb):
        y, _ = japply(p, xb, jcfg)
        return jnp.sum(y.astype(jnp.float32) * dy)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x, jnp.bfloat16))
    params = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in jp.items()}
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    y, _ = apply(params, xt, cfg)
    (y.float() * torch.tensor(dy)).sum().backward()
    for k, t in params.items():
        err = tp.rel_l2(tp.f32(t.grad), tp.f32(want_p[k]))
        assert err <= tol, (layer, k, err)
    assert tp.rel_l2(tp.f32(xt.grad), tp.f32(want_x)) <= tol


# -- the attention Function against jax.grad --------------------------------

# (S, q_chunk, window, causal, heads, kv heads, head dim): a window that
# binds (S a multiple of q_chunk, 4 chunks, GQA 4:2), a window wider
# than the slab's start clip, no window, and bidirectional attention.
ATTN_CASES = {
    "window_binds": (128, 32, 40, True, 4, 2, 16),
    "window_wide": (96, 32, 80, True, 4, 1, 16),
    "full_causal": (64, 16, None, True, 4, 2, 8),
    "not_causal": (64, 32, None, False, 2, 2, 16),
}


def _attn_cfg(cls, s_qc_w_c_h):
    _, qc, window, causal, h, hkv, dh = s_qc_w_c_h
    return cls(name="attn", family="dense", source="test", n_layers=1,
               d_model=(h + 2 * hkv) * dh, n_heads=h, n_kv_heads=hkv,
               d_head=dh, d_ff=8, vocab=8, window=window, causal=causal,
               q_chunk=qc, rope_pct=0.0, remat=False)


def _selectors(h, hkv, dh):
    """wq / wk / wv that read q, k, v as disjoint column blocks of x, and
    wo that writes the attention output into x's first h * dh columns:
    q, k, v are exact bf16 slices of x, and x's gradient holds dq, dk,
    dv."""
    d = (h + 2 * hkv) * dh
    eye = np.eye(d, dtype=np.float32)
    wq = eye[:, :h * dh].reshape(d, h, dh)
    wk = eye[:, h * dh:(h + hkv) * dh].reshape(d, hkv, dh)
    wv = eye[:, (h + hkv) * dh:].reshape(d, hkv, dh)
    wo = eye[:h * dh].reshape(h, dh, d)
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_function_gradients_match_jax(case):
    s, _, window, causal, h, hkv, dh = ATTN_CASES[case]
    cfg = _attn_cfg(ArchConfig, ATTN_CASES[case])
    jcfg = _attn_cfg(JaxArchConfig, ATTN_CASES[case])
    w = _selectors(h, hkv, dh)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)

    def jloss(xb):
        y, _ = jattn.attention({k: jnp.asarray(v) for k, v in w.items()},
                               xb, jnp.arange(s), jcfg)
        return jnp.sum(y.astype(jnp.float32) * dy)

    want = tp.f32(jax.jit(jax.grad(jloss))(jnp.asarray(x, jnp.bfloat16)))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    y, _ = attn_lib.attention({k: torch.tensor(v) for k, v in w.items()},
                              xt, torch.arange(s), cfg)
    (y.float() * torch.tensor(dy)).sum().backward()
    got = tp.f32(xt.grad)
    blocks = {"dq": slice(0, h * dh), "dk": slice(h * dh, (h + hkv) * dh),
              "dv": slice((h + hkv) * dh, None)}
    for name, cols in blocks.items():
        g, wnt = got[..., cols], want[..., cols]
        assert np.abs(wnt).max() > 0, (case, name)
        assert tp.rel_l2(g, wnt) <= 1e-2, (case, name, tp.rel_l2(g, wnt))


def test_attention_function_backward_never_builds_s_by_s(monkeypatch):
    """The backward works a q chunk at a time: no tensor holds S x S
    logits (S 256, q_chunk 32, window 40: the slab is 72 keys)."""
    cfg = _attn_cfg(ArchConfig, (256, 32, 40, True, 4, 2, 16))
    s = 256
    seen = []
    real = torch.softmax

    def softmax(t, *a, **k):
        seen.append(tuple(t.shape))
        return real(t, *a, **k)

    q, k, v = (torch.randn((1, n, s, 16), dtype=torch.bfloat16)
               for n in (4, 2, 2))
    dout = torch.randn((1, 4, s, 16), dtype=torch.bfloat16)
    monkeypatch.setattr(torch, "softmax", softmax)
    dq, dk, dv = attn_lib._swa_backward(q, k, v, dout, 40, True,
                                        attn_lib.q_chunk(s, cfg.q_chunk))
    assert seen and all(sh[-2:] == (32, 72) for sh in seen), seen
    assert dq.shape == q.shape and dk.shape == k.shape


# -- the MoE layer's gradient under random routers ---------------------------


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonshot_v1_16b_a3b"])
def test_moe_layer_gradients_match_jax(arch):
    """``moe_apply``'s gradient (router, experts, shared experts, input)
    against ``jax.grad`` of JAX's, on one bf16 input with the JAX init's
    random router: routing is checked first to hold no near-tie (each
    token's k-th and (k+1)-th probabilities ``NEAR_TIE`` apart)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jp = jmod.init_params(jmoe.moe_decl(jcfg), jax.random.key(1))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, xb):
        y, aux = jmoe.moe_apply(p, xb, jcfg)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux

    jx = jnp.asarray(x, jnp.bfloat16)
    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)

    def leaf(v):
        return ({k: leaf(u) for k, u in v.items()} if isinstance(v, dict)
                else torch.tensor(v, requires_grad=True))

    params = leaf(tree)
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    g, gs, _ = moe.group_shape(2 * 64, cfg.moe)
    probs = moe.route(params, xt.detach().reshape(g, gs, -1), cfg.moe).probs
    ranked = -np.sort(-tp.f32(probs), axis=-1)[..., :cfg.moe.top_k + 1]
    assert (ranked[..., :-1] - ranked[..., 1:]).min() >= NEAR_TIE
    y, aux = moe.moe_apply(params, xt, cfg)
    ((y.float() * torch.tensor(dy)).sum() + aux).backward()
    got = tp.leaves(jax.tree.map(lambda t: t.grad, params))
    for (key, gv), (_, w) in zip(got, tp.leaves(want_p)):
        err = tp.rel_l2(gv, w)
        assert err <= MOE_LAYER_TOL, (arch, key, err)
    assert tp.rel_l2(tp.f32(xt.grad), tp.f32(want_x)) <= MOE_LAYER_TOL
