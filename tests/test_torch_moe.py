"""The port's MoE layer (``repro_torch/models/layers/moe.py``) against
``repro.models.layers.moe`` on the CPU.

Parameters are JAX's ``init_params(moe_decl(cfg), key)`` carried across
through numpy; the input is one numpy draw rounded to bf16 (the
activation type) the same way in both packages. JAX's ``moe_apply``
returns only (y, aux), so its routing is recomputed here from the same
lines (``moe.py:70-92``) with JAX's own ops: softmax, ``lax.top_k``, the
one-hot exclusive cumsum.

Tolerances, stated where they are used:

* routing (``top_i``, positions, ``kept``): exactly equal, once the
  case's router probabilities are checked to hold no near-tie: each
  token's k-th and (k+1)-th probabilities at least ``NEAR_TIE`` apart
  (the two f32 router matmuls sum in other orders, ~1e-8 on a
  probability); the zero router ties every expert on purpose and must
  pick JAX's lowest indices;
* output: within ``OUT_TOL`` of the output's scale (max |y|, at least
  1): both sides round the expert matmuls and the combine to bf16 at
  the same places, but sum in other orders: up to 5.5e-3 seen, 1.4
  bf16 ulps (2^-8) of the scale;
* aux: 1e-5 relative (f32 means in other orders).
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
from repro.configs.base import MoeConfig as JaxMoeConfig  # noqa: E402
from repro.models import module as jmod  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, MoeConfig  # noqa: E402
from repro_torch.models import module as mod  # noqa: E402
from repro_torch.models.layers import moe  # noqa: E402
from repro_torch.models.layers.mlp import swiglu  # noqa: E402

NEAR_TIE = 1e-6
OUT_TOL = 1e-2
AUX_RTOL = 1e-5


def _small(n_experts=4, top_k=2, d=64, d_expert=32, cf=1.25, gs=16,
           n_shared=0, cls=(ArchConfig, MoeConfig)):
    arch, moe_cfg = cls
    return arch(name="t", family="moe", source="test", n_layers=1,
                d_model=d, n_heads=2, n_kv_heads=2, d_ff=d_expert, vocab=64,
                moe=moe_cfg(n_experts=n_experts, top_k=top_k,
                            d_expert=d_expert, capacity_factor=cf,
                            group_size=gs, n_shared=n_shared))


def _smoke_layer(arch, **moe_kw):
    def make(get):
        cfg = get(arch)
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return make(get_smoke_config), make(jax_smoke_config)


def _case(**kw):
    return (_small(**kw), _small(**kw, cls=(JaxArchConfig, JaxMoeConfig)))


# name -> ((port cfg, JAX cfg), x shape, zero router)
CASES = {
    "olmoe_smoke": (_smoke_layer("olmoe_1b_7b"), (2, 64), False),
    "dbrx_smoke": (_smoke_layer("dbrx_132b"), (2, 48), False),
    # t = 130 with group_size 16: groups of 13, ten of them.
    "ragged_130": (_case(gs=16), (2, 65), False),
    # capacity factor 0.3: 3 slots an expert for 16 x 2 assignments.
    "drops": (_case(cf=0.3), (2, 32), False),
    "shared_moonshot": (_smoke_layer("moonshot_v1_16b_a3b"), (2, 64), False),
    "shared_drops": (_case(n_shared=1, cf=0.3), (1, 48), False),
    # A decode step: the batch's tokens are one group.
    "decode_group": (_smoke_layer("olmoe_1b_7b"), (4, 1), False),
    "zero_router": (_case(n_experts=4, top_k=2, cf=0.5), (2, 16), True),
}


def _inputs(case):
    (cfg, jcfg), (b, s), zero = CASES[case]
    seed = sorted(CASES).index(case)
    jparams = jmod.init_params(jmoe.moe_decl(jcfg), jax.random.key(seed))
    if zero:
        jparams = dict(jparams, router=jnp.zeros_like(jparams["router"]))
    tree = jax.tree.map(np.asarray, jparams)

    def leaf(v):
        return ({k: leaf(u) for k, u in v.items()} if isinstance(v, dict)
                else torch.tensor(v))

    x32 = np.random.default_rng(100 + seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    return (cfg, jcfg, leaf(tree), jparams,
            torch.tensor(x32).to(torch.bfloat16),
            jnp.asarray(x32).astype(jnp.bfloat16))


def _jax_routing(params, x, cfg):
    """``moe.py:61-92`` with JAX's ops: (probs, top_i, pos, kept)."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    gs = min(e.group_size, t)
    while t % gs:
        gs -= 1
    g = t // gs
    cap = jmoe._capacity(gs, e.top_k, e.n_experts, e.capacity_factor)
    xt = x.reshape(g, gs, d)
    logits = jnp.einsum("gtd,de->gte", xt.astype(jnp.float32),
                        params["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, e.top_k)
    onehot = jax.nn.one_hot(top_i, e.n_experts, dtype=jnp.float32)
    flat = onehot.reshape(g, gs * e.top_k, e.n_experts)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(g, gs, e.top_k)
    return probs, top_i, pos, pos < cap


def _assert_no_near_tie(probs, top_k):
    ranked = -np.sort(-probs, axis=-1)[..., :top_k + 1]
    gaps = ranked[..., :-1] - ranked[..., 1:]
    assert gaps.min() >= NEAR_TIE, gaps.min()


@pytest.mark.parametrize("case", list(CASES))
def test_moe_routing_and_output_match_jax(case):
    cfg, jcfg, params, jparams, x, jx = _inputs(case)
    probs, top_i, pos, kept = (np.asarray(a) for a in jax.jit(
        lambda p, v: _jax_routing(p, v, jcfg))(jparams, jx))
    zero = CASES[case][2]
    if zero:
        # Every expert ties: JAX keeps the lowest indices.
        assert (top_i == np.arange(cfg.moe.top_k)).all()
    else:
        _assert_no_near_tie(probs, cfg.moe.top_k)

    g, gs, cap = moe.group_shape(x.shape[0] * x.shape[1], cfg.moe)
    r = moe.route(params, x.reshape(g, gs, cfg.d_model), cfg.moe)
    assert r.capacity == cap
    np.testing.assert_array_equal(r.top_i.numpy(), top_i)
    np.testing.assert_array_equal(r.pos.numpy(), pos.astype(np.int64))
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    np.testing.assert_allclose(r.probs.numpy(), probs, rtol=1e-5, atol=1e-7)

    want, want_aux = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg))(
        jparams, jx)
    want = np.asarray(want, np.float32)
    got, aux = moe.moe_apply(params, x, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               atol=OUT_TOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=AUX_RTOL)
    if case in ("drops", "shared_drops"):
        assert not kept.all()
    if case == "drops":
        # A token whose every assignment was dropped gets exactly 0.
        dropped = ~kept.reshape(x.shape[0] * x.shape[1], -1).any(-1)
        assert dropped.any()
        rows = got.reshape(-1, cfg.d_model)[torch.tensor(dropped)]
        assert (rows == 0).all()


def test_single_expert_equals_dense_swiglu():
    """E = 1, k = 1, ample capacity: the layer is its one expert's SwiGLU,
    in the port (bit for bit: every weight is 1.0 in bf16) and in JAX."""
    cfg = _small(n_experts=1, top_k=1, cf=4.0)
    jcfg = _small(n_experts=1, top_k=1, cf=4.0,
                  cls=(JaxArchConfig, JaxMoeConfig))
    jparams = jmod.init_params(jmoe.moe_decl(jcfg), jax.random.key(9))
    params = {k: torch.tensor(np.asarray(v)) for k, v in jparams.items()}
    x32 = np.random.default_rng(9).normal(size=(2, 24, 64)).astype(np.float32)
    x = torch.tensor(x32).to(torch.bfloat16)
    got, _ = moe.moe_apply(params, x, cfg)
    dense = {n: params[n][0] for n in ("w_gate", "w_up", "w_down")}
    torch.testing.assert_close(got, swiglu(dense, x), rtol=0, atol=0)
    want, _ = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jcfg))(
        jparams, jnp.asarray(x32).astype(jnp.bfloat16))
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               atol=OUT_TOL, rtol=0)


def test_uniform_router_aux_is_one():
    """``tests/test_moe.py``'s switch normalizer: a zero router with
    top_k = E gives aux 1."""
    cfg = _small(n_experts=4, top_k=4, cf=8.0)
    params = mod.init_params(moe.moe_decl(cfg),
                             torch.Generator().manual_seed(1))
    params["router"].zero_()
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(2))
    _, aux = moe.moe_apply(params, x.to(torch.bfloat16), cfg)
    assert abs(aux.item() - 1.0) < 1e-6


@pytest.mark.parametrize("t,group_size,want", [
    (130, 16, (10, 13)), (128, 32, (4, 32)), (4, 256, (1, 4)),
    (2050, 256, (10, 205))])
def test_group_shape_is_the_largest_divisor(t, group_size, want):
    e = MoeConfig(n_experts=64, top_k=8, d_expert=8, group_size=group_size)
    g, gs, cap = moe.group_shape(t, e)
    assert (g, gs) == want
    assert cap == jmoe._capacity(gs, 8, 64, 1.25)
