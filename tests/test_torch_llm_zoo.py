"""The port's MoE family (olmoe-1b-7b, moonshot-v1-16b-a3b, dbrx-132b)
and dense full-attention archs (stablelm-3b, granite-34b) against the
JAX package, on the CPU; and the configuration counts and ``serve.main``
of every arch of the zoo.

Each arch's smoke config with the JAX parameters of
``bundle.init(jax.random.key(0))`` carried across by
``convert.params_from_numpy``; batch 2, a 64-token prompt from
``make_batch``. The port's prefill attention runs ``ops.swa_attention``'s
plain version here (CPU tensors), with ``window=None``.

Tolerances, stated where they are used:

* logits: ``tests/test_decode.py``'s contract, values within 0.15 of
  the logits' scale and greedy tokens equal wherever the top-1 gap
  exceeds 0.05 of that scale (the packages round to bf16 at the same
  places but sum in other orders; the MoE routing itself is exact, see
  ``tests/test_torch_moe.py``);
* cache k / v: atol and rtol 3e-2, a few bf16 ulps of values of order 1;
* ``pos``, ``length``, parameter counts: exactly equal.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.factory import build as jax_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.factory import build  # noqa: E402

ARCHS = ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "dbrx_132b", "stablelm_3b",
         "granite_34b"]
# The hybrid, xLSTM, VLM and audio families: their parity with JAX is
# tests/test_torch_llm_families.py's; here only their counts and serve.
FAMILIES = ["hymba_1p5b", "xlstm_350m", "phi3_vision_4p2b", "hubert_xlarge"]
LOGIT_TOL, GAP = 0.15, 0.05
KV_TOL = 3e-2
S, DECODE_STEPS = 64, 8


def _np(x):
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    """One arch: both models, JAX's prefill over S tokens and JAX's
    teacher-forced decode logits and caches after each of 8 steps."""
    arch = request.param
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jbundle = jax_build(jcfg)
    jparams = jbundle.init(jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
    toks = jax_tokens.make_batch(jcfg, 2, S + DECODE_STEPS, seed=5)["tokens"]
    logits, jcaches = jax.jit(jbundle.prefill)(
        jparams, {"tokens": jnp.asarray(toks[:, :S])})

    @jax.jit
    def jstep(caches, tok):
        x = jtfm.embed_tokens(jparams, tok, jcfg)
        h, caches = jtfm.decode_step(jparams, x, jcfg, caches)
        return jtfm.logits_from_hidden(jparams, h, jcfg), caches

    steps, c = [], jcaches
    for t in range(DECODE_STEPS):
        want, c = jstep(c, jnp.asarray(toks[:, S + t:S + t + 1]))
        steps.append((_np(want), jax.tree.map(_np, c)))
    return dict(arch=arch, cfg=cfg, params=params, toks=toks,
                logits=_np(logits), caches=jax.tree.map(_np, jcaches),
                steps=steps)


def _assert_logits_close(got, want, vocab):
    got = np.asarray(got, np.float32)[..., :vocab]
    want = want[..., :vocab]
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    disagree = got.argmax(-1) != want.argmax(-1)
    if disagree.any():
        top2 = np.sort(want, axis=-1)
        gap = (top2[..., -1] - top2[..., -2]) / scale
        assert np.all(gap[disagree] < GAP), gap[disagree]


def _first_dense(cfg) -> bool:
    return cfg.moe is not None and cfg.moe.first_dense


def _jax_pair(jcaches):
    """JAX's ``(caches0, stacked)`` as the port's layer-0-first arrays."""
    caches0, stacked = jcaches
    if caches0 is None:
        return stacked
    return {f: np.concatenate([caches0[f][None], stacked[f]])
            for f in stacked}


def test_prefill_logits_and_caches_match_jax(zoo):
    cfg = zoo["cfg"]
    bundle = build(cfg, device="cpu")
    logits, caches = bundle.prefill(
        zoo["params"], {"tokens": torch.tensor(zoo["toks"][:, :S])})
    assert logits.shape == (2, 1, cfg.padded_vocab)
    _assert_logits_close(logits.float().numpy(), zoo["logits"], cfg.vocab)

    got0, got = convert.caches_to_numpy(caches,
                                        first_dense=_first_dense(cfg))
    caches0, stacked = zoo["caches"]
    assert (caches0 is None) == (got0 is None) != _first_dense(cfg)
    pairs = [(got, stacked)] + ([] if caches0 is None else [(got0, caches0)])
    for mine, want in pairs:
        # Full attention: the cache holds exactly the prompt's S slots.
        assert mine["k"].shape[-2] == S
        np.testing.assert_array_equal(mine["pos"], want["pos"])
        np.testing.assert_array_equal(mine["length"], want["length"])
        for f in ("k", "v"):
            np.testing.assert_allclose(mine[f], want[f], atol=KV_TOL,
                                       rtol=KV_TOL, err_msg=f)


def test_teacher_forced_decode_matches_jax(zoo):
    """8 decode steps from JAX's prefill cache (moonshot's ``(caches0,
    stacked)`` pair through ``convert``), the same token fed to both
    packages each step."""
    cfg, params, toks = zoo["cfg"], zoo["params"], zoo["toks"]
    caches = convert.caches_from_numpy(zoo["caches"], device="cpu")
    assert caches.k.shape[0] == cfg.n_layers
    for t, (want, jcaches) in enumerate(zoo["steps"]):
        x = tfm.embed_tokens(params, torch.tensor(toks[:, S + t:S + t + 1]),
                             cfg)
        with torch.no_grad():
            h, caches = tfm.decode_step(params, x, cfg, caches)
            got = tfm.logits_from_hidden(params, h, cfg)
        _assert_logits_close(got.float().numpy(), want, cfg.vocab)
        want_caches = _jax_pair(jcaches)
        np.testing.assert_array_equal(caches.pos.numpy(), want_caches["pos"])
        np.testing.assert_array_equal(caches.length.numpy(),
                                      want_caches["length"])


def test_full_attention_decode_evicts_position_zero(zoo):
    """The reference's decode-slot rule with ``window=None``: the prefill
    cache holds S slots, so the first decode step writes slot S % S = 0
    and position 0 is gone, in JAX and in the port alike."""
    cfg = zoo["cfg"]
    assert cfg.window is None
    bundle = build(cfg, device="cpu")
    _, caches = bundle.prefill(
        zoo["params"], {"tokens": torch.tensor(zoo["toks"][:, :S])})
    assert (caches.pos[..., :3] == torch.tensor([0, 1, 2])).all()
    bundle.decode(zoo["params"], caches,
                  torch.tensor(zoo["toks"][:, S:S + 1]))
    want = _jax_pair(zoo["steps"][0][1])["pos"]
    assert (want[..., 0] == S).all() and (want[..., 1] == 1).all()
    assert (caches.pos[..., 0] == S).all() and (caches.pos[..., 1] == 1).all()
    np.testing.assert_array_equal(caches.pos.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_equals_full_forward(arch):
    """``tests/test_decode.py``'s contract on the port, on that test's
    inputs (JAX's parameters of key 0, ``make_batch(cfg, 2, 65, 0)``):
    with the capacity factor raised to 8, so that no token is dropped in
    either grouping, prefill over 64 tokens and decode token 65 give a
    full pass's last logits. The drift is the reference's own: on these
    inputs JAX's scaled error is 0.036-0.146 across the five archs and
    the port's within 0.01 of it."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    if cfg.moe is not None:
        cfg, jcfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=8.0))
            for c in (cfg, jcfg))
    jparams = jax_build(jcfg).init(jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
    bundle = build(cfg, device="cpu")
    toks = torch.tensor(tokens.make_batch(cfg, 2, S + 1, 0)["tokens"])
    _, caches = bundle.prefill(params, {"tokens": toks[:, :-1]})
    with torch.no_grad():
        x = tfm.embed_tokens(params, toks, cfg)
        h, _, aux = tfm.forward_full(params, x, torch.arange(S + 1), cfg)
        want = tfm.logits_from_hidden(params, h[:, -1:], cfg)
        x1 = tfm.embed_tokens(params, toks[:, -1:], cfg)
        h1, _ = tfm.decode_step(params, x1, cfg, caches)
        got = tfm.logits_from_hidden(params, h1, cfg)
    assert (aux.item() > 0) == (cfg.moe is not None)
    _assert_logits_close(got.float().numpy(), want.float().numpy(), cfg.vocab)


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_config_counts_match_jax(arch):
    """``param_count``, ``active_param_count`` and ``subquadratic`` of the
    full config equal JAX's (subquadratic: the hybrid and xLSTM families
    only); the smoke model holds ``param_count`` parameters plus the final
    norm, except moonshot's, whose dense layer 0 (a SwiGLU of 4 *
    d_expert) ``param_count`` counts as an MoE layer. For the hybrid,
    xLSTM, VLM and audio families, whose ``param_count`` is JAX's rough
    analytic count, the smoke model holds exactly the parameters of JAX's
    declaration tree."""
    full, jfull = get_config(arch), jax_get_config(arch)
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    assert full.subquadratic == jfull.subquadratic == (
        full.family in ("hybrid", "ssm"))
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "window", "head_dim", "padded_vocab", "rope_pct",
              "moe"):
        assert getattr(full, f) == getattr(jfull, f) or (
            f == "moe" and full.moe.__dict__ == jfull.moe.__dict__), f

    cfg = get_smoke_config(arch)
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in params.parameters())
    if arch in FAMILIES:
        decls = jax.tree.leaves(jtfm.model_decl(jax_smoke_config(arch)),
                                is_leaf=lambda d: hasattr(d, "shape"))
        assert n == sum(int(np.prod(d.shape)) for d in decls)
        return
    gap = 0
    if _first_dense(cfg):
        d, e = cfg.d_model, cfg.moe
        gap = (d * e.n_experts + (e.n_experts + e.n_shared) * 3 * d
               * e.d_expert) - 3 * d * 4 * e.d_expert
        assert gap == 25_088   # 123,392 counted, 98,304 held
    assert n == cfg.param_count() + cfg.d_model - gap


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_serve_main_generates_for_every_ported_arch(arch):
    """``serve.main`` on the CPU for every arch of the zoo (phi3v-smoke's
    40 positions are 16 patches and 24 tokens); hubert, an encoder, exits
    as JAX's does."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "40", "--gen", "4"]
    if not get_smoke_config(arch).decoder:
        with pytest.raises(SystemExit, match="encoder-only; nothing to "
                                             "decode"):
            serve.main(argv)
        return
    out = serve.main(argv)
    assert out.shape == (2, 4) and out.dtype == np.int32
    assert ((out >= 0) & (out < get_smoke_config(arch).vocab)).all()


def test_dbrx_smoke_refuses_the_card(monkeypatch):
    """dbrx-smoke's head dim 16 is no width ``swa_attention`` is built
    for: its first prefill on the card raises in the kernel's wrapper,
    before any launch (the card's branch is taken here by treating the
    CPU tensors as the card's; ``tests/test_torch_kernels_gpu.py`` drives
    ``serve.main --device cuda`` on a card). On the CPU it serves, and the
    full config's head dim of 128 is one K7 takes."""
    cfg = get_smoke_config("dbrx_132b")
    assert cfg.head_dim == 16
    bundle = build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    prompt = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    logits, _ = bundle.prefill(params, prompt)
    assert torch.isfinite(logits.float()).all()
    before = ops.launch_counts()["swa_attention"]
    monkeypatch.setattr(ops, "_on_cpu", lambda *tensors: False)
    with pytest.raises(ValueError, match="head_dim 16"):
        bundle.prefill(params, prompt)
    assert ops.launch_counts()["swa_attention"] == before
    assert get_config("dbrx_132b").head_dim in ops.SWA_HEAD_DIMS
