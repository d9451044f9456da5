"""The port's LLM serving slice (h2o-danube, dense SWA) against the JAX
package, on the CPU.

``danube-smoke`` (2 layers, d 128, 4 q heads over 2 kv heads, window 32)
with the JAX parameters of ``bundle.init(jax.random.key(0))`` carried
across by ``convert.params_from_numpy``; batch 2, prompts of 64 and 96
tokens from ``make_batch`` (96 is three windows and no multiple of a
64-row block). The port's prefill attention runs ``ops.swa_attention``'s
plain version here (CPU tensors).

Tolerances, stated where they are used:

* logits: ``tests/test_decode.py``'s contract, values within 0.15 of
  the logits' scale (atol and rtol on logits divided by
  ``max(|logits|, 1)``), and greedy tokens equal wherever the top-1 gap
  exceeds 0.05 of that scale: both packages round to bf16 at the same
  places, but their matmuls sum in other orders;
* cache k / v: atol 3e-2 and rtol 3e-2, a few bf16 ulps of values of
  order 1 (one rounding of a bf16 projection and of rope each);
* ``pos``, ``length`` and the token pipeline: exactly equal.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.factory import build as jax_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import module as mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.factory import build  # noqa: E402

ARCH = "h2o_danube_1p8b"
LOGIT_TOL, GAP = 0.15, 0.05
KV_TOL = 3e-2
PROMPTS = [64, 96]


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jbundle = jax_build(jcfg)
    jparams = jbundle.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    bundle = build(cfg, device="cpu")
    params = convert.params_from_numpy(tree, cfg, device="cpu")
    return jcfg, jbundle, jparams, cfg, bundle, params


@pytest.fixture(scope="module")
def jax_prefill(models):
    jcfg, jbundle, jparams = models[:3]
    fn = jax.jit(jbundle.prefill)
    out = {}
    for s in PROMPTS:
        batch = jax_tokens.make_batch(jcfg, 2, s + 8, seed=s)
        toks = batch["tokens"]
        logits, caches = fn(jparams, {"tokens": jnp.asarray(toks[:, :s])})
        out[s] = (toks, np.asarray(logits, np.float32), caches)
    return out


def _assert_logits_close(got, want):
    got = np.asarray(got, np.float32)[..., :want.shape[-1]]
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    disagree = got.argmax(-1) != want.argmax(-1)
    if disagree.any():
        top2 = np.sort(want, axis=-1)
        gap = (top2[..., -1] - top2[..., -2]) / scale
        assert np.all(gap[disagree] < GAP), gap[disagree]


def _port_logits(t):
    return t.float().numpy()


@pytest.mark.parametrize("s", PROMPTS)
def test_prefill_logits_match_jax(models, jax_prefill, s):
    cfg, bundle, params = models[3:]
    toks, want, _ = jax_prefill[s]
    before = ops.launch_counts()["swa_attention"]
    logits, _ = bundle.prefill(params, {"tokens": torch.tensor(toks[:, :s])})
    assert ops.launch_counts()["swa_attention"] == before  # CPU: plain
    assert logits.shape == (2, 1, cfg.padded_vocab)
    _assert_logits_close(_port_logits(logits)[..., :cfg.vocab],
                         want[..., :cfg.vocab])


@pytest.mark.parametrize("s", PROMPTS)
def test_prefill_caches_match_jax(models, jax_prefill, s):
    cfg, bundle, params = models[3:]
    toks, _, jcaches = jax_prefill[s]
    _, caches = bundle.prefill(params, {"tokens": torch.tensor(toks[:, :s])})
    caches0, got = convert.caches_to_numpy(caches)
    assert caches0 is None and jcaches[0] is None
    want = jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if x.dtype == jnp.bfloat16 else np.asarray(x),
                        jcaches[1])
    clen = min(cfg.window, s)
    assert got["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, clen,
                              cfg.head_dim)
    # The rolling buffer: position p sits in slot p % window.
    np.testing.assert_array_equal(got["pos"], want["pos"])
    np.testing.assert_array_equal(got["pos"] % clen,
                                  np.broadcast_to(np.arange(clen),
                                                  got["pos"].shape))
    np.testing.assert_array_equal(got["length"], want["length"])
    for f in ("k", "v"):
        np.testing.assert_allclose(got[f], want[f], atol=KV_TOL, rtol=KV_TOL,
                                   err_msg=f)


@pytest.mark.parametrize("s", PROMPTS)
def test_teacher_forced_decode_matches_jax(models, jax_prefill, s):
    """8 decode steps from the JAX prefill cache, the same token fed to
    both packages each step: JAX ``decode_step`` + ``logits_from_hidden``
    against the port's."""
    jcfg, _, jparams, cfg, _, params = models
    toks, _, jcaches = jax_prefill[s]
    caches = convert.caches_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32)
                     if x.dtype == jnp.bfloat16 else np.asarray(x),
                     jcaches), device="cpu")

    @jax.jit
    def jstep(caches, tok):
        x = jtfm.embed_tokens(jparams, tok, jcfg)
        h, caches = jtfm.decode_step(jparams, x, jcfg, caches)
        return jtfm.logits_from_hidden(jparams, h, jcfg), caches

    for t in range(8):
        tok = toks[:, s + t:s + t + 1]
        want, jcaches = jstep(jcaches, jnp.asarray(tok))
        x = tfm.embed_tokens(params, torch.tensor(tok), cfg)
        with torch.no_grad():
            h, caches = tfm.decode_step(params, x, cfg, caches)
            got = tfm.logits_from_hidden(params, h, cfg)
        _assert_logits_close(_port_logits(got)[..., :cfg.vocab],
                             np.asarray(want, np.float32)[..., :cfg.vocab])
    np.testing.assert_array_equal(caches.length.numpy(),
                                  np.asarray(jcaches[1]["length"]))
    np.testing.assert_array_equal(caches.pos.numpy(),
                                  np.asarray(jcaches[1]["pos"]))


@pytest.mark.parametrize("s", PROMPTS)
def test_prefill_plus_decode_equals_full_forward(models, s):
    """The port's own contract (``tests/test_decode.py:86-94``): prefill
    over S tokens, then decode token S+1, against a full pass over S+1."""
    cfg, bundle, params = models[3:]
    toks = torch.tensor(tokens.make_batch(cfg, 2, s + 1, seed=1)["tokens"])
    _, caches = bundle.prefill(params, {"tokens": toks[:, :-1]})
    with torch.no_grad():
        x = tfm.embed_tokens(params, toks, cfg)
        h, _, _ = tfm.forward_full(params, x, torch.arange(s + 1), cfg)
        want = tfm.logits_from_hidden(params, h[:, -1:], cfg)
        x1 = tfm.embed_tokens(params, toks[:, -1:], cfg)
        h1, _ = tfm.decode_step(params, x1, cfg, caches)
        got = tfm.logits_from_hidden(params, h1, cfg)
    _assert_logits_close(_port_logits(got)[..., :cfg.vocab],
                         _port_logits(want)[..., :cfg.vocab])


def test_decode_from_an_empty_cache_equals_full_forward(models):
    """``init_cache`` slots start at position -1 (masked): decoding three
    tokens into an empty cache sees only what was written, as a full pass
    over the same three tokens does."""
    from repro_torch.models.layers.attention import KVCache, init_cache

    cfg, _, params = models[3:]
    toks = torch.tensor(tokens.make_batch(cfg, 2, 3, seed=2)["tokens"])
    empty = [init_cache(cfg, 2, cfg.window) for _ in range(cfg.n_layers)]
    caches = KVCache(*(torch.stack(leaves) for leaves in zip(*empty)))
    with torch.no_grad():
        for t in range(3):
            x1 = tfm.embed_tokens(params, toks[:, t:t + 1], cfg)
            h1, caches = tfm.decode_step(params, x1, cfg, caches)
        got = tfm.logits_from_hidden(params, h1, cfg)
        x = tfm.embed_tokens(params, toks, cfg)
        h, _, _ = tfm.forward_full(params, x, torch.arange(3), cfg)
        want = tfm.logits_from_hidden(params, h[:, -1:], cfg)
    assert caches.length.eq(3).all()
    assert caches.pos[..., :3].eq(torch.arange(3, dtype=torch.int32)).all()
    assert caches.pos[..., 3:].eq(-1).all()
    _assert_logits_close(_port_logits(got)[..., :cfg.vocab],
                         _port_logits(want)[..., :cfg.vocab])


def test_serve_main_returns_generated_tokens():
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "40", "--gen", "5"])
    assert out.shape == (2, 5)
    assert out.dtype == np.int32
    cfg = get_smoke_config(ARCH)
    assert ((out >= 0) & (out < cfg.vocab)).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_token_pipeline_and_make_batch_equal_jax(seed):
    jcfg = jax_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    a = tokens.TokenPipeline(32000, seed=seed)
    b = jax_tokens.TokenPipeline(32000, seed=seed)
    for shape in ((4, 33), (2, 7)):   # successive draws of one pipeline
        np.testing.assert_array_equal(a.sample(*shape), b.sample(*shape))
    np.testing.assert_array_equal(
        tokens.make_batch(cfg, 3, 50, seed=seed)["tokens"],
        jax_tokens.make_batch(jcfg, 3, 50, seed=seed)["tokens"])


def test_config_and_init_scale_match_jax():
    """The full config's fields and parameter count equal the JAX
    package's; every initialised tensor of the smoke model has
    ``_materialize``'s std (fan_in over all leading dims, stacking
    included) within 5%, and the model holds ``param_count`` parameters
    plus the final norm."""
    from repro.configs import get_config as jax_get_config

    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "window", "head_dim", "padded_vocab", "norm_eps", "rope_theta"):
        assert getattr(full, f) == getattr(jfull, f), f
    assert full.param_count() == jfull.param_count() == 1_831_198_720

    cfg = get_smoke_config(ARCH)
    bundle = build(cfg, device="cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in params.parameters())
    assert n == cfg.param_count() + cfg.d_model
    decls = bundle.decls
    checks = [(params.embed, decls["embed"]), (params.head, decls["head"])]
    for name in ("wq", "wk", "wv", "wo"):
        checks.append((torch.stack([b.attn[name] for b in params.layers]),
                       decls["layers"]["attn"][name]))
    checks.append((torch.stack([b.mlp["w_down"] for b in params.layers]),
                   decls["layers"]["mlp"]["w_down"]))
    for t, decl in checks:
        assert t.shape == decl.shape
        assert abs(t.std().item() / mod.init_std(decl) - 1) < 0.05, decl
    assert torch.equal(params.layers[1].ln2["scale"], torch.ones(cfg.d_model))


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="no_such_arch"):
        get_config("no_such_arch")
    with pytest.raises(KeyError, match="no_such_arch"):
        get_smoke_config("no_such_arch")
