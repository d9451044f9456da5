"""The port's hybrid (hymba-1.5b), xLSTM (xlstm-350m), VLM
(phi-3-vision-4.2b) and audio (hubert-xlarge) families against the JAX
package, on the CPU.

Each arch's smoke config with the JAX parameters of
``bundle.init(jax.random.key(0))`` carried across by
``convert.params_from_numpy``; batch 2 from ``make_batch`` (seed 5):
S = 64 prompt positions (phi3v-smoke: 16 patches + 48 tokens), then 8
teacher-forced decode tokens. hymba-smoke's window of 32 makes its
decode cache a rolling buffer. The port's prefill attention runs
``ops.swa_attention``'s plain version here (CPU tensors). Each JAX
reference run is made once per arch (the module-scoped ``runs``).

Tolerances, stated where they are used (``tests/test_torch_llm_zoo.py``'s):

* logits: ``tests/test_decode.py``'s contract, values within
  ``LOGIT_TOL`` = 0.15 of the logits' scale and greedy tokens equal
  wherever the top-1 gap exceeds ``GAP`` = 0.05 of that scale (the
  packages round to bf16 at the same places but sum in other orders);
* cache k / v and the mamba and xLSTM states: atol and rtol ``KV_TOL`` =
  3e-2 on values divided by the leaf's scale (``max |want|``), a few bf16
  ulps (mamba's ``ssm`` states are ~0.1, so the scale is each leaf's own,
  not the zoo's ``max(|want|, 1)``);
* ``pos``, ``length``, batches, parameter counts: exactly equal.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro.models import module as jmod  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.factory import _embed_inputs as jax_embed  # noqa: E402
from repro.models.factory import build as jax_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import module as mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.factory import _embed_inputs, build  # noqa: E402

ARCHS = ["hymba_1p5b", "xlstm_350m", "phi3_vision_4p2b", "hubert_xlarge"]
DECODERS = ARCHS[:3]
LOGIT_TOL, GAP = 0.15, 0.05
KV_TOL = 3e-2
S, DECODE_STEPS = 64, 8


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _jax_run(arch):
    """Both models; JAX's prefill of the first S positions, its
    teacher-forced decode logits and caches after each of 8 steps (the
    decoders), its per-frame logits (hubert)."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jbundle = jax_build(jcfg)
    jparams = jbundle.init(jax.random.key(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
    n_text = S - cfg.vlm_patches
    batch = jax_tokens.make_batch(jcfg, 2, S + (DECODE_STEPS if jcfg.decoder
                                                else 0), seed=5)
    prompt = dict(batch)
    if "tokens" in batch:
        prompt["tokens"] = batch["tokens"][:, :n_text]
    logits, jcaches = jax.jit(jbundle.prefill)(
        jparams, {k: jnp.asarray(v) for k, v in prompt.items()})
    run = dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
               batch=batch, prompt=prompt, logits=_np(logits),
               caches=jax.tree.map(_np, jcaches), steps=[])
    if not jcfg.decoder:
        @jax.jit
        def frames(b):
            x, positions, _ = jax_embed(jparams, b, jcfg)
            h, _, _ = jtfm.forward_full(jparams, x, positions, jcfg)
            return jtfm.logits_from_hidden(jparams, h, jcfg)

        run["frame_logits"] = _np(frames(
            {k: jnp.asarray(v) for k, v in batch.items()}))
        return run

    @jax.jit
    def jstep(caches, tok):
        x = jtfm.embed_tokens(jparams, tok, jcfg)
        h, caches = jtfm.decode_step(jparams, x, jcfg, caches)
        return jtfm.logits_from_hidden(jparams, h, jcfg), caches

    c = jcaches
    for t in range(DECODE_STEPS):
        tok = batch["tokens"][:, n_text + t:n_text + t + 1]
        want, c = jstep(c, jnp.asarray(tok))
        run["steps"].append((tok, _np(want), jax.tree.map(_np, c)))
    return run


@pytest.fixture(scope="module")
def runs():
    """arch -> ``_jax_run(arch)``, each made on first use."""
    return {}


def _run(runs, arch):
    if arch not in runs:
        runs[arch] = _jax_run(arch)
    return runs[arch]


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


def _assert_tree_close(got, want, path=""):
    """Cache trees leaf by leaf: ``pos`` / ``length`` exactly, every float
    leaf within KV_TOL of its scale."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g is None) == (w is None), path
            if w is not None:
                _assert_tree_close(g, w, f"{path}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if path.endswith(("pos", "length")):
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=KV_TOL,
                               rtol=KV_TOL, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(runs, arch):
    """Last-position logits and every cache leaf: k / v (hymba's rolling
    buffer of 32 slots, the others' 64), ``pos``, ``length``, hymba's
    mamba ``ssm`` / ``conv`` and xLSTM's mLSTM ``c`` / ``n`` and sLSTM
    ``c`` / ``n`` / ``h`` of every group."""
    run = _run(runs, arch)
    cfg = run["cfg"]
    logits, caches = build(cfg, device="cpu").prefill(run["params"],
                                                      run["prompt"])
    assert logits.shape == (2, 1, cfg.padded_vocab)
    _assert_logits_close(_np(logits), run["logits"], cfg.vocab)
    kind = {"hybrid": tfm.HybridCache, "ssm": tfm.XlstmCache}.get(
        cfg.family, tfm.attn_lib.KVCache)
    assert isinstance(caches, kind)
    _assert_tree_close(convert.caches_to_numpy(caches), run["caches"])


@pytest.mark.parametrize("arch", DECODERS)
def test_teacher_forced_decode_matches_jax(runs, arch):
    """8 decode steps from JAX's prefill cache (through ``convert``), the
    same token fed to both packages each step: logits and the whole cache
    (the recurrent states included) after every step."""
    run = _run(runs, arch)
    cfg, params = run["cfg"], run["params"]
    caches = convert.caches_from_numpy(run["caches"], device="cpu")
    for tok, want, jcaches in run["steps"]:
        x = tfm.embed_tokens(params, torch.tensor(tok), cfg)
        with torch.no_grad():
            h, caches = tfm.decode_step(params, x, cfg, caches)
            got = tfm.logits_from_hidden(params, h, cfg)
        _assert_logits_close(_np(got), want, cfg.vocab)
        _assert_tree_close(convert.caches_to_numpy(caches), jcaches)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_plus_decode_equals_full_forward(runs, arch):
    """``tests/test_decode.py``'s contract on the port, on that test's
    inputs (JAX's parameters of key 0, ``make_batch(cfg, 2, 65, 0)``):
    prefill over 64 positions and decode the last token give a full
    pass's last logits. The mamba and xLSTM states that prefill hands to
    decode carry the whole prefix."""
    run = _run(runs, arch)
    cfg, params = run["cfg"], run["params"]
    bundle = build(cfg, device="cpu")
    batch = {k: torch.tensor(v) for k, v in
             tokens.make_batch(cfg, 2, S + 1, 0).items()}
    prefix = dict(batch, tokens=batch["tokens"][:, :-1])
    _, caches = bundle.prefill(params, prefix)
    with torch.no_grad():
        x, positions = _embed_inputs(params, batch, cfg)
        assert x.shape[1] == S + 1
        h, _, _ = tfm.forward_full(params, x, positions, cfg)
        want = tfm.logits_from_hidden(params, h[:, -1:], cfg)
        x1 = tfm.embed_tokens(params, batch["tokens"][:, -1:], cfg)
        h1, _ = tfm.decode_step(params, x1, cfg, caches)
        got = tfm.logits_from_hidden(params, h1, cfg)
    _assert_logits_close(_np(got), _np(want), cfg.vocab)


def test_hubert_frame_logits_match_jax(runs):
    """hubert's served output: logits over every frame (``forward_full``
    + ``logits_from_hidden``, layer norms and the GeLU MLP) with the span
    mask's frames replaced by ``mask_embed``, against JAX's."""
    run = _run(runs, "hubert_xlarge")
    cfg, params, batch = run["cfg"], run["params"], run["batch"]
    assert batch["mask"].any() and not batch["mask"].all()
    with torch.no_grad():
        x, positions = _embed_inputs(params, batch, cfg)
        masked = torch.tensor(batch["mask"])
        assert (x[masked] == params.mask_embed.to(x.dtype)).all()
        h, _, aux = tfm.forward_full(params, x, positions, cfg)
        got = tfm.logits_from_hidden(params, h, cfg)
    assert got.shape == (2, S, cfg.padded_vocab) and aux.item() == 0
    _assert_logits_close(_np(got), run["frame_logits"], cfg.vocab)


@pytest.mark.parametrize("arch", ["phi3_vision_4p2b", "hubert_xlarge"])
@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_equals_jax_bit_for_bit(arch, seed):
    """The VLM's tokens and patches, the audio frames, span mask and
    targets: the same arrays, types included."""
    want = jax_tokens.make_batch(jax_smoke_config(arch), 3, 70, seed=seed)
    got = tokens.make_batch(get_smoke_config(arch), 3, 70, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_model_layout_match_jax(arch):
    """The full config's fields, ``head_dim``, ``param_count`` and
    ``subquadratic`` equal JAX's; the smoke model holds exactly the JAX
    declaration tree's leaves, shape for shape."""
    full, jfull = get_config(arch), jax_get_config(arch)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "window", "causal", "decoder",
              "vlm_patches", "vlm_d_vision", "audio_frontend", "d_frame",
              "head_dim", "padded_vocab", "param_count", "subquadratic"):
        want = getattr(jfull, f)
        got = getattr(full, f)
        assert (got() if callable(got) else got) == (
            want() if callable(want) else want), f
    for f in ("ssm", "xlstm"):
        assert (getattr(full, f) is None) == (getattr(jfull, f) is None)
        if getattr(full, f) is not None:
            assert getattr(full, f).__dict__ == getattr(jfull, f).__dict__

    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): d.shape
            for path, d in jax.tree_util.tree_flatten_with_path(
                jtfm.model_decl(jcfg),
                is_leaf=lambda x: isinstance(x, jmod.ParamDecl))[0]}
    got = {path: d.shape for path, d in mod._leaves(tfm.model_decl(cfg))}
    assert got == want
    params = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in params.parameters()) == sum(
        int(np.prod(s)) for s in want.values())


def test_init_rules_copy_jax():
    """The new init rules, on the models that declare them: "zeros" and
    "ones" are exact (xLSTM's ``b_f`` declares scale 2.0 and is 1, as in
    JAX), "normal" has std ``scale`` (mamba's ``log_a`` 0.5, hubert's
    ``mask_embed`` 0.02) and "fan_in" counts the stacking dims, twice for
    xLSTM's ``[groups, p - 1, ...]`` mLSTM weights; every random tensor's
    sample std within max(5%, 4 / sqrt(2 n)) of JAX's (four standard
    errors of a sample std over n draws: the 128-element ``mask_embed``
    gets 35%)."""
    full = get_config("xlstm_350m")
    decl = tfm.model_decl(full)["groups"]["mlstm"]["cell"]["w_q"]
    assert decl.shape == (4, 5, 2048, 2048)
    assert mod.init_std(decl) == 1 / np.sqrt(4 * 5 * 2048)

    checked = set()
    for arch in ("hymba_1p5b", "xlstm_350m", "hubert_xlarge"):
        cfg = get_smoke_config(arch)
        decls = dict(mod._leaves(tfm.model_decl(cfg)))
        tree = mod.init_params(tfm.model_decl(cfg),
                               torch.Generator().manual_seed(1))
        for path, d in decls.items():
            t = tree
            for part in path.split("/"):
                t = t[part]
            if d.init in ("zeros", "ones"):
                assert torch.equal(t, torch.full(d.shape, float(
                    d.init == "ones"))), path
            else:
                tol = max(0.05, 4 / np.sqrt(2 * t.numel()))
                assert abs(t.std().item() / mod.init_std(d) - 1) < tol, path
            checked.add((d.init, path.rsplit("/", 1)[-1]))
    for rule in (("ones", "b_f"), ("normal", "log_a"),
                 ("normal", "mask_embed"), ("zeros", "conv_b"),
                 ("zeros", "bias"), ("ones", "beta_mamba")):
        assert rule in checked, rule


def test_hymba_smoke_refuses_the_card(runs, monkeypatch):
    """hymba-smoke's head dim 25 is no width ``swa_attention`` is built
    for: its first prefill on the card raises in the kernel's wrapper,
    before any launch (the card's branch taken here by treating the CPU
    tensors as the card's). The full config's 64 is one K7 takes, and so
    are phi-3-vision's 96 and hubert's 80."""
    run = _run(runs, "hymba_1p5b")
    cfg = run["cfg"]
    assert cfg.head_dim == 25
    bundle = build(cfg, device="cpu")
    before = ops.launch_counts()["swa_attention"]
    monkeypatch.setattr(ops, "_on_cpu", lambda *tensors: False)
    with pytest.raises(ValueError, match="head_dim 25"):
        bundle.prefill(run["params"], run["prompt"])
    assert ops.launch_counts()["swa_attention"] == before
    for arch, d in (("hymba_1p5b", 64), ("phi3_vision_4p2b", 96),
                    ("hubert_xlarge", 80)):
        assert get_config(arch).head_dim == d and d in ops.SWA_HEAD_DIMS


@pytest.mark.parametrize("arch,s", [("h2o_danube_1p8b", 40),
                                    ("hymba_1p5b", 40), ("hymba_1p5b", 64)])
def test_rolling_buffer_holds_each_position_in_its_slot(runs, arch, s):
    """Window 32: after a prefill of S positions the decode cache holds
    the last 32, position p in slot p % 32, and prefill + one decode step
    gives a full pass's last logits at the test_decode contract. At S =
    40, no multiple of the window, JAX's ``_to_decode_cache`` rolls the
    buffer the other way (``repro/models/factory.py:189``): its first
    decode step overwrites position 24, inside the window, and keeps 8,
    outside it, so JAX's own decode drifts from its full pass; the port
    differs from JAX's cache layout there by design. At S = 64 the two
    layouts are one."""
    cfg = get_smoke_config(arch)
    assert cfg.window == 32
    if arch == "hymba_1p5b":
        params = _run(runs, arch)["params"]
    else:
        jparams = jax_build(jax_smoke_config(arch)).init(jax.random.key(0))
        params = convert.params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = torch.tensor(tokens.make_batch(cfg, 2, s + 1, 3)["tokens"])
    _, caches = build(cfg, device="cpu").prefill(params,
                                                  {"tokens": toks[:, :-1]})
    kv = caches.kv if isinstance(caches, tfm.HybridCache) else caches
    slots = torch.arange(s - 32, s) % 32
    assert (kv.pos[:, :, slots] == torch.arange(s - 32, s,
                                                dtype=torch.int32)).all()
    with torch.no_grad():
        x = tfm.embed_tokens(params, toks, cfg)
        h, _, _ = tfm.forward_full(params, x, torch.arange(s + 1), cfg)
        want = tfm.logits_from_hidden(params, h[:, -1:], cfg)
        x1 = tfm.embed_tokens(params, toks[:, -1:], cfg)
        h1, _ = tfm.decode_step(params, x1, cfg, caches)
        got = tfm.logits_from_hidden(params, h1, cfg)
    _assert_logits_close(_np(got), _np(want), cfg.vocab)
    # The key decode evicted is the oldest, position S - 32.
    assert (kv.pos[:, :, (s - 32) % 32] == s).all()
