"""The port's optimizer, schedule, training checkpoints and launchers
against the JAX package, on the CPU.

* ``cosine_schedule`` against JAX's over steps 0..total, for a Python
  int step and an f32 array step: ``SCHEDULE_RTOL`` = 1e-6 relative
  (f32 ``cos`` of XLA and of PyTorch may differ in the last bit);
* ``adamw_update`` on the same numpy gradients, parameters and state
  (three steps, the clip on and off, the lr a number and a CPU tensor):
  ``m``, ``v``, the parameters and ``gnorm`` at ``ADAM_RTOL`` = 1e-6
  relative (f32 products and sums in other orders, a fused
  multiply-add here and there: a few ulp), ``count`` exactly; where
  ``m`` cancels (b1 m and (1 - b1) g of opposite signs) a relative bound
  says nothing, so ``m`` also passes within 1e-6 of the gradients'
  scale, ``v`` of its square, and the parameters within
  ``ADAM_ATOL_STEPS`` = 1e-5 of a unit step times lr (3.5e-9 at lr 1e-3
  seen: the update m / sqrt(v) of a cancelled m);
* the launcher: ``repro.launch.train.main`` raises on jax 0.9.0 (its 1 x
  1 mesh makes ``embed_tokens``' gather a ``ShardingTypeError``, the
  failure of the seed's ``tests/test_sharding.py`` cases), so the JAX
  reference is its loop without the mesh, on the port's initial
  parameters: the same batches (``make_batch(seed=step)`` from one
  ``TokenPipeline``), schedule and ``train_step``. Losses within
  ``LOSS_RTOL`` = 1e-3 relative each step (bf16 activations; 1e-5
  seen), and falling by the launcher's own rule (the last below the
  first);
* the checkpoint: ``repro.checkpoint.restore_checkpoint`` reads the
  port's file; its params equal ``convert.params_to_numpy`` exactly and
  its opt state ``convert.opt_to_numpy`` exactly.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxPipeline  # noqa: E402
from repro.data.tokens import make_batch as jax_make_batch  # noqa: E402
from repro.models.factory import build as jax_build  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.launch import serve_decode, train, train_lm  # noqa: E402
from repro_torch.models.factory import build  # noqa: E402
from repro_torch.optim import AdamWState, adamw_init  # noqa: E402
from repro_torch.optim import adamw_update, cosine_schedule  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from tests.train_parity import one_torch_thread  # noqa: E402,F401

SCHEDULE_RTOL = 1e-6
ADAM_RTOL = 1e-6
ADAM_ATOL_STEPS = 1e-5
LOSS_RTOL = 1e-3
LAUNCH_ARGV = ["--arch", "h2o_danube_1p8b", "--smoke", "--steps", "4",
               "--ckpt-every", "2"]


@pytest.mark.parametrize("warmup,total,floor", [(20, 100, 0.1), (0, 4, 0.1),
                                                (5, 5, 0.0), (3, 40, 0.25)])
def test_cosine_schedule_matches_jax(warmup, total, floor):
    kw = dict(peak=3e-4, warmup=warmup, total=total, floor_pct=floor)
    for step in range(total + 1):
        for as_array in (False, True):
            got = cosine_schedule(np.float32(step) if as_array else step,
                                  **kw)
            want = jax_cosine(jnp.float32(step) if as_array else step, **kw)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), float(want),
                                       rtol=SCHEDULE_RTOL)


def _tree(rng, scale=1.0):
    """A small parameter-shaped tree of numpy f32 leaves."""
    return {"a": (scale * rng.normal(size=(3, 5))).astype(np.float32),
            "b": {"c": (scale * rng.normal(size=(7,))).astype(np.float32),
                  "d": (scale * rng.normal(size=(2, 2, 4))).astype(
                      np.float32)}}


def _flat(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("clip", [1.0, None, 50.0])
@pytest.mark.parametrize("lr_tensor", [False, True])
def test_adamw_update_matches_jax(clip, lr_tensor):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jax_adamw_init(jp)
    tp = jax.tree.map(torch.tensor, params)
    opt = adamw_init(tp)
    jstep = jax.jit(lambda g, o, p, lr: jax_adamw_update(
        g, o, p, lr=lr, grad_clip=clip))
    for step in range(3):
        grads = _tree(rng, scale=2.0 + step)
        lr = 1e-3 / (step + 1)
        jp, jopt, jgn = jstep(jax.tree.map(jnp.asarray, grads), jopt, jp,
                              jnp.float32(lr))
        tp, opt, gn = adamw_update(
            jax.tree.map(torch.tensor, grads), opt, tp,
            lr=torch.tensor(lr) if lr_tensor else lr, grad_clip=clip)
        assert int(opt.count) == int(jopt.count) == step + 1
        np.testing.assert_allclose(float(gn), float(jgn), rtol=ADAM_RTOL)
        g_max = max(np.abs(g).max() for g in _flat(grads))
        for got, want, atol in (
                (opt.m, jopt.m, ADAM_RTOL * g_max),
                (opt.v, jopt.v, ADAM_RTOL * g_max ** 2),
                (leaves(tp), jp, ADAM_ATOL_STEPS * lr)):
            for g, w in zip(_flat([t.numpy() for t in got]), _flat(want)):
                np.testing.assert_allclose(g, w, rtol=ADAM_RTOL, atol=atol)
    if clip is None:
        assert float(gn) == 0.0


def test_adamw_update_is_in_place_on_a_model():
    """On a model: the parameters are updated in place (the stacked
    storage under each layer's view too), ``m`` / ``v`` follow
    ``parameters()``."""
    cfg = get_smoke_config("h2o_danube_1p8b")
    model = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    before = convert.params_to_numpy(model)
    wq = model.layers[1].attn.wq
    opt = adamw_init(model)
    assert isinstance(opt, AdamWState)
    assert [m.shape for m in opt.m] == [p.shape for p in model.parameters()]
    grads = [torch.ones_like(p) for p in model.parameters()]
    out, opt, _ = adamw_update(grads, opt, model, lr=1e-2)
    assert out is model and model.layers[1].attn.wq is wq
    after = convert.params_to_numpy(model)
    d = after["layers"]["attn"]["wq"] - before["layers"]["attn"]["wq"]
    assert np.all(d < 0)


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The port's launcher on ``LAUNCH_ARGV`` (CPU), and JAX's loop from
    the port's initial parameters."""
    ckpt = tmp_path_factory.mktemp("train_ckpt")
    losses = train.main(LAUNCH_ARGV + ["--device", "cpu", "--ckpt-dir",
                                       str(ckpt)])
    cfg, jcfg = (get_smoke_config("h2o_danube_1p8b"),
                 jax_smoke_config("h2o_danube_1p8b"))
    init = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, convert.params_to_numpy(init))
    jbundle = jax_build(jcfg)
    opt = jax_adamw_init(params)
    pipe = JaxPipeline(jcfg.vocab, seed=0)
    step_fn = jax.jit(lambda p, o, b, s, lr: jbundle.train_step(
        p, o, b, s, microbatches=1, peak_lr=lr))
    want = []
    for step in range(4):   # repro/launch/train.py:77-89 without the mesh
        batch = {k: jnp.asarray(v) for k, v in jax_make_batch(
            jcfg, 8, 128, seed=step, pipeline=pipe).items()}
        lr = jax_cosine(jnp.float32(step), peak=3e-4, warmup=20, total=4)
        params, opt, metrics = step_fn(params, opt, batch, jnp.int32(step),
                                       lr)
        want.append(float(metrics["loss"]))
    return losses, want, ckpt


def test_train_main_matches_jax_loop(launch):
    losses, want, _ = launch
    assert len(losses) == 4
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]


def test_jax_restore_reads_the_port_checkpoint(launch):
    _, _, ckpt = launch
    step, tree = jax_restore(str(ckpt))
    assert step == 4 and sorted(tree) == ["opt", "params"]
    assert int(tree["opt"]["count"]) == 4
    assert tree["opt"]["count"].dtype == np.int32
    # The same model and state rebuilt from the file round-trip exactly.
    cfg = get_smoke_config("h2o_danube_1p8b")
    model = convert.params_from_numpy(tree["params"], cfg, "cpu")
    opt = convert.opt_from_numpy(tree["opt"], model, "cpu")
    for want, got in ((tree["params"], convert.params_to_numpy(model)),
                      (tree["opt"], convert.opt_to_numpy(opt, model))):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(g, w)
    shapes = jax.eval_shape(jax_build(jax_smoke_config(
        "h2o_danube_1p8b")).init, jax.random.key(0))
    assert jax.tree.structure(shapes) == jax.tree.structure(tree["params"])
    for w, g in zip(jax.tree.leaves(shapes), jax.tree.leaves(tree["params"])):
        assert w.shape == g.shape and g.dtype == np.float32


def test_train_lm_example_runs_on_the_cpu():
    losses = train_lm.main(["--steps", "24", "--device", "cpu"])
    assert len(losses) == 24 and losses[-1] < losses[0]


def test_serve_decode_example_runs_on_the_cpu():
    tokens = serve_decode.main(["--device", "cpu"])
    cfg = get_smoke_config("h2o_danube_1p8b")
    assert tokens.shape == (4, 16)
    assert ((tokens >= 0) & (tokens < cfg.vocab)).all()
