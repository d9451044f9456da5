"""Shared reference runs and checks of the port's LM training against the
JAX package, on the CPU: ``tests/test_torch_train_families.py`` and
``tests/test_torch_train_ssm_moe.py`` each run a part of the family
representatives through them (two files, so that the JAX compiles of the
eight archs split across the test workers).

Each arch's smoke config with the JAX parameters of
``bundle.init(jax.random.key(0))`` carried across by
``convert.params_from_numpy``; batch 2 x S = 64 from ``make_batch``
(seed 3; phi3v-smoke: 16 patches + 48 tokens). danube-smoke's window of
32 binds. The MoE archs' routers are zeroed in both packages for the
gradient and step checks: every router probability then ties exactly,
both packages pick the lowest expert indices (``lax.top_k``'s rule, the
port's stable sort) and drop by position, so routing cannot flip. With
a random router a token whose top-k probabilities lie within the
packages' bf16 rounding differences routes differently in the two
(olmoe-smoke: gaps down to 7e-7 over 256 routings) and moves whole
expert rows of the gradient; ``test_moe_layer_gradients_match_jax``
checks the layer's gradient under random routers after a near-tie
check, and the loss check keeps the random router.

One JAX compile per arch: ``value_and_grad(loss_fn)``, then
``adamw_update(lr=peak_lr)`` on those gradients (JAX's ``train_step`` at
``microbatches=1`` is exactly these two calls, ``repro/models/
factory.py:123-151``), and JAX's own ``train_step(microbatches=2)`` on
the same batch (two microbatches of one row).

Tolerances, stated where they are used:

* loss, ce and aux: ``LOSS_RTOL`` = 1e-3 relative (both packages round
  the activations to bf16 at the same places and sum in other orders;
  up to 1.4e-4 seen; under a random router a token that routes
  otherwise moves aux by its share of the load: 1.6e-5 seen); with the
  routers zeroed, aux ``AUX_RTOL`` = 1e-5 relative (f32 means);
* each gradient leaf: relative L2 error ``|got - want| / |want|`` within
  ``GRAD_TOL`` = 5e-2 (bf16 activations: 0.7e-2 to 2.1e-2 seen, hymba's
  ``beta_mamba`` the largest), none all zero where JAX's is not;
* a step: ``gnorm`` ``GNORM_RTOL`` = 1e-2 relative; ``m`` (0.1 x the
  clipped gradient) within ``GRAD_TOL``, ``v`` within 2 x ``GRAD_TOL``
  (squares); the parameters: Adam's first step moves each element by lr
  x (m / sqrt(v) = sign(g)) + lr x wd x p, so an element whose gradient
  lies within the rounding noise of 0 may step the other way: every
  element within 2.05 x lr of JAX's, and in each leaf at most
  ``FLIP_FRACTION`` = 5% of the elements more than 0.1 x lr apart (2.8%
  seen, hymba's ``w_dt``).
"""

from __future__ import annotations

import jax
import pytest
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import tokens as jax_tokens
from repro.models.factory import build as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.configs import get_smoke_config
from repro_torch.core import convert
from repro_torch.models.factory import build
from repro_torch.optim import adamw_init

B, S, SEED = 2, 64, 3
LR = 3e-4
LOSS_RTOL, AUX_RTOL = 1e-3, 1e-5
GRAD_TOL = 5e-2
GNORM_RTOL = 1e-2
FLIP_FRACTION = 0.05
MICROBATCHES = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tensors here are too small to gain from intra-op
    threads, and the test workers share the cores: with one thread,
    OpenMP's idle threads do not spin against the other workers (a
    24-step CPU training run took 194 s in the suite with the default
    threads, ~1.5 s alone). Test modules import it to use it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def leaves(tree):
    """(key path, numpy leaf) of a JAX-layout tree, in jax.tree order."""
    return [(jax.tree_util.keystr(p), f32(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _zero_routers(tree):
    """The JAX parameter tree (numpy) with every MoE router at 0."""
    if "moe" in tree.get("layers", {}):
        tree["layers"]["moe"]["router"] = np.zeros_like(
            tree["layers"]["moe"]["router"])
    return tree


def jax_run(arch: str) -> dict:
    """JAX's loss (random router), gradients, single-batch step and
    two-microbatch step (routers zeroed) for ``arch``'s smoke config."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jbundle = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, jbundle.init(jax.random.key(0)))
    batch = jax_tokens.make_batch(jcfg, B, S, seed=SEED)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    zeroed = _zero_routers(jax.tree.map(np.array, tree))

    @jax.jit
    def steps(p, b):
        (loss, metrics), grads = jax.value_and_grad(
            jbundle.loss_fn, has_aux=True)(p, b)
        one = jax_adamw_update(grads, jax_adamw_init(p), p, lr=LR)
        two = jbundle.train_step(p, jax_adamw_init(p), b, 0,
                                 microbatches=MICROBATCHES, peak_lr=LR)
        return loss, metrics, grads, one, two

    loss, metrics, grads, one, two = jax.tree.map(
        f32, steps(jax.tree.map(jnp.asarray, zeroed), jbatch))
    random_loss = (loss, metrics)
    if jcfg.moe is not None:    # the same program on the random routers
        random_loss = steps(jax.tree.map(jnp.asarray, tree), jbatch)[:2]
    return dict(arch=arch, cfg=cfg, tree=tree, zeroed=zeroed, batch=batch,
                random_loss=jax.tree.map(float, random_loss),
                loss=float(loss), metrics=jax.tree.map(float, metrics),
                grads=grads, one=one, two=two)


def model(run, tree="zeroed", cfg=None):
    """The port's bundle and model on the run's JAX parameters ("tree":
    as initialised; "zeroed": MoE routers at 0)."""
    cfg = cfg or run["cfg"]
    return build(cfg, "cpu"), convert.params_from_numpy(run[tree], cfg,
                                                        "cpu")


def grads(bundle, params, batch) -> dict:
    """The port's gradient of ``loss_fn``, in the JAX layout."""
    loss, _ = bundle.loss_fn(params, batch)
    return convert._to_tree(params, torch.autograd.grad(
        loss, list(params.parameters()), allow_unused=True,
        materialize_grads=True))


def check_loss(run):
    bundle, params = model(run, "tree")
    loss, metrics = bundle.loss_fn(params, run["batch"])
    want_loss, want = run["random_loss"]
    np.testing.assert_allclose(float(loss.detach()), want_loss,
                               rtol=LOSS_RTOL)
    for name in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[name].detach()), want[name],
                                   rtol=LOSS_RTOL, err_msg=name)


def check_grads(run):
    got = leaves(grads(*model(run), run["batch"]))
    want = leaves(run["grads"])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, key
        if np.abs(w).max() > 0:
            assert np.abs(g).max() > 0, f"{run['arch']} {key}: all zero"
        assert rel_l2(g, w) <= GRAD_TOL, (run["arch"], key, rel_l2(g, w))


def check_step(run, microbatches: int):
    """The port's ``train_step`` from fresh AdamW state against JAX's
    (``one`` at ``microbatches=1``, ``two`` at 2)."""
    bundle, params = model(run)
    old = convert.params_to_numpy(params)
    params, opt, metrics = bundle.train_step(
        params, adamw_init(params), run["batch"], 0,
        microbatches=microbatches, peak_lr=LR)
    if microbatches == 1:
        new, jopt, gnorm = run["one"]
        want = dict(run["metrics"], loss=run["loss"], gnorm=float(gnorm))
    else:
        new, jopt, jm = run["two"]
        want = jax.tree.map(float, jm)
    assert sorted(metrics) == ["aux", "ce", "gnorm", "loss"]
    for name, rtol in (("loss", LOSS_RTOL), ("ce", LOSS_RTOL),
                       ("gnorm", GNORM_RTOL), ("aux", AUX_RTOL)):
        np.testing.assert_allclose(float(metrics[name]), want[name],
                                   rtol=rtol, err_msg=name)
    state = convert.opt_to_numpy(opt, params)
    assert int(state["count"]) == int(jopt.count) == 1
    for name, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
        for (key, g), (_, w) in zip(leaves(state[name]),
                                    leaves(getattr(jopt, name))):
            assert rel_l2(g, w) <= tol, (run["arch"], name, key,
                                         rel_l2(g, w))
    for (key, g), (_, w), (_, p) in zip(
            leaves(convert.params_to_numpy(params)), leaves(new),
            leaves(old)):
        d = np.abs(g - w)
        assert d.max() <= 2.05 * LR, (run["arch"], key, d.max() / LR)
        assert (d > 0.1 * LR).mean() <= FLIP_FRACTION, (run["arch"], key)
        assert np.abs(g - p).max() > 0, (run["arch"], key, "not updated")
