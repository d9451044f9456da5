"""Sharded training, prefill and decode (``sharding.fsdp``) on one gloo
group of 4 CPU ranks, against JAX's unsharded loop and the port's
one-process run on the same parameters and batches.

Cases (one ``launch.mesh.run_on_ranks`` group runs them all,
``tests/sharded_ranks.py``), each two AdamW steps at lr 3e-4 on batches
of 4 x 64 from ``make_batch`` (seeds 10, 11) from JAX's initial
parameters:

* danube-smoke on (data 2, model 2); the same with ``microbatches=2``;
* olmoe-smoke on (2, 2), its routers zeroed as ``tests/train_parity.py``
  does (every router probability ties at the first step, so routing
  cannot flip between the packages);
* hubert-smoke on (4, 1): each rank's span mask holds another count, so
  the loss's mean needs the whole batch's count;
* hymba-smoke on (1, 4): every parameter split over ``model``, the batch
  whole on every rank (its 25 heads replicated, as JAX's rules do);
* olmoe-smoke on (2, 2) at 4 x 8 tokens: one MoE group of 32 straddles
  the data ranks (routed on each from a gather of the rows);
* danube-smoke and olmoe-smoke prefill (48 positions: danube's window
  of 32 binds) and one decode step on (2, 2) (olmoe's 4 decode tokens
  are one group across the ranks).

Checks, with ``tests/train_parity.py``'s tolerances:

* against JAX's ``train_step`` (jit, no mesh): loss and ce each step
  within ``LOSS_RTOL``, aux within ``AUX_RTOL`` at the first step with
  the routers zeroed, ``gnorm`` within ``GNORM_RTOL``; the state after
  the first step by ``check_step``'s rules (``m`` within ``GRAD_TOL``
  relative L2, ``v`` within 2 x ``GRAD_TOL``, every parameter within 2.05
  x lr of JAX's and at most ``FLIP_FRACTION`` of a leaf's elements 0.1 x
  lr apart);
* against the port's one-process ``train_step``: the same losses and
  norms, and after both steps each leaf's update (final minus initial),
  ``m`` and ``v`` within ``GRAD_TOL`` relative L2 (2 x for ``v``);
* rank 0's checkpoint read by ``repro.checkpoint.restore_checkpoint``:
  the one-process tree's structure, shapes and f32 leaves, the values as
  above, ``count`` 2;
* each rank's resident parameter bytes equal its spec blocks' bytes
  (``fsdp.shard_bytes``) and parameters + ``m`` + ``v`` three times that;
* the serve cases: each rank's prefill logits (its rows) within
  ``test_torch_llm_serve``'s logit contract of the one-process port's
  and of JAX's, the greedy tokens and the decoded tokens equal to the
  one-process port's.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models.factory import build as jax_build  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.tokens import make_batch  # noqa: E402
from repro_torch.launch.mesh import run_on_ranks  # noqa: E402
from repro_torch.models.factory import build  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from tests import sharded_ranks  # noqa: E402
from tests.train_parity import (AUX_RTOL, FLIP_FRACTION, GNORM_RTOL,  # noqa: E402
                                GRAD_TOL, LOSS_RTOL, _zero_routers, leaves,
                                one_torch_thread, rel_l2)  # noqa: F401

LR = sharded_ranks.LR
B, S, SERVE_S = 4, 64, 48
LOGIT_TOL, GAP = 0.15, 0.05
TRAIN = {
    # name: (arch, (data, model), microbatches, sequence length)
    "danube_2x2": ("h2o_danube_1p8b", (2, 2), 1, S),
    "danube_micro_2x2": ("h2o_danube_1p8b", (2, 2), 2, S),
    "olmoe_2x2": ("olmoe_1b_7b", (2, 2), 1, S),
    # 4 x 8 tokens are one MoE group of 32: it straddles the two data
    # ranks, which route the whole batch from a gather of the rows.
    "olmoe_straddle_2x2": ("olmoe_1b_7b", (2, 2), 1, 8),
    "hubert_4x1": ("hubert_xlarge", (4, 1), 1, S),
    "hymba_1x4": ("hymba_1p5b", (1, 4), 1, S),
}
SERVE = {
    # name: (arch, prompt length); one decode step after the prefill
    # (olmoe's 4 decode tokens are one group across the ranks)
    "danube_serve_2x2": ("h2o_danube_1p8b", SERVE_S),
    "olmoe_serve_2x2": ("olmoe_1b_7b", SERVE_S),
}
STEPS = 2


def _tree(arch):
    """JAX's initial parameters (numpy), MoE routers zeroed."""
    jb = jax_build(jax_smoke_config(arch))
    tree = jax.tree.map(np.array, jb.init(jax.random.key(0)))
    return _zero_routers(tree)


def _batches(arch, n, seq=S, seed=10):
    return [make_batch(get_smoke_config(arch), B, seq, seed=seed + i)
            for i in range(n)]


def _jax_loop(arch, tree, batches, micro):
    jb = jax_build(jax_smoke_config(arch))
    step = jax.jit(lambda p, o, b: jb.train_step(p, o, b, 0,
                                                 microbatches=micro,
                                                 peak_lr=LR))
    p = jax.tree.map(jnp.asarray, tree)
    o = jax_adamw_init(p)
    metrics, states = [], []
    for b in batches:
        p, o, met = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append(jax.tree.map(float, met))
        states.append({"params": jax.tree.map(np.asarray, p),
                       "opt": {"m": jax.tree.map(np.asarray, o.m),
                               "v": jax.tree.map(np.asarray, o.v)}})
    return metrics, states


def _port_loop(arch, tree, batches, micro):
    cfg = get_smoke_config(arch)
    bundle = build(cfg, "cpu")
    params = convert.params_from_numpy(tree, cfg, "cpu")
    opt = adamw_init(params)
    metrics = []
    for i, b in enumerate(batches):
        params, opt, met = bundle.train_step(params, opt, b, i,
                                             microbatches=micro, peak_lr=LR)
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, {"params": convert.params_to_numpy(params),
                     "opt": convert.opt_to_numpy(opt, params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    trees = {arch: _tree(arch) for arch, _, _, _ in TRAIN.values()}
    cases, data = [], {}
    for name, (arch, layout, micro, seq) in TRAIN.items():
        batches = _batches(arch, STEPS, seq)
        cases.append((name, arch, layout, "train", STEPS, micro, batches,
                      trees[arch]))
        data[name] = batches
    serve = {}
    for name, (arch, seq) in SERVE.items():
        serve[name] = _batches(arch, 1, seq, seed=20)
        cases.append((name, arch, (2, 2), "serve", 0, 1, serve[name],
                      trees[arch]))
    run = run_on_ranks(sharded_ranks.sharded_cases, 4, "cpu", cases, ckpt,
                       timeout=900)
    out = {"ranks": run.results, "ckpt": ckpt, "backend": run.backend,
           "trees": trees, "serve": serve}
    for name, (arch, _, micro, _) in TRAIN.items():
        out[name] = {"jax": _jax_loop(arch, trees[arch], data[name], micro),
                     "port": _port_loop(arch, trees[arch], data[name],
                                        micro)}
    return out


def _metrics_close(got, want, first_aux=True):
    for step, (g, w) in enumerate(zip(got, want)):
        for key, rtol in (("loss", LOSS_RTOL), ("ce", LOSS_RTOL),
                          ("gnorm", GNORM_RTOL)):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol,
                                       err_msg=f"step {step} {key}")
        if step == 0 and first_aux:
            np.testing.assert_allclose(g["aux"], w["aux"], rtol=AUX_RTOL,
                                       atol=1e-7, err_msg="aux")


def _updates_close(got, want, start, what):
    for (key, g), (_, w), (_, p) in zip(leaves(got["params"]),
                                        leaves(want["params"]),
                                        leaves(start)):
        assert g.shape == w.shape, (what, key)
        assert rel_l2(g - p, w - p) <= GRAD_TOL, (what, key,
                                                  rel_l2(g - p, w - p))
    for name, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
        for (key, g), (_, w) in zip(leaves(got["opt"][name]),
                                    leaves(want["opt"][name])):
            assert rel_l2(g, w) <= tol, (what, name, key, rel_l2(g, w))


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_steps_match_jax(runs, name):
    got = runs["ranks"][0][name]
    want_metrics, want_states = runs[name]["jax"]
    assert runs["backend"] == "gloo"
    _metrics_close(got["metrics"], want_metrics,
                   first_aux=TRAIN[name][2] == 1)
    # The first step's state by train_parity.check_step's rules.
    state, want = got["states"][0], want_states[0]
    for name_, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
        for (key, g), (_, w) in zip(leaves(state["opt"][name_]),
                                    leaves(want["opt"][name_])):
            assert rel_l2(g, w) <= tol, (name, name_, key, rel_l2(g, w))
    for (key, g), (_, w) in zip(leaves(state["params"]),
                                leaves(want["params"])):
        d = np.abs(g - w)
        assert d.max() <= 2.05 * LR, (name, key, d.max() / LR)
        assert (d > 0.1 * LR).mean() <= FLIP_FRACTION, (name, key)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_steps_match_one_rank(runs, name):
    ranks = [r[name] for r in runs["ranks"]]
    want_metrics, want_state = runs[name]["port"]
    for r in ranks:      # every rank reports the whole batch's metrics
        assert r["metrics"] == ranks[0]["metrics"]
    _metrics_close(ranks[0]["metrics"], want_metrics)
    _updates_close(ranks[0]["states"][-1], want_state,
                   runs["trees"][TRAIN[name][0]], name)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_checkpoint_reads_in_jax(runs, name):
    step, tree = jax_restore(f"{runs['ckpt']}/{name}")
    assert step == STEPS and sorted(tree) == ["opt", "params"]
    _, want = runs[name]["port"]
    for part in ("params", "opt"):
        assert jax.tree.structure(tree[part]) == jax.tree.structure(
            want[part])
        for g, w in zip(jax.tree.leaves(tree[part]),
                        jax.tree.leaves(want[part])):
            assert np.shape(g) == np.shape(w)
            assert np.asarray(g).dtype == np.asarray(w).dtype
    assert int(tree["opt"]["count"]) == STEPS
    _updates_close({"params": tree["params"], "opt": tree["opt"]}, want,
                   runs["trees"][TRAIN[name][0]], name)


@pytest.mark.parametrize("name", list(TRAIN))
def test_resident_bytes_are_the_spec_blocks(runs, name):
    for r in runs["ranks"]:
        got = r[name]
        assert got["param_bytes"] == got["spec_bytes"]
        assert got["resident_bytes"] == 3 * got["spec_bytes"]
    arch = TRAIN[name][0]
    whole = sum(np.asarray(x).nbytes for x in jax.tree.leaves(
        runs["trees"][arch]))
    assert sum(r[name]["param_bytes"] for r in runs["ranks"]) >= whole
    if TRAIN[name][1][1] > 1:   # a model axis splits something
        assert runs["ranks"][0][name]["param_bytes"] < whole


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_prefill_and_decode_match(runs, name):
    arch = SERVE[name][0]
    cfg = get_smoke_config(arch)
    tree = runs["trees"][arch]
    batch = runs["serve"][name][0]
    bundle = build(cfg, "cpu")
    params = convert.params_from_numpy(tree, cfg, "cpu")
    logits, caches = bundle.prefill(params, batch)
    nxt = torch.argmax(logits[..., :cfg.vocab], -1).to(torch.int32)
    tok, _ = bundle.decode(params, caches, nxt)
    jb = jax_build(jax_smoke_config(arch))
    jlogits, _ = jax.jit(jb.prefill)(jax.tree.map(jnp.asarray, tree),
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    want = logits.float().numpy()
    seen = set()
    for r in runs["ranks"]:
        got = r[name]
        rows = got["rows"]
        seen.update(range(rows.start, rows.stop))
        for ref in (want, np.asarray(jlogits, np.float32)):
            g = got["logits"][..., :ref.shape[-1]]
            scale = max(np.abs(ref[rows]).max(), 1.0)
            np.testing.assert_allclose(g / scale, ref[rows] / scale,
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
        np.testing.assert_array_equal(got["next"], nxt.numpy()[rows])
        np.testing.assert_array_equal(got["decoded"], tok.numpy()[rows])
    assert seen == set(range(B))
