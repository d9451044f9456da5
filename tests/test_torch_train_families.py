"""The port's LM training against the JAX package on the CPU: dense
(h2o-danube-1.8b's window binding, stablelm-3b), MoE with a dense layer 0
and shared experts (moonshot), VLM (phi-3-vision) and audio (hubert), at
their smoke configs; then activation checkpointing and the two archs
without a family check. ``tests/train_parity.py`` holds the reference
runs, the inputs and every tolerance; ``tests/test_torch_train_ssm_moe.py``
the other families.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.tokens import make_batch  # noqa: E402
from repro_torch.models.factory import build  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from tests import train_parity as tp  # noqa: E402
from tests.train_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ["h2o_danube_1p8b", "stablelm_3b", "moonshot_v1_16b_a3b",
         "phi3_vision_4p2b", "hubert_xlarge"]


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
    """``cfg.remat`` checkpoints each block: the same gradients as
    without it to 1e-6 relative L2 (the same operations recomputed); K7
    runs twice a step (counted on the card, ``chip_smoke.py``'s
    ``train_path``)."""
    run = _run(runs, "h2o_danube_1p8b")
    plain = tp.leaves(tp.grads(*tp.model(run), run["batch"]))
    cfg = dataclasses.replace(run["cfg"], remat=True)
    remat = tp.leaves(tp.grads(*tp.model(run, cfg=cfg), run["batch"]))
    for (key, g), (_, w) in zip(remat, plain):
        assert tp.rel_l2(g, w) <= 1e-6, key


@pytest.mark.parametrize("arch", ["dbrx_132b", "granite_34b"])
def test_other_archs_take_two_steps(arch):
    """The two archs without a family check: two port-only steps, finite
    losses and norms."""
    cfg = get_smoke_config(arch)
    bundle = build(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    for step in range(2):
        batch = make_batch(cfg, tp.B, tp.S, seed=step)
        params, opt, metrics = bundle.train_step(params, opt, batch, step,
                                                 peak_lr=tp.LR)
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["gnorm"]))
        assert float(metrics["gnorm"]) > 0
    assert int(opt.count) == 2
