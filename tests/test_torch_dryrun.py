"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

JAX's ``lower_combo`` needs 256 host devices and fails on jax 0.9 in
this environment (``tests/test_sharding.py``'s two mesh tests), so the
report is held to JAX's code and arithmetic instead:

* the report of each family's smoke config on a (data 2, model 4)
  layout, at a small train, prefill and decode shape, has the keys JAX's
  ``lower_combo`` writes (``repro/launch/dryrun.py:380-414``);
* ``memory.argument_bytes`` equals the bytes of rank 0's blocks computed
  from JAX's ``param_specs`` on an ``AbstractMesh`` (x3 with AdamW's
  ``m`` and ``v``, plus its step count), plus its rows of the batch
  (and, to decode, of the caches);
* the roofline's model FLOPs per chip are ``6 N_active tokens / n_dev``
  to train and ``2 N_active tokens / n_dev`` to serve;
* on a (1, 1) layout the fake trace counts exactly the FLOPs that
  ``FlopCounterMode`` counts when the same step runs on real CPU tensors,
  and the same collectives (none);
* a prefill on (2, 4) gathers every parameter once: one all-gather a
  dim its spec splits (over more than one rank), none for an audio
  model's unused token embedding;
* ``main`` leaves no process group behind;
* K7's custom operator passes ``torch.library.opcheck`` on CPU tensors
  and its FLOP formula counts 4 D FLOPs a kept (query, key) pair.
"""

import math

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import module as jax_mod  # noqa: E402
from repro.models.factory import build as jax_build  # noqa: E402
from repro.sharding import specs as jax_specs  # noqa: E402
from repro_torch.configs import InputShape, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_cpu_mesh  # noqa: E402
from repro_torch.sharding import fsdp  # noqa: E402
from tests.train_parity import one_torch_thread  # noqa: E402,F401

# The keys JAX's lower_combo writes for a runnable combination.
JAX_KEYS = {"arch", "shape", "mesh", "plan", "variant", "microbatches",
            "lower_s", "compile_s", "n_devices", "params", "active_params",
            "tokens_per_step", "memory", "analysis_mode", "loop_structure",
            "roofline", "collectives"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
ROOFLINE_KEYS = {"flops", "hbm_bytes", "coll_bytes", "compute_s", "memory_s",
                 "collective_s", "dominant", "useful_ratio"}
COLLECTIVE_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute", "counts", "total"}
SHAPES = {"train": InputShape("train_small", 64, 8, "train"),
          "prefill": InputShape("prefill_small", 64, 8, "prefill"),
          "decode": InputShape("decode_small", 64, 8, "decode")}
ARCHS = ["h2o_danube_1p8b", "olmoe_1b_7b", "hymba_1p5b", "xlstm_350m",
         "phi3_vision_4p2b", "hubert_xlarge"]


def _jax_block_bytes(arch, sizes):
    """Rank 0's parameter block bytes from JAX's specs (f32)."""
    amesh = AbstractMesh(sizes, ("data", "model"))
    decls = jax_build(jax_smoke_config(arch)).decls
    specs = jax_specs.param_specs(decls, amesh)
    total = 0
    for d, s in zip(jax.tree.leaves(decls, is_leaf=lambda x: isinstance(
            x, jax_mod.ParamDecl)), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
        n = 1
        for dim, entry in zip(d.shape, tuple(s) + (None,) * len(d.shape)):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= dim // math.prod(amesh.shape[a] for a in axes)
        total += 4 * n
    return total


def _report(arch, kind, sizes=(2, 4)):
    cfg = get_smoke_config(arch)
    return cfg, dryrun.report_step(cfg, arch, SHAPES[kind],
                                   make_cpu_mesh(*sizes), "x".join(
                                       map(str, sizes)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_report_keys_memory_and_model_flops(arch, kind):
    cfg, r = _report(arch, kind)
    if r["plan"] != "run":          # hubert has no decode step
        assert kind == "decode" and not cfg.decoder
        return
    assert JAX_KEYS <= set(r)
    assert set(r["memory"]) == MEMORY_KEYS
    assert set(r["roofline"]) == ROOFLINE_KEYS
    assert set(r["collectives"]) == COLLECTIVE_KEYS
    shape = SHAPES[kind]
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    assert r["tokens_per_step"] == tokens and r["n_devices"] == 8
    mf = (6.0 if kind == "train" else 2.0) * cfg.active_param_count() * \
        tokens / 8
    roof = r["roofline"]
    np.testing.assert_allclose(roof["useful_ratio"] * roof["flops"], mf,
                               rtol=1e-12)
    assert roof["flops"] > 0 and roof["hbm_bytes"] > 0

    blocks = _jax_block_bytes(arch, (2, 4))
    rows = shape.global_batch // 2
    inputs = dryrun.build(cfg, "cpu").input_specs(shape)
    batch = sum(math.prod(sh) // shape.global_batch * rows *
                torch.empty((), dtype=dt).element_size()
                for sh, dt in inputs.values())
    want = (3 * blocks + 4 if kind == "train" else blocks) + batch
    if kind == "decode":
        caches = dryrun._empty_caches(cfg, rows, shape.seq_len, "cpu")
        want += dryrun._nbytes(caches)
    assert r["memory"]["argument_bytes"] == want
    assert r["memory"]["peak_bytes"] >= want
    assert r["collectives"]["counts"]["all-gather"] > 0
    if kind == "train":
        assert r["collectives"]["counts"]["reduce-scatter"] > 0
    if kind == "prefill":
        mesh = make_cpu_mesh(2, 4)
        model = fsdp.shard_model(cfg, mesh, device="cpu")
        gathers = sum(mesh.shape[e] > 1 if isinstance(e, str) else
                      math.prod(mesh.shape[a] for a in e) > 1
                      for name, p in model.named_parameters()
                      if not (name == "embed" and cfg.audio_frontend)
                      for e in p.spec if e is not None)
        assert r["collectives"]["counts"]["all-gather"] == gathers
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "olmoe_1b_7b",
                                  "hubert_xlarge"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_fake_trace_counts_the_real_step(arch, kind):
    cfg = get_smoke_config(arch)
    mesh = make_cpu_mesh(1, 1)
    with dryrun._fake():
        fake = dryrun.run_step(cfg, SHAPES[kind], mesh, microbatches=2
                               if kind == "train" else 1)
    real = dryrun.run_step(cfg, SHAPES[kind], mesh, device="cpu",
                           microbatches=2 if kind == "train" else 1)
    assert fake["flops"] == real["flops"] > 0
    assert fake["hbm_bytes"] == real["hbm_bytes"] > 0
    assert fake["records"] == real["records"] == []
    assert fake["memory"] == real["memory"]
    assert not dist.is_initialized()


def test_main_leaves_no_process_group(capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "xlstm_350m", "--shape", "decode_32k",
                     "--no-analysis"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert '"plan": "run"' in out and "1 combos, 0 errors" in out
    assert not dist.is_initialized()


@pytest.mark.parametrize("s,window,causal", [(40, 16, True), (40, None, True),
                                              (40, 16, False),
                                              (40, None, False),
                                              (40, 64, True), (40, 0, False)])
def test_swa_custom_op_and_its_flop_formula(s, window, causal):
    """K7's custom operator on CPU tensors (its plain version) passes
    ``opcheck``, and ``FlopCounterMode`` counts 4 D FLOPs for each pair
    its mask keeps (counted here from ``ref.swa_attention``'s mask)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 4, s, 32, generator=g)
    k, v = (torch.randn(2, 2, s, 32, generator=g) for _ in range(2))
    result = torch.library.opcheck(torch.ops.repro_torch.swa_attention.default,
                                   (q, k, v, window, causal))
    assert set(result.values()) == {"SUCCESS"}, result
    qi, ki = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = np.ones((s, s), bool)
    if causal:
        keep &= ki <= qi
    if window is not None:
        keep &= ki > qi - window
    assert ops.swa_pairs(s, window, causal) == int(keep.sum())
    with FlopCounterMode(display=False) as counter:
        ops.swa_attention(q, k, v, window=window, causal=causal)
    assert counter.get_total_flops() == 2 * 4 * int(keep.sum()) * 4 * 32
