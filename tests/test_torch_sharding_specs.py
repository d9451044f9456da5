"""The port's declarations, sharding rules, shapes, presets and roofline
arithmetic against the JAX package's, exactly.

* every arch of ``ARCH_IDS`` at full size: the declaration tree's paths,
  shapes, logical axes, init rules, scales and types equal JAX's
  (declarations only: nothing is materialised);
* ``param_specs`` on JAX's ``AbstractMesh`` (no devices) and on the
  port's layout ``Mesh`` of the same shape, for (16, 16), (2, 16, 16),
  (2, 4) and (1, 1), baseline and ``apply_optimized``: equal specs
  (hymba's 25 heads and dbrx's 8 KV heads fall back to replicated in
  both);
* the decode cache's declarations and specs at decode_32k, ``seq_shard``
  as the dry-run sets it (``n_kv_heads % model``);
* ``input_specs`` / ``input_axes``, ``plan_for`` and
  ``microbatches_for`` (1, 16 and 32 data shards) for every (arch,
  shape); ``OPTIMIZED`` and every config after ``apply_optimized``;
* ``RooflineReport.row()`` on the same terms, and ``collective_bytes`` on
  the same five collectives (an HLO text for JAX, ``ctx`` records for
  the port);
* the dry-run's ``_loop_structure``, ``_slstm_flop_correction`` and
  ``RECSYS_HYPER_PRESETS`` against JAX's, read in one subprocess
  (``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import optimized as jax_optimized  # noqa: E402
from repro.configs import shapes as jax_shapes  # noqa: E402
from repro.models import module as jax_mod  # noqa: E402
from repro.models.factory import build as jax_build  # noqa: E402
from repro.roofline import analysis as jax_roofline  # noqa: E402
from repro.sharding import specs as jax_specs  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs import optimized, shapes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import module as mod  # noqa: E402
from repro_torch.models.factory import build  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
LAYOUTS = [((16, 16), ("data", "model")),
           ((2, 16, 16), ("pod", "data", "model")),
           ((2, 4), ("data", "model")),
           ((1, 1), ("data", "model"))]
_DTYPES = {torch.int32: jnp.int32, torch.float32: jnp.float32,
           torch.bool: jnp.bool_}


def _meshes(sizes, names):
    return (AbstractMesh(sizes, names),
            Mesh(tuple(names), dict(zip(names, sizes))))


def _variants(arch):
    """(JAX config, port config, overrides) baseline and optimized."""
    out = []
    for opt in (False, True):
        jcfg, cfg = jax_config(arch), get_config(arch)
        if opt:
            jcfg, cfg = (jax_optimized.apply_optimized(jcfg),
                         optimized.apply_optimized(cfg))
        out.append((jcfg, cfg, dict(cfg.sharding_overrides) or None))
    return out


def _keys(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _jax_leaves(tree, leaf_type):
    return [(_keys(p), v) for p, v in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]]


def _leaves(tree, prefix=()):
    """(key path, leaf) of a port tree of dicts and tuples, in jax.tree's
    order (None is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         prefix + (k,))]
    if isinstance(tree, tuple) and not isinstance(tree, specs.PartitionSpec):
        return [x for i, v in enumerate(tree) for x in _leaves(v,
                                                               prefix + (i,))]
    return [(prefix, tree)]


def _same_decls(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert (tuple(g.shape), tuple(g.axes), g.init, g.scale, g.dtype) == (
            tuple(w.shape), tuple(w.axes), w.init, w.scale, w.dtype), key


def _same_specs(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert tuple(g) == tuple(w), (key, g, w)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decl_tree_matches_jax(arch):
    got = _leaves(build(get_config(arch), "cpu").decls)
    want = _jax_leaves(jax_build(jax_config(arch)).decls, jax_mod.ParamDecl)
    _same_decls(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["16x16", "2x16x16", "2x4", "1x1"])
def test_param_specs_match_jax(arch, layout):
    amesh, mesh = _meshes(*layout)
    for jcfg, cfg, ov in _variants(arch):
        want = jax_specs.param_specs(jax_build(jcfg).decls, amesh,
                                     overrides=ov)
        got = specs.param_specs(build(cfg, "cpu").decls, mesh, overrides=ov)
        _same_specs(_leaves(got), _jax_leaves(want, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax_at_decode_32k(arch):
    shape = SHAPES["decode_32k"]
    for layout in LAYOUTS[:3]:
        amesh, mesh = _meshes(*layout)
        for jcfg, cfg, ov in _variants(arch):
            if shapes.plan_for(cfg, shape) != "run":
                continue
            seq_shard = dryrun._needs_seq_shard(cfg, mesh)
            assert seq_shard == (jcfg.n_kv_heads % amesh.shape["model"] != 0)
            jd = jax_build(jcfg).cache_decls(shape.global_batch,
                                             shape.seq_len,
                                             seq_shard=seq_shard)
            d = build(cfg, "cpu").cache_decls(shape.global_batch,
                                              shape.seq_len,
                                              seq_shard=seq_shard)
            _same_decls(_leaves(d), _jax_leaves(jd, jax_mod.ParamDecl))
            want = jax_mod.map_decls(
                lambda x: jax_specs.resolve_spec(x.axes, x.shape, amesh,
                                                 jax_specs.ACT_RULES, ov), jd)
            got = mod.map_decls(
                lambda x: specs.resolve_spec(x.axes, x.shape, mesh,
                                             specs.ACT_RULES, ov), d)
            _same_specs(_leaves(got),
                        _jax_leaves(want, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inputs_plans_and_microbatches_match_jax(arch):
    jbundle, bundle = jax_build(jax_config(arch)), build(get_config(arch),
                                                         "cpu")
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        assert shapes.plan_for(bundle.cfg, shape) == jax_shapes.plan_for(
            jbundle.cfg, jshape)
        for n_data in (1, 16, 32):
            assert shapes.microbatches_for(bundle.cfg, shape, n_data) == \
                jax_shapes.microbatches_for(jbundle.cfg, jshape, n_data)
        want = jbundle.input_specs(jshape)
        got = bundle.input_specs(shape)
        assert sorted(got) == sorted(want)
        for k, (sh, dt) in got.items():
            assert tuple(sh) == tuple(want[k].shape), (name, k)
            assert jnp.dtype(_DTYPES[dt]) == want[k].dtype, (name, k)
        assert bundle.input_axes(shape) == jbundle.input_axes(jshape)


def test_optimized_presets_match_jax():
    assert optimized.OPTIMIZED == jax_optimized.OPTIMIZED
    for arch in ARCH_IDS:
        got = optimized.apply_optimized(get_config(arch))
        want = jax_optimized.apply_optimized(jax_config(arch))
        assert optimized.cfg_id(got) == jax_optimized.cfg_id(want)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch


def test_roofline_report_row_matches_jax():
    terms = dict(flops=3.5e15, hbm_bytes=2.25e12, coll_bytes=7.5e10,
                 coll_detail={}, compute_s=1.25, memory_s=0.5,
                 collective_s=2.0, model_flops=1.75e15)
    assert roofline.RooflineReport(**terms).row() == \
        jax_roofline.RooflineReport(**terms).row()
    for c, m, k in ((3.0, 1.0, 2.0), (1.0, 3.0, 2.0), (0.0, 0.0, 0.0)):
        t = dict(terms, compute_s=c, memory_s=m, collective_s=k, flops=0.0)
        assert roofline.RooflineReport(**t).dominant == \
            jax_roofline.RooflineReport(**t).dominant
        assert roofline.RooflineReport(**t).useful_ratio == 0.0


def test_collective_bytes_match_jax():
    hlo = textwrap.dedent("""\
        %ag = bf16[16,2560,80]{2,1,0} all-gather(bf16[1,2560,80]{2,1,0} %p), replica_groups=[16,16]<=[256], dimensions={0}
        %ar = f32[3]{0} all-reduce(f32[3]{0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
        %rs = f32[2,6912]{1,0} reduce-scatter(f32[32,6912]{1,0} %g), replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add
        %a2a = bf16[8,128]{1,0} all-to-all(bf16[8,128]{1,0} %y), replica_groups={{0,1}}
        %cp = s32[64]{0} collective-permute(s32[64]{0} %z), source_target_pairs={{0,1},{1,0}}
        """)
    records = [ctx.Record("all-gather", 16 * 2560 * 80 * 2, 16),
               ctx.Record("all-reduce", 3 * 4, 4),
               ctx.Record("reduce-scatter", 2 * 6912 * 4, 16),
               ctx.Record("all-to-all", 8 * 128 * 2, 2),
               ctx.Record("collective-permute", 64 * 4, 2)]
    want = jax_roofline.collective_bytes(hlo)
    assert want["total"] > 0 and all(want["counts"].values())
    assert roofline.collective_bytes(records) == want


def test_dryrun_loop_structure_matches_jax():
    code = """
        import json
        from repro.launch import dryrun
        from repro.configs import ARCH_IDS, SHAPES, get_config
        from repro.configs.shapes import plan_for
        out = {"presets": dryrun.RECSYS_HYPER_PRESETS, "rows": []}
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for name, shape in SHAPES.items():
                if plan_for(cfg, shape) != "run":
                    continue
                out["rows"].append([arch, name,
                                    dryrun._loop_structure(cfg, shape),
                                    dryrun._slstm_flop_correction(cfg, shape,
                                                                  16)])
        print(json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert run.returncode == 0, run.stderr
    want = json.loads(run.stdout.strip().splitlines()[-1])
    assert dryrun.RECSYS_HYPER_PRESETS == want["presets"]
    assert len(want["rows"]) > 20
    for arch, name, loops, extra in want["rows"]:
        cfg = get_config(arch)
        got = dryrun._loop_structure(cfg, SHAPES[name])
        assert [list(x) for x in got] == loops, (arch, name)
        assert dryrun._slstm_flop_correction(cfg, SHAPES[name], 16) == \
            extra, (arch, name)
