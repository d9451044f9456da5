"""Checkpoints of the PyTorch port against the JAX package.

  * the checkpointer alone: a tree of nested dicts, tuples, NamedTuples,
    lists, ``None``, ints, strings and arrays (bf16 among them) makes the
    same bytes in both packages, each reads the other's file back (bf16
    bits included), ``latest_step`` picks the highest step, and a
    directory without checkpoints raises ``FileNotFoundError``;
  * ``save_stream_checkpoint`` / ``restore_stream_checkpoint`` across the
    packages for DISGD, DICS and BPR-MF under the default policy,
    ``compressed()``, ``compressed(factors="bf16")`` (and ``co="int8"``
    for DICS), in the logical and the legacy format, with a re-queue carry
    and a drift detector: both packages write byte-identical files from
    equal states (else the test names the first key that differs), and
    a file either package writes restores in the other to the same
    resident leaves, bit for bit; a logical file restores at another
    grid to what ``regrid`` gives, in both packages;
  * every error, equal to JAX's: ``StoragePolicyError`` naming both
    policies, ``CheckpointShapeError`` (grid and leaf count), another
    algorithm, an unknown format;
  * resume: half a stream, checkpoint, restore, the other half (adaptive
    drift on, detector and carry handed over) equals the whole stream;
  * the session: ``checkpoint`` / ``restore`` / ``rescale`` against JAX's
    ``StreamSession`` — the detector saved and restored, ``rescale`` to a
    new grid and policy (and back) with the same states, ``table_bytes``
    gauges and ``recommend`` answers as JAX's.
"""

import dataclasses
import functools
import os
from typing import NamedTuple

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import regrid as jrg  # noqa: E402
from repro.core import storage as jstorage  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core import convert, regrid, storage  # noqa: E402
from tests.test_torch_drift import _policies as _drift_policies  # noqa: E402
from tests.test_torch_drift import _scenario  # noqa: E402
from tests.test_torch_storage import (HYPERS, POLICIES,  # noqa: E402
                                      _assert_same_tables, _bits, _policies,
                                      _stream)

CAPS = dict(u_cap=128, i_cap=32)
CASES = ([(a, p) for a in ("bpr", "dics", "disgd")
          for p in ("default", "compressed", "bf16")] + [("dics", "int8")])


def _cfgs(algo, policy="default", grid=(2, 2), drift=False, **over):
    th, jh = HYPERS[algo]
    tp, jp = _policies(policy)
    td, jd = _drift_policies() if drift else (None, None)
    t = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec.rect(*grid),
                        micro_batch=256, backend="cuda", hyper=th(**CAPS),
                        device="cpu", storage=tp, drift=td, **over)
    j = jpipe.StreamConfig(algorithm=algo, grid=JGrid.rect(*grid),
                           micro_batch=256, backend="pallas",
                           hyper=jh(**CAPS), storage=jp, drift=jd, **over)
    return t, j


@functools.lru_cache(maxsize=None)
def _jax_run(algo, policy):
    """JAX's adaptive run (a detector to save), shared by the tests."""
    users, items = _scenario()
    return jpipe.run_stream(users[:1536], items[:1536],
                            _cfgs(algo, policy, drift=True)[1])


def _port_states(j_states):
    return convert.states_from_numpy(
        convert.flatten_state(jax.tree.map(np.asarray, j_states)),
        device="cpu")


def _file(directory, step):
    return os.path.join(directory, f"step_{step:08d}.msgpack")


def _first_difference(a, b, path="") -> str | None:
    """The first key path where two decoded msgpack trees differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        if list(a) != list(b):
            return f"{path or '/'}: keys {list(a)} != {list(b)}"
        for k in a:
            d = _first_difference(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            d = _first_difference(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path or '/'}: {str(a)[:80]} != {str(b)[:80]}"


def _assert_same_file(got, want):
    with open(got, "rb") as f:
        g = f.read()
    with open(want, "rb") as f:
        w = f.read()
    if g != w:
        diff = _first_difference(msgpack.unpackb(g, raw=False),
                                 msgpack.unpackb(w, raw=False))
        pytest.fail(f"checkpoint files differ first at {diff}")


# -- the checkpointer ------------------------------------------------------------


class _Pair(NamedTuple):
    a: object
    b: object


def _trees():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    common = dict(
        ints=np.arange(5, dtype=np.int64), flags=x > 0, none=None,
        nested={"z": [1, "two", None], "a": (np.int32(7), 3.5)},
        empty=np.zeros((2, 0), np.float32), text="sr-logical-v1", n=11)
    j = dict(common, bf=jnp.asarray(x).astype(jnp.bfloat16),
             pair=_Pair(jnp.asarray(x), None))
    t = dict(common, bf=torch.tensor(x).to(torch.bfloat16),
             pair=_Pair(torch.tensor(x), None))
    return j, t


def test_checkpointer_bytes_and_round_trips_match_jax(tmp_path):
    j_tree, t_tree = _trees()
    j_tree["nested"]["a"] = (np.asarray(7, np.int32), 3.5)
    t_tree["nested"]["a"] = (np.asarray(7, np.int32), 3.5)
    jp = jckpt.save_checkpoint(str(tmp_path / "j"), 3, j_tree)
    tp = tckpt.save_checkpoint(str(tmp_path / "t"), 3, t_tree)
    assert os.path.basename(tp) == "step_00000003.msgpack"
    _assert_same_file(tp, jp)
    step, back = tckpt.restore_checkpoint(str(tmp_path / "j"))
    assert step == 3
    assert back["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["bf"].view(torch.uint16).numpy(),
                                  np.asarray(j_tree["bf"]).view(np.uint16))
    assert isinstance(back["pair"], tuple) and back["pair"][1] is None
    np.testing.assert_array_equal(back["pair"][0], np.asarray(
        j_tree["pair"][0]))
    assert back["nested"]["z"] == [1, "two", None] and back["none"] is None
    assert back["text"] == "sr-logical-v1" and back["n"] == 11
    _, j_back = jckpt.restore_checkpoint(str(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(j_back["bf"]).view(np.uint16),
                                  np.asarray(j_tree["bf"]).view(np.uint16))
    np.testing.assert_array_equal(j_back["flags"], j_tree["flags"])


def test_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(d)
    for step in (7, 120, 30):
        tckpt.save_checkpoint(d, step, {"s": step})
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 120
    assert tckpt.restore_checkpoint(d) == (120, {"s": 120})
    assert tckpt.restore_checkpoint(d, 7) == (7, {"s": 7})
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


# -- stream checkpoints across the packages --------------------------------------


@pytest.mark.parametrize("fmt", ["logical", "legacy"])
@pytest.mark.parametrize("algo,policy", CASES,
                         ids=[f"{a}-{p}" for a, p in CASES])
def test_checkpoints_cross_the_packages(tmp_path, algo, policy, fmt):
    jr = _jax_run(algo, policy)
    t_cfg, j_cfg = _cfgs(algo, policy, drift=True)
    tp, jp = _policies(policy)
    states = _port_states(jr.final_states)
    carry = (np.arange(5, dtype=np.int64), np.arange(5, 10, dtype=np.int64))
    kw = dict(carry=carry, storage=None if policy == "default" else jp,
              detector=jr.final_detector)
    grid = {} if fmt == "legacy" else dict(grid=JGrid.rect(2, 2),
                                           algorithm=algo)
    jf = jpipe.save_stream_checkpoint(str(tmp_path / "j"), 1536,
                                      jr.final_states, **grid, **kw)
    grid = {} if fmt == "legacy" else dict(grid=rt.GridSpec.rect(2, 2),
                                           algorithm=algo)
    kw.update(storage=None if policy == "default" else tp,
              detector=rt.drift.DetectorState(*jr.final_detector))
    tf = rt.save_stream_checkpoint(str(tmp_path / "t"), 1536, states,
                                   **grid, **kw)
    _assert_same_file(tf, jf)

    # Each restores the other's file to the same resident leaves.
    ck = rt.restore_stream_checkpoint(str(tmp_path / "j"), t_cfg)
    assert ck.events_processed == 1536
    _assert_same_tables(ck.states, jax.tree.map(np.asarray,
                                                jr.final_states))
    for a, b in zip(ck.carry, carry):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ck.detector, jr.final_detector):
        np.testing.assert_array_equal(a, np.asarray(b))
    jck = jpipe.restore_stream_checkpoint(str(tmp_path / "t"), j_cfg)
    _assert_same_tables(states, jax.tree.map(np.asarray, jck.states))
    if fmt == "logical":
        # At another grid: what regrid gives, in both packages.
        for dst in ((1, 4), (4, 2)):
            t_dst, j_dst = _cfgs(algo, policy, grid=dst, drift=True)
            ck = rt.restore_stream_checkpoint(str(tmp_path / "j"), t_dst)
            jck = jpipe.restore_stream_checkpoint(str(tmp_path / "t"), j_dst)
            _assert_same_tables(ck.states, jax.tree.map(np.asarray,
                                                        jck.states))
            _assert_same_tables(ck.states, regrid.regrid(
                states, t_cfg.grid, t_dst.grid, storage=tp))
            _assert_same_tables(ck.states, jax.tree.map(np.asarray, jrg.regrid(
                jr.final_states, j_cfg.grid, j_dst.grid, storage=jp)))


# -- errors --------------------------------------------------------------------


def _saved(tmp_path, algo="disgd", policy="compressed", fmt="logical"):
    jr = _jax_run(algo, policy)
    grid = {} if fmt == "legacy" else dict(grid=JGrid.rect(2, 2))
    jpipe.save_stream_checkpoint(str(tmp_path), 1536, jr.final_states,
                                 storage=_policies(policy)[1], **grid)
    return str(tmp_path)


def _both_raise(exc, t_call, j_call):
    """Both calls raise, the port ``exc``, JAX its class of that name, with
    the same message; returns the port's error."""
    with pytest.raises(exc) as t:
        t_call()
    with pytest.raises(ValueError) as j:
        j_call()
    assert type(j.value).__name__ == exc.__name__
    assert str(t.value) == str(j.value)
    return t.value


def test_policy_mismatch_names_both_policies(tmp_path):
    d = _saved(tmp_path)
    t_cfg, j_cfg = _cfgs("disgd", "default")
    err = _both_raise(rt.StoragePolicyError,
                      lambda: rt.restore_stream_checkpoint(d, t_cfg),
                      lambda: jpipe.restore_stream_checkpoint(d, j_cfg))
    assert err.checkpoint_policy == _policies("compressed")[0]
    assert err.config_policy == rt.StoragePolicy()
    assert repr(err.checkpoint_policy) in str(err)


@pytest.mark.parametrize("case", ["grid", "leaves"])
def test_legacy_shape_errors(tmp_path, case):
    d = _saved(tmp_path, "disgd", "default", fmt="legacy")
    algo, grid = ("disgd", (4, 2)) if case == "grid" else ("dics", (2, 2))
    t_cfg, j_cfg = _cfgs(algo, "default", grid=grid)
    err = _both_raise(rt.core.regrid.CheckpointShapeError,
                      lambda: rt.restore_stream_checkpoint(d, t_cfg),
                      lambda: jpipe.restore_stream_checkpoint(d, j_cfg))
    assert err.checkpoint_workers == 4 and "regrid" in str(err)
    assert (err.config_grid.n_i, err.config_grid.g) == grid


def test_algorithm_mismatch_and_unknown_format(tmp_path):
    d = _saved(tmp_path, "disgd", "default")
    t_cfg, j_cfg = _cfgs("dics", "default")
    _both_raise(ValueError, lambda: rt.restore_stream_checkpoint(d, t_cfg),
                lambda: jpipe.restore_stream_checkpoint(d, j_cfg))
    _, tree = tckpt.restore_checkpoint(d)
    tree["format"] = "sr-logical-v9"
    tckpt.save_checkpoint(d, 1536, tree)
    t_cfg, j_cfg = _cfgs("disgd", "default")
    err = _both_raise(ValueError,
                      lambda: rt.restore_stream_checkpoint(d, t_cfg),
                      lambda: jpipe.restore_stream_checkpoint(d, j_cfg))
    assert "sr-logical-v9" in str(err)


# -- resume --------------------------------------------------------------------


@pytest.mark.parametrize("algo,policy", [("disgd", "compressed"),
                                         ("dics", "compressed"),
                                         ("bpr", "bf16")])
def test_resume_from_a_checkpoint_equals_one_run(tmp_path, algo, policy):
    users, items = _scenario()
    t_cfg, _ = _cfgs(algo, policy, drift=True)
    whole = rt.run_stream(users, items, t_cfg)
    # The controller's boost window is not checkpointed (nor in JAX): cut
    # where none is open, after the detector has fired once.
    flags = whole.drift_flags
    first = int(np.argmax(flags))
    b0 = next(b for b in range(first + 1, flags.size)
              if not flags[max(0, b - 3):b].any())
    cut = 256 * b0
    a = rt.run_stream(users[:cut], items[:cut], t_cfg)
    rt.save_stream_checkpoint(str(tmp_path), a.events_processed,
                              a.final_states, grid=t_cfg.grid,
                              algorithm=algo, detector=a.final_detector,
                              storage=t_cfg.storage)
    ck = rt.restore_stream_checkpoint(str(tmp_path), t_cfg)
    b = rt.run_stream(users[cut:], items[cut:], t_cfg,
                      initial_states=ck.states, initial_carry=ck.carry,
                      initial_detector=ck.detector)
    np.testing.assert_array_equal(
        np.concatenate([a.drift_flags, b.drift_flags]), whole.drift_flags)
    _assert_same_tables(b.final_states, whole.final_states)
    bits = np.concatenate([a.recall.bits(), b.recall.bits()])
    np.testing.assert_array_equal(bits[~np.isnan(bits)],
                                  whole.recall.bits()[~np.isnan(
                                      whole.recall.bits())])


# -- the session -----------------------------------------------------------------


def _sessions(algo, policy="default"):
    t_cfg, j_cfg = _cfgs(algo, policy, drift=True)
    t = rt.StreamSession(t_cfg, serve=rt.ServeConfig.from_stream(
        t_cfg, batch_size=64))
    j = repro.StreamSession(j_cfg, serve=repro.ServeConfig.from_stream(
        j_cfg, batch_size=64))
    return t, j


def _gauges(session):
    fam = session.metrics.get("table_bytes")
    return sorted((tuple(sorted(lab.items())), g.value)
                  for lab, g in fam.series())


def _assert_session_matches(t, j, algo, queries):
    _assert_same_tables(t.states, jax.tree.map(np.asarray, j.states),
                        factor_rtol=1e-5)
    assert _gauges(t) == _gauges(j)
    assert t.events_processed == j.events_processed
    got, want = t.recommend(queries), j.recommend(queries)
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)
    assert t.frontend.cfg.grid.n_c == j.frontend.cfg.grid.n_c


@pytest.mark.parametrize("algo", ["disgd", "dics"])
def test_session_checkpoint_restore_and_rescale_match_jax(tmp_path, algo):
    users, items = _scenario()
    queries = np.unique(users[:1536])[:40]
    t, j = _sessions(algo)
    t.ingest(users[:1536], items[:1536])
    j.ingest(users[:1536], items[:1536])
    _assert_session_matches(t, j, algo, queries)
    # The detector rides along, and either package restores either file.
    t.checkpoint(str(tmp_path / "t"))
    j.checkpoint(str(tmp_path / "j"))
    t_cfg, j_cfg = t.cfg, j.cfg
    t2 = rt.StreamSession.restore(str(tmp_path / "j"), t_cfg)
    j2 = repro.StreamSession.restore(str(tmp_path / "t"), j_cfg)
    for a, b in zip(t2._detector, j._detector):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(j2._detector, j._detector):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t2.ingest(users[1536:], items[1536:])
    j2.ingest(users[1536:], items[1536:])
    _assert_session_matches(t2, j2, algo, queries)
    # Rescale: a new grid and policy, then back to the default.
    policy = "compressed" if algo == "disgd" else "int8"
    tp, jp = _policies(policy)
    for grid, caps, (tpol, jpol) in (
            ((4, 2), dict(u_cap=96, i_cap=32), (tp, jp)),
            ((2, 2), {}, (rt.StoragePolicy(), jstorage.StoragePolicy()))):
        t2.rescale(rt.GridSpec.rect(*grid), storage=tpol, **caps)
        j2.rescale(JGrid.rect(*grid), storage=jpol, **caps)
        assert t2.cfg.storage == tpol and t2.cfg.grid.n_c == grid[0] * grid[1]
        assert (t2.frontend.cfg.storage is None) == tpol.is_default
        _assert_session_matches(t2, j2, algo, queries)
    assert t2.metrics.get("span_seconds").labels(stage="regrid").count == 2


def test_rescale_to_the_same_grid_is_the_identity():
    users, items = (x[:1536] for x in _scenario())
    t, _ = _sessions("disgd", "compressed")
    t.ingest(users, items)
    before = {k: _bits(v).copy() for k, v in convert.flatten_state(
        t.states).items()}
    answer = t.recommend(users[:8])
    t.rescale(t.cfg.grid)
    for k, v in convert.flatten_state(t.states).items():
        np.testing.assert_array_equal(_bits(v), before[k], err_msg=k)
    again = t.recommend(users[:8])
    np.testing.assert_array_equal(again.ids, answer.ids)
    assert again.cache_hits == 0           # retarget dropped the cache
    assert storage.state_nbytes(t.states)["rated"][0] == "uint32"
