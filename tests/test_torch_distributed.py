"""The S&R worker grid across processes against the JAX package.

``backend="shard_map"`` of the port runs one worker a rank of a
``torch.distributed`` process group (``core/distributed.py``,
``launch/mesh.py``); here four gloo ranks on the CPU, started once for
the module by ``launch.mesh.run_on_ranks`` (``_rank_cases``), with every
case below asserting on what they returned:

  * the grid step (``make_grid_step``) against JAX's
    ``repro.core.distributed.make_grid_step`` on a ``(data=2, model=2)``
    mesh of four host devices (a subprocess, as ``tests/test_sharding.py``
    runs it), on ``tests/test_sharding.py``'s events (numpy seed 0, 256
    events, bucketed with ``bucket_dispatch_np``), for DISGD, DICS and
    BPR-MF: hits bit for bit, integer state exactly, floats within 1e-6 /
    1e-7 (that test's tolerance);
  * the whole stream against JAX's ``scan`` at
    ``tests/test_engine.py::test_shard_map_backend_matches_scan``'s
    configuration (``GridSpec(2)``, micro-batch 256, caps 128 / 32, the
    first 1,000 events of ``scaled(MOVIELENS_25M, 0.002)``): the
    NaN-filtered recall bits, the counters, the load history, and each
    rank's worker against JAX's row (floats within 1e-5, as
    ``tests/test_torch_pipeline.py``);
  * the whole stream against the port's ``scan`` under LRU forgetting,
    DICS's adaptive drift policy and ``StoragePolicy.compressed()`` on
    ``make_scenario("abrupt", events=6144, seed=0)``: everything bit for
    bit, the telemetry vector, ``forgets`` and the drift flags included;
  * the mesh: ``make_grid_mesh``'s refusal of a grid larger than the
    group, a smaller grid bound to the group's first ranks (as
    ``jax.make_mesh``), ``grid_from_mesh`` as its inverse, the
    production layouts, ``grid_state_specs``; the launcher's failures
    (a rank that fails before the rendezvous, a group past its timeout).

The session, publishing, checkpoints, restore and rescale on the grid
are ``tests/test_torch_grid_session.py``'s.

Three spawns in all, each with its own timeout.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import convert, distributed, engine, routing  # noqa: E402
from repro_torch.core.forgetting import ForgettingConfig  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.drift import DetectorConfig, DriftPolicy, make_scenario  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANKS = 4
GRID = rt.GridSpec(2)
SPAWN_TIMEOUT = 240.0
ALGOS = ("disgd", "dics", "bpr")
HYPERS = {"disgd": rt.DisgdHyper, "dics": rt.DicsHyper, "bpr": rt.BprHyper}
# tests/test_sharding.py's grid-step caps; the engine test's stream caps.
STEP_CAPS = dict(u_cap=64, i_cap=32)
STREAM_CAPS = dict(u_cap=128, i_cap=32)
STREAM_EVENTS = 1000
STEP_RTOL, STEP_ATOL = 1e-6, 1e-7
STREAM_RTOL, STREAM_ATOL = 1e-5, 1e-5
# Against the port's scan: a stream with a drift, LRU passes that evict,
# and a detector that fires (the adaptive policy of the card tests).
POLICIES = {
    "lru": ("disgd", dict(forgetting=ForgettingConfig(
        policy="lru", trigger_every=400, lru_max_age=150))),
    "adaptive": ("dics", dict(drift=DriftPolicy(
        detector=DetectorConfig(warmup=512, drop_frac=0.1, ph_lambda=0.1),
        boost_batches=3))),
    "compressed": ("disgd", dict(storage=rt.StoragePolicy.compressed())),
}


def _step_events():
    """``tests/test_sharding.py``'s bucketed events: int32 ``[n_c, cap]``."""
    cap = _step_cfg("disgd").bucket_capacity
    rng = np.random.default_rng(0)
    users = rng.integers(0, 200, 256)
    items = rng.integers(0, 100, 256)
    keys = (items % GRID.n_i) * GRID.g + (users % GRID.g)
    buckets, _, _ = routing.bucket_dispatch_np(keys, GRID.n_c, cap)
    src = np.clip(buckets, 0, None)
    return (np.where(buckets >= 0, users[src], -1).astype(np.int32),
            np.where(buckets >= 0, items[src], -1).astype(np.int32))


def _step_cfg(algo, device="cpu"):
    return rt.StreamConfig(algorithm=algo, grid=GRID, micro_batch=256,
                           hyper=HYPERS[algo](**STEP_CAPS), device=device)


def _stream():
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:STREAM_EVENTS], items[:STREAM_EVENTS]


def _stream_cfg(algo, **over):
    return dataclasses.replace(
        rt.StreamConfig(algorithm=algo, grid=GRID, micro_batch=256,
                        hyper=HYPERS[algo](**STREAM_CAPS), backend="scan",
                        device="cpu"), **over)


def _scenario():
    sc = make_scenario("abrupt", events=6144, seed=0)
    return sc.users, sc.items


def _policy_cfg(name, backend="scan"):
    algo, over = POLICIES[name]
    hyper = rt.get_algorithm(algo).default_hyper()._replace(u_cap=256,
                                                            i_cap=64)
    return rt.StreamConfig(algorithm=algo, grid=GRID, micro_batch=256,
                           hyper=hyper, backend=backend, device="cpu",
                           **over)


def _mesh_checks() -> dict:
    """What ``make_grid_mesh`` does inside a group of RANKS."""
    out = {}
    try:
        mesh_lib.make_grid_mesh(rt.GridSpec(4))
        out["fewer"] = None
    except ValueError as e:
        out["fewer"] = str(e)
    # A grid smaller than the group binds its first n_c ranks.
    one = rt.GridSpec.rect(1, 1)
    small = mesh_lib.make_grid_mesh(one)
    cfg = dataclasses.replace(_step_cfg("disgd"), grid=one)
    out["more"] = dict(shape=dict(small.shape), rank=small.rank,
                       world=small.world, holds=small.holds_worker,
                       rated=tuple(distributed.init_grid_states(cfg, small)
                                   .rated.shape))
    mesh = mesh_lib.make_grid_mesh(GRID)
    out["grid"] = distributed.grid_from_mesh(mesh)
    out["shape"] = dict(mesh.shape)
    out["rank"] = mesh.rank
    return out


def _rank_cases(info) -> dict:
    """Everything the module asks of one rank of the group."""
    mesh = mesh_lib.make_grid_mesh(GRID)
    ev_u, ev_i = (torch.as_tensor(x).reshape(GRID.n_i, GRID.g, -1)
                  for x in _step_events())
    steps = {}
    for algo in ALGOS:
        cfg = _step_cfg(algo, info.device)
        states = distributed.init_grid_states(cfg, mesh)
        states, hits, evaluated = distributed.make_grid_step(cfg, mesh)(
            states, ev_u, ev_i)
        steps[algo] = (convert.states_to_numpy(states), hits.numpy(),
                       evaluated.numpy())
    users, items = _stream()
    su, si = _scenario()
    cases = ([(users, items, _stream_cfg(a)) for a in ALGOS]
             + [(su, si, _policy_cfg(p)) for p in POLICIES])
    streams = distributed.stream_on_rank(info, cases)
    return dict(steps=steps,
                jax=dict(zip(ALGOS, streams[:len(ALGOS)])),
                port=dict(zip(POLICIES, streams[len(ALGOS):])),
                mesh=_mesh_checks(), info=info)


_JAX = """
    import sys
    import jax, numpy as np
    from repro.algos.bpr import BprHyper
    from repro.core import distributed as dist, routing
    from repro.core.dics import DicsHyper
    from repro.core.disgd import DisgdHyper
    from repro.core.pipeline import StreamConfig, run_stream

    def leaves(states, prefix, out):
        for name, leaf in zip(type(states.tables)._fields, states.tables):
            out[f"{prefix}/{name}"] = np.asarray(leaf)
        for name in states._fields[1:]:
            if getattr(states, name) is not None:
                out[f"{prefix}/{name}"] = np.asarray(getattr(states, name))

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    grid = routing.GridSpec(2)
    hypers = {"disgd": DisgdHyper, "dics": DicsHyper, "bpr": BprHyper}
    inp = np.load(sys.argv[1])
    out = {}
    for algo, hyper in hypers.items():
        # The grid step (tests/test_sharding.py's caps and events).
        cfg = StreamConfig(algorithm=algo, grid=grid, micro_batch=256,
                           hyper=hyper(u_cap=64, i_cap=32))
        shape = (grid.n_i, grid.g, cfg.bucket_capacity)
        s2, hits, evaluated = dist.make_grid_step(cfg, mesh)(
            dist.init_grid_states(cfg, mesh), inp["ev_u"].reshape(shape),
            inp["ev_i"].reshape(shape))
        out[f"{algo}/step/hits"] = np.asarray(hits)
        out[f"{algo}/step/evaluated"] = np.asarray(evaluated)
        leaves(s2, f"{algo}/step/state", out)
        # The stream on scan (tests/test_engine.py's configuration).
        cfg = StreamConfig(algorithm=algo, grid=grid, micro_batch=256,
                           hyper=hyper(u_cap=128, i_cap=32), backend="scan")
        res = run_stream(inp["users"], inp["items"], cfg)
        out[f"{algo}/scan/bits"] = res.recall.bits()
        out[f"{algo}/scan/loads"] = np.stack(res.load_history)
        out[f"{algo}/scan/counts"] = np.asarray(
            [res.events_processed, res.dropped])
        leaves(res.final_states, f"{algo}/scan/state", out)
    np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The module's runs: the ranks (one spawn), JAX's grid step and
    scans in a subprocess of four host devices started before them, and
    the port's scans here while the ranks work."""
    tmp = tmp_path_factory.mktemp("grid")
    ev_u, ev_i = _step_events()
    users, items = _stream()
    np.savez(tmp / "in.npz", ev_u=ev_u, ev_i=ev_i, users=users, items=items)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    t0 = time.perf_counter()
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), str(tmp / "in.npz"),
         str(tmp / "out.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
    try:
        grid = mesh_lib.run_on_ranks(_rank_cases, RANKS, "cpu",
                                     timeout=SPAWN_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        su, si = _scenario()
        port = {name: rt.run_stream(su, si, _policy_cfg(name))
                for name in POLICIES}
        log, _ = jax_proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    print(f"{RANKS} ranks {t_ranks:.1f} s, "
          f"all {time.perf_counter() - t0:.1f} s")
    return dict(ranks=grid, jax=dict(np.load(tmp / "out.npz")), port=port)


def _jax_state(jax_out, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in jax_out.items() if k.startswith(prefix + "/")}


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_step_matches_jax(runs, algo):
    jx = runs["jax"]
    want_states = _jax_state(jx, f"{algo}/step/state")
    g = GRID.g
    for rank, out in enumerate(runs["ranks"].results):
        states, hits, evaluated = out["steps"][algo]
        # Every rank holds the whole grid's bits, JAX's out_specs.
        np.testing.assert_array_equal(hits, jx[f"{algo}/step/hits"])
        np.testing.assert_array_equal(evaluated, jx[f"{algo}/step/evaluated"])
        row, col = divmod(rank, g)
        assert set(states) == set(want_states)
        for name, got in states.items():
            want = want_states[name][row, col]
            assert got.shape == (1,) + want.shape, name
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got[0], want, rtol=STEP_RTOL,
                                           atol=STEP_ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(got[0], want, err_msg=name)
    assert evaluated.sum() == 256


def _nan_free(bits):
    return bits[~np.isnan(bits)]


@pytest.mark.parametrize("algo", ALGOS)
def test_stream_matches_jax_scan(runs, algo):
    users, _ = _stream()
    jx = runs["jax"]
    want_states = _jax_state(jx, f"{algo}/scan/state")
    processed, dropped = jx[f"{algo}/scan/counts"]
    for rank, out in enumerate(runs["ranks"].results):
        res = out["jax"][algo].result
        np.testing.assert_array_equal(_nan_free(res.recall.bits()),
                                      _nan_free(jx[f"{algo}/scan/bits"]))
        assert res.events_processed == processed == users.size
        assert res.dropped == dropped == 0
        np.testing.assert_array_equal(np.stack(res.load_history),
                                      jx[f"{algo}/scan/loads"])
        assert set(res.final_states) == set(want_states)
        for name, w in want_states.items():
            got = res.final_states[name]
            assert got.shape == (1,) + w.shape[1:], name
            if w.dtype.kind == "f":
                np.testing.assert_allclose(got[0], w[rank], rtol=STREAM_RTOL,
                                           atol=STREAM_ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(got[0], w[rank], err_msg=name)


@pytest.mark.parametrize("name", list(POLICIES))
def test_stream_matches_port_scan(runs, name):
    want = runs["port"][name]
    states = convert.states_to_numpy(want.final_states)
    for rank, out in enumerate(runs["ranks"].results):
        res = out["port"][name].result
        np.testing.assert_array_equal(res.recall.bits(), want.recall.bits())
        assert (res.events_processed, res.dropped, res.forgets) == (
            want.events_processed, want.dropped, want.forgets)
        np.testing.assert_array_equal(np.stack(res.load_history),
                                      np.stack(want.load_history))
        for a, b in ((res.user_occupancy, want.user_occupancy),
                     (res.item_occupancy, want.item_occupancy)):
            assert [n for n, _ in a] == [n for n, _ in b]
            np.testing.assert_array_equal(np.stack([o for _, o in a]),
                                          np.stack([o for _, o in b]))
        for field, x, y in zip(want.telemetry._fields, res.telemetry,
                               want.telemetry):
            np.testing.assert_array_equal(x, y, err_msg=field)
        if want.drift_flags is None:
            assert res.drift_flags is None
        else:
            np.testing.assert_array_equal(res.drift_flags, want.drift_flags)
            np.testing.assert_array_equal(np.stack(res.final_detector),
                                          np.stack(want.final_detector))
        for leaf, w in states.items():
            np.testing.assert_array_equal(res.final_states[leaf][0],
                                          w[rank], err_msg=leaf)
    # The cases do what they are there for.
    if name == "lru":
        assert want.forgets > 0 and int(want.telemetry.evictions) > 0
    if name == "adaptive":
        assert int(want.drift_flags.sum()) > 0


@pytest.mark.parametrize("case", [f"jax.{a}" for a in ALGOS]
                         + [f"port.{p}" for p in POLICIES])
def test_collectives_a_step(runs, case):
    """One all-reduce a step; two where a forgetting pass or the
    controller may change the occupancies after the worker."""
    kind, name = case.split(".")
    cfg = (_stream_cfg(name) if kind == "jax" else _policy_cfg(name))
    n = (_stream()[0] if kind == "jax" else _scenario()[0]).size
    steps = (-(-n // cfg.micro_batch)
             + -(-cfg.micro_batch // cfg.bucket_capacity))
    per_step = 2 if (cfg.forgetting is not None and cfg.forgetting.policy
                     != "none") or cfg.drift is not None else 1
    for out in runs["ranks"].results:
        stats = out[kind][name].collectives
        assert stats["calls"] == per_step * steps
        assert stats["ms"] > 0
        assert out[kind][name].peak_bytes is None


def test_ranks_and_backend(runs):
    grid = runs["ranks"]
    assert grid.backend == "gloo" and grid.ranks_per_card == 0
    assert [out["info"].rank for out in grid.results] == list(range(RANKS))
    assert all(out["info"].device == "cpu" for out in grid.results)


@pytest.mark.parametrize("what", ["fewer", "more", "inverse"])
def test_grid_mesh_inside_a_group(runs, what):
    for rank, out in enumerate(runs["ranks"].results):
        m = out["mesh"]
        if what == "fewer":
            assert m["fewer"] == ("S&R grid needs 16 devices (4x4); only 4 "
                                  "available")
        elif what == "more":
            # As jax.make_mesh: the first n_c ranks hold the workers, the
            # others hold an empty state.
            assert m["more"] == dict(shape={"data": 1, "model": 1},
                                     rank=rank, world=RANKS,
                                     holds=rank == 0,
                                     rated=(int(rank == 0), 64, 32))
        else:
            assert m["grid"] == GRID and m["rank"] == rank
            assert m["shape"] == {"data": 2, "model": 2}


def test_grid_mesh_requires_enough_ranks():
    """Outside a process group the world is one process (the counterpart
    of ``tests/test_engine.py::test_grid_mesh_requires_enough_devices``)."""
    with pytest.raises(ValueError, match=r"needs 64 devices \(8x8\); only 1"):
        mesh_lib.make_grid_mesh(rt.GridSpec(8))
    mesh = mesh_lib.make_grid_mesh(rt.GridSpec.rect(1, 1))
    assert mesh.group is None and mesh.rank == 0
    assert distributed.grid_from_mesh(mesh) == rt.GridSpec.rect(1, 1)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (4, 2)])
def test_grid_from_mesh_inverts_the_layout(shape):
    data, model = shape
    mesh = mesh_lib.make_cpu_mesh(data=data, model=model)
    assert distributed.grid_from_mesh(mesh) == rt.GridSpec.rect(model, data)
    assert mesh.size == data * model and mesh.group is None


def test_production_mesh_shapes():
    """The counterpart of ``tests/test_sharding.py::
    test_multipod_mesh_shapes``: layouts, no 512 processes."""
    m = mesh_lib.make_production_mesh()
    assert dict(m.shape) == {"data": 16, "model": 16}
    m2 = mesh_lib.make_production_mesh(multi_pod=True)
    assert dict(m2.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m2.axis_names == ("pod", "data", "model")
    assert distributed.grid_from_mesh(m) == rt.GridSpec(16)
    assert distributed.grid_from_mesh(m2) == rt.GridSpec.rect(16, 32)
    assert distributed.grid_axes(m2) == ("model", ("pod", "data"))


@pytest.mark.parametrize("algo,storage", [
    ("disgd", rt.StoragePolicy()), ("dics", rt.StoragePolicy()),
    ("dics", rt.StoragePolicy.compressed())])
def test_grid_state_specs(algo, storage):
    cfg = _stream_cfg(algo, storage=storage, grid=rt.GridSpec(16))
    specs = distributed.grid_state_specs(cfg,
                                         mesh_lib.make_production_mesh())
    assert set(specs.tables) == {("model", "data")}
    heavy = [s for s in specs[1:]]
    if algo == "dics":
        assert (heavy[-1] is None) == (storage.co == "f32")
    assert {s for s in heavy if s is not None} == {("model", "data")}
    multi = dataclasses.replace(cfg, grid=rt.GridSpec.rect(16, 32))
    specs2 = distributed.grid_state_specs(
        multi, mesh_lib.make_production_mesh(multi_pod=True))
    assert specs2.tables.clock == ("model", ("pod", "data"))


def test_init_grid_states_holds_one_worker():
    cfg = _stream_cfg("disgd", grid=rt.GridSpec.rect(1, 1))
    mesh = mesh_lib.make_grid_mesh(cfg.grid)
    states = distributed.init_grid_states(cfg, mesh)
    assert states.rated.shape == (1, 128, 32)
    with pytest.raises(ValueError, match="does not match the mesh"):
        distributed.init_grid_states(_stream_cfg("disgd"), mesh)


def test_shard_map_runs_the_reference_worker():
    """No kernel worker under shard_map: JAX places make_worker_step."""
    cfg = _stream_cfg("disgd", backend="shard_map")
    assert engine._WORKERS["scan"] == "make_worker_step"
    assert rt.core.pipeline._resolve_backend(cfg) == "shard_map"


def test_mesh_import_starts_nothing():
    """Importing the launcher and the grid starts no process group and
    leaves CUDA untouched."""
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.core.distributed\n"
            "assert not dist.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr


def _fail_before_rendezvous(info):
    raise AssertionError("unreachable: the rank has no card")


def _sleep(info):
    time.sleep(120)


def test_run_on_ranks_fails_with_a_rank():
    """A card asked for where there is none: each rank fails before the
    rendezvous, and the call fails instead of waiting for them."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="no CUDA device"):
        mesh_lib.run_on_ranks(_fail_before_rendezvous, 2, "cuda",
                              timeout=60.0)
    assert time.perf_counter() - t0 < 60.0


def test_run_on_ranks_times_out():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        mesh_lib.run_on_ranks(_sleep, 2, "cpu", timeout=4.0)
    assert time.perf_counter() - t0 < 30.0
