"""``StreamSession`` on the process grid against JAX's and the port's.

With ``backend="shard_map"`` the session runs SPMD on a
``torch.distributed`` group, one worker a rank (``session.py``,
``core/distributed.py``, ``launch/mesh.py``). Here four gloo ranks on
the CPU, started once for the module by ``launch.mesh.run_on_ranks``
(``_rank_cases``), run the lifecycle below for DISGD, DICS and BPR-MF
at ``tests/test_torch_session.py``'s sizes (``GridSpec(2)``, u_cap 256,
i_cap 64, micro-batch 256) on ``synth_stream(scaled(MOVIELENS_25M,
0.002), seed=0)`` under ``PublishPolicy(every=2, mode="sync")``:

  * ``recommend`` on a cold session, two ``ingest`` calls, ``recommend``
    twice (a miss, then a hit) on known ids plus ids no worker knows;
  * ``checkpoint``, then ``restore`` at ``GridSpec.rect(2, 1)`` (two
    workers, two ranks idle) and ``ingest``, then ``recommend``;
  * ``rescale`` of the live session to ``GridSpec.rect(1, 2)``,
    ``recommend``, ``ingest``, ``rescale`` back to ``GridSpec(2)``,
    ``recommend``.

The same lifecycle runs in this process on ``backend="scan"``
(``_lifecycle``): every rank's result equals it bit for bit (recall
bits, counters, versions, publish counts, answers, each rank's worker
against its row, the checkpoint file's bytes). JAX's ``scan`` session,
in a subprocess started before the ranks, runs the first part: the
NaN-filtered recall bits, counters, versions, publish counts, answer
ids, ``known`` and fallbacks equal it exactly, scores and each rank's
worker within 1e-5; then it restores the grid's checkpoint file with
``restore_stream_checkpoint``, which equals the grid's states bit for
bit. JAX's own ``shard_map`` stream fails on jax 0.9.0, and JAX's test
asserts that it must equal ``scan``.

Besides: the resident bytes of each rank are one worker's (none on an
idle rank), the serve stats count the ranks and the plane's collectives,
the exchanges of the logical state carry no dense table (a checkpoint's
reaches rank 0 only; a rescale's carries the live records and entries,
``regrid.Relations``), and the refusals (an async policy, a grid larger
than the group).
Without a process group the world is one process: ``shard_map`` on
``GridSpec.rect(1, 1)`` takes ``on_publish``, ``initial_states`` and
``initial_carry`` and equals ``scan``; the per-worker regrid halves
equal the whole grid's rows.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import convert, distributed, regrid, storage  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANKS = 4
GRID = rt.GridSpec(2)
RESTORE_GRID = rt.GridSpec.rect(2, 1)
RESCALE_GRID = rt.GridSpec.rect(1, 2)
CAPS = dict(u_cap=256, i_cap=64)
MICRO_BATCH = 256
EVERY = 2
ALGOS = ("disgd", "dics", "bpr")
HYPERS = {"disgd": rt.DisgdHyper, "dics": rt.DicsHyper, "bpr": rt.BprHyper}
RTOL, ATOL = 1e-5, 1e-5
# Events ingested again after the restore, and after the first rescale.
RESTORE_EVENTS, RESCALE_EVENTS = 512, 256
SPAWN_TIMEOUT = 300.0


def _stream():
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users, items


def _queries():
    """Known ids (with repeats), padding and ids no worker knows."""
    users = np.unique(_stream()[0])
    known = np.random.default_rng(9).choice(users, 40, replace=False)
    return np.concatenate([known, known[:4], [-1, 10**6, 10**6 + 7]])


def _cfg(algo, backend, grid=GRID):
    return rt.StreamConfig(algorithm=algo, grid=grid,
                           micro_batch=MICRO_BATCH,
                           hyper=HYPERS[algo](**CAPS), backend=backend,
                           device="cpu")


def _session(cfg):
    return rt.StreamSession(
        cfg, serve=rt.ServeConfig.from_stream(cfg, batch_size=64),
        publish=rt.PublishPolicy(every=EVERY, mode="sync"))


def _answer(resp):
    return dict(ids=resp.ids, scores=resp.scores, known=resp.known,
                version=resp.snapshot_version, cache_hits=resp.cache_hits,
                fallbacks=resp.fallbacks, staleness=resp.staleness_events)


def _run(res):
    return dict(bits=res.recall.bits(), processed=res.events_processed,
                dropped=res.dropped, forgets=res.forgets)


def _view(s):
    """A session's states (host copies), resident bytes and counters."""
    return dict(states=convert.states_to_numpy(s.states),
                nbytes=storage.total_nbytes(s.states),
                store=s.store.stats_snapshot(),
                serve=s.frontend.stats_snapshot(),
                events=s.events_processed, version=s.store.latest_version)


def _lifecycle(algo, backend, ck_root) -> dict:
    """The module's session lifecycle on ``backend``; on ``shard_map``
    every rank of the group runs it with the same arguments."""
    users, items = _stream()
    half = users.size // 2
    q = _queries()
    cfg = _cfg(algo, backend)
    s = _session(cfg)
    out = {"cold": _answer(s.recommend(q))}
    out["ingest"] = [_run(s.ingest(users[:half], items[:half])),
                     _run(s.ingest(users[half:], items[half:]))]
    out["miss"] = _answer(s.recommend(q))
    out["hit"] = _answer(s.recommend(q))
    out["trained"] = _view(s)
    if backend == "shard_map":
        out["exchanges"] = _exchanges(s, algo)
    path = s.checkpoint(os.path.join(ck_root, algo))
    with open(path, "rb") as f:
        out["file"] = f.read()
    rcfg = _cfg(algo, backend, RESTORE_GRID)
    t = rt.StreamSession.restore(
        os.path.join(ck_root, algo), rcfg,
        serve=rt.ServeConfig.from_stream(rcfg, batch_size=64),
        publish=rt.PublishPolicy(every=EVERY, mode="sync"))
    out["restored"] = _view(t)
    out["restored_ingest"] = _run(t.ingest(users[:RESTORE_EVENTS],
                                           items[:RESTORE_EVENTS]))
    out["restored_answer"] = _answer(t.recommend(q))
    out["restored_after"] = _view(t)
    s.rescale(RESCALE_GRID)
    out["rescaled"] = _view(s)
    out["rescaled_answer"] = _answer(s.recommend(q))
    out["rescaled_ingest"] = _run(s.ingest(users[:RESCALE_EVENTS],
                                           items[:RESCALE_EVENTS]))
    s.rescale(GRID)
    out["back"] = _view(s)
    out["back_answer"] = _answer(s.recommend(q))
    return out


def _host(tup):
    return type(tup)(*(t.numpy() for t in tup))


def _exchanges(s, algo) -> dict:
    """The process grid's two exchanges of the logical state on ``s``'s
    trained worker: what each gives this rank, its collectives and the
    bytes they wrote here."""
    mesh = mesh_lib.make_grid_mesh(GRID)
    distributed.reset_collective_stats()
    got = distributed.gather_logical(mesh, s.states, GRID, algo)
    out = {"gather": (None if got is None else (_host(got[0]), got[1]),
                      distributed.collective_stats())}
    distributed.reset_collective_stats()
    logical, rel = distributed.exchange_logical(mesh, s.states, GRID, algo)
    out["exchange"] = (_host(logical), _host(rel),
                       distributed.collective_stats())
    return out


def _refusals() -> dict:
    """What a rank of the group is refused, by message."""
    out = {}
    for name, make in (
            ("async", lambda: rt.StreamSession(
                _cfg("disgd", "shard_map"),
                publish=rt.PublishPolicy(every=2, mode="async"))),
            ("larger", lambda: rt.StreamSession(
                _cfg("disgd", "shard_map", rt.GridSpec(4))))):
        try:
            make()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_cases(info, ck_root) -> dict:
    """Everything the module asks of one rank of the group."""
    out = {algo: _lifecycle(algo, "shard_map", ck_root) for algo in ALGOS}
    out["refusals"] = _refusals()
    out["info"] = info
    return out


_JAX = """
    import os, sys, time
    import jax, numpy as np
    import repro
    from repro.algos.bpr import BprHyper
    from repro.checkpoint import latest_step
    from repro.core.dics import DicsHyper
    from repro.core.disgd import DisgdHyper
    from repro.core.pipeline import StreamConfig, restore_stream_checkpoint
    from repro.core.routing import GridSpec
    from repro_torch.core import convert

    inp = np.load(sys.argv[1])
    ck_root, deadline = sys.argv[3], time.time() + float(sys.argv[4])
    users, items, q = inp["users"], inp["items"], inp["queries"]
    half = users.size // 2
    hypers = {"disgd": DisgdHyper, "dics": DicsHyper, "bpr": BprHyper}
    out = {}

    def states(prefix, st):
        for name, leaf in convert.flatten_state(
                jax.tree.map(np.asarray, st)).items():
            out[f"{prefix}/{name}"] = leaf

    def answer(prefix, r):
        out[f"{prefix}/ids"] = r.ids
        out[f"{prefix}/scores"] = r.scores
        out[f"{prefix}/known"] = np.asarray(r.known)
        out[f"{prefix}/counts"] = np.asarray(
            [r.snapshot_version, r.cache_hits, r.fallbacks])

    cfgs = {}
    for algo, hyper in hypers.items():
        cfg = StreamConfig(algorithm=algo, grid=GridSpec(2), micro_batch=256,
                           hyper=hyper(u_cap=256, i_cap=64), backend="scan")
        cfgs[algo] = cfg
        s = repro.StreamSession(
            cfg, serve=repro.ServeConfig.from_stream(cfg, batch_size=64),
            publish=repro.PublishPolicy(every=2, mode="sync"))
        answer(f"{algo}/cold", s.recommend(q))
        for j, (lo, hi) in enumerate(((0, half), (half, users.size))):
            r = s.ingest(users[lo:hi], items[lo:hi])
            out[f"{algo}/ingest{j}/bits"] = r.recall.bits()
            out[f"{algo}/ingest{j}/counts"] = np.asarray(
                [r.events_processed, r.dropped])
        answer(f"{algo}/miss", s.recommend(q))
        answer(f"{algo}/hit", s.recommend(q))
        st = s.store.stats_snapshot()
        out[f"{algo}/store"] = np.asarray(
            [st["sync_rotations"], st["rotations"], s.store.latest_version,
             s.events_processed])
        states(f"{algo}/trained", s.states)
    # The grid's checkpoint files, written by rank 0 of the port's group.
    for algo, cfg in cfgs.items():
        d = os.path.join(ck_root, algo)
        while latest_step(d) is None:
            if time.time() > deadline:
                raise SystemExit(f"no checkpoint in {d}")
            time.sleep(0.2)
        ck = restore_stream_checkpoint(d, cfg)
        out[f"{algo}/restored/events"] = np.asarray(ck.events_processed)
        states(f"{algo}/restored", ck.states)
    np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The module's runs: the ranks (one spawn), JAX's scan sessions in a
    subprocess started before them (it then reads the grid's checkpoint
    files), and the port's scan sessions here while the ranks work."""
    tmp = tmp_path_factory.mktemp("grid_session")
    users, items = _stream()
    np.savez(tmp / "in.npz", users=users, items=items, queries=_queries())
    grid_ck, scan_ck = str(tmp / "grid_ck"), str(tmp / "scan_ck")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), str(tmp / "in.npz"),
         str(tmp / "out.npz"), grid_ck, str(SPAWN_TIMEOUT)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    # The port's scan sessions on a thread of this process, beside the
    # ranks, on a share of the cores.
    scan, threads = {}, torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (RANKS + 2)))
    worker = threading.Thread(target=lambda: scan.update(
        {algo: _lifecycle(algo, "scan", scan_ck) for algo in ALGOS}))
    worker.start()
    try:
        ranks = mesh_lib.run_on_ranks(_rank_cases, RANKS, "cpu", grid_ck,
                                      timeout=SPAWN_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        worker.join(SPAWN_TIMEOUT)
        log, _ = jax_proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        jax_proc.kill()
        torch.set_num_threads(threads)
    assert jax_proc.returncode == 0, log
    assert set(scan) == set(ALGOS), "the scan sessions did not finish"
    print(f"{RANKS} ranks {t_ranks:.1f} s, "
          f"all {time.perf_counter() - t0:.1f} s")
    return dict(ranks=ranks.results, scan=scan,
                jax=dict(np.load(tmp / "out.npz")))


def _nan_free(bits):
    return bits[~np.isnan(bits)]


def _rows(states, rank, n_c):
    """Rank ``rank``'s row of a whole grid's host states (none past the
    grid)."""
    return {k: v[rank:rank + 1] if rank < n_c else v[:0]
            for k, v in states.items()}


def _assert_answers_equal(got, want, what):
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=f"{what}.{key}")


def _assert_views_equal(got, want, rank, n_c, what):
    rows = _rows(want["states"], rank, n_c)
    assert set(got["states"]) == set(rows), what
    for name, w in rows.items():
        np.testing.assert_array_equal(got["states"][name], w,
                                      err_msg=f"{what}.{name}")
    for key in ("store", "events", "version"):
        assert got[key] == want[key], f"{what}.{key}"
    serve = dict(got["serve"])
    assert serve.pop("ranks") == RANKS
    assert serve.pop("collectives") == serve["plane_batches"]
    assert serve == want["serve"], what


STAGES = ("trained", "restored", "restored_after", "rescaled", "back")
ANSWERS = ("cold", "miss", "hit", "restored_answer", "rescaled_answer",
           "back_answer")
STAGE_GRID = {"trained": GRID, "restored": RESTORE_GRID,
              "restored_after": RESTORE_GRID, "rescaled": RESCALE_GRID,
              "back": GRID}


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_session_equals_scan_session(runs, algo):
    """Every rank, every step: bit for bit the port's one-process scan
    session (recall bits, counters, answers, each rank's worker)."""
    want = runs["scan"][algo]
    for rank, out in enumerate(runs["ranks"]):
        got = out[algo]
        for key in ("ingest", "restored_ingest", "rescaled_ingest"):
            runs_got = got[key] if key == "ingest" else [got[key]]
            runs_want = want[key] if key == "ingest" else [want[key]]
            for a, b in zip(runs_got, runs_want):
                np.testing.assert_array_equal(a["bits"], b["bits"])
                assert {k: a[k] for k in ("processed", "dropped",
                                          "forgets")} == {
                    k: b[k] for k in ("processed", "dropped", "forgets")}
        for key in ANSWERS:
            _assert_answers_equal(got[key], want[key], f"rank {rank} {key}")
        for key in STAGES:
            _assert_views_equal(got[key], want[key], rank,
                                STAGE_GRID[key].n_c, f"rank {rank} {key}")


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_session_matches_jax_scan_session(runs, algo):
    jx = runs["jax"]
    for rank, out in enumerate(runs["ranks"]):
        got = out[algo]
        for j, run in enumerate(got["ingest"]):
            np.testing.assert_array_equal(
                _nan_free(run["bits"]), _nan_free(jx[f"{algo}/ingest{j}/bits"]))
            np.testing.assert_array_equal(
                [run["processed"], run["dropped"]],
                jx[f"{algo}/ingest{j}/counts"])
        for key in ("cold", "miss", "hit"):
            a = got[key]
            np.testing.assert_array_equal(a["ids"], jx[f"{algo}/{key}/ids"])
            np.testing.assert_array_equal(a["known"],
                                          jx[f"{algo}/{key}/known"])
            np.testing.assert_array_equal(
                [a["version"], a["cache_hits"], a["fallbacks"]],
                jx[f"{algo}/{key}/counts"])
            want = jx[f"{algo}/{key}/scores"]
            np.testing.assert_array_equal(np.isneginf(a["scores"]),
                                          np.isneginf(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(a["scores"][fin], want[fin],
                                       rtol=RTOL, atol=ATOL)
        view = got["trained"]
        np.testing.assert_array_equal(
            [view["store"]["sync_rotations"], view["store"]["rotations"],
             view["version"], view["events"]], jx[f"{algo}/store"])
        prefix = f"{algo}/trained/"
        for name, w in ((k[len(prefix):], v) for k, v in jx.items()
                        if k.startswith(prefix)):
            g = view["states"][name]
            assert g.shape == (1,) + w.shape[1:], name
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g[0], w[rank], rtol=RTOL,
                                           atol=ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(g[0], w[rank], err_msg=name)
    # Publishing ran: two boundaries a call at least.
    assert jx[f"{algo}/store"][0] > 4


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_checkpoint_file_is_scan_file(runs, algo):
    """Rank 0 writes one file, the bytes a one-process session writes at
    the same point; JAX's ``restore_stream_checkpoint`` reads it back to
    the grid's states, bit for bit."""
    want = runs["scan"][algo]["file"]
    for out in runs["ranks"]:
        assert out[algo]["file"] == want
    jx = runs["jax"]
    trained = runs["scan"][algo]["trained"]
    assert int(jx[f"{algo}/restored/events"]) == trained["events"]
    prefix = f"{algo}/restored/"
    names = {k[len(prefix):] for k in jx if k.startswith(prefix)} - {"events"}
    assert names == set(trained["states"])
    for name in names:
        np.testing.assert_array_equal(jx[prefix + name],
                                      trained["states"][name], err_msg=name)


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_ranks_hold_one_worker(runs, algo):
    """Resident bytes: one worker's a rank at every grid, none on a rank
    past the grid (``GridSpec.rect(2, 1)`` and ``rect(1, 2)`` leave two
    ranks idle)."""
    want = runs["scan"][algo]
    for rank, out in enumerate(runs["ranks"]):
        for key in STAGES:
            n_c = STAGE_GRID[key].n_c
            one = want[key]["nbytes"] // n_c
            assert one > 0
            assert out[algo][key]["nbytes"] == (one if rank < n_c else 0), (
                rank, key)


def _worker(st, w):
    return type(st)(type(st.tables)(*(t[w:w + 1] for t in st.tables)),
                    *(None if t is None else t[w:w + 1] for t in st[1:]))


def _live_words(st, w) -> int:
    """The int32 words worker ``w`` of ``st`` sends in a rescale: its
    live records, its clock and its live relation entries."""
    one = regrid.extract_logical(_worker(st, w), GRID,
                                 workers=range(w, w + 1))
    rel = regrid.relations_of(one, GRID, workers=range(w, w + 1))
    n_u, n_i = int((one.u_id >= 0).sum()), int((one.i_id >= 0).sum())
    return (n_u * (4 + one.u_vec.shape[1]) + n_i * (5 + one.i_vec.shape[1])
            + 1 + sum(t.numel() for t in rel))


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_exchanges_carry_no_dense_table(runs, algo):
    """A checkpoint's gather reaches rank 0 only (the others receive no
    byte), and equals the whole grid's logical state there, ``rated``
    packed. A rescale's exchange gives every rank the whole grid's live
    records and the live entries of ``rated`` and ``co``
    (``regrid.Relations``), equal to the one-process grid's, in two
    collectives whose bytes are bounded by those live entries: no dense
    table travels."""
    st = convert.states_from_numpy(runs["scan"][algo]["trained"]["states"],
                                   "cpu")
    whole = regrid.extract_logical(st, GRID)
    rel = regrid.relations_of(whole, GRID)
    live = {"u": whole.u_id >= 0, "i": whole.i_id >= 0}
    for rank, out in enumerate(runs["ranks"]):
        ex = out[algo]["exchanges"]
        gathered, stats = ex["gather"]
        assert stats["calls"] == 1
        if rank:
            assert gathered is None and stats["bytes"] == 0
        else:
            logical, n_bits = gathered
            for name, w in zip(whole._fields, whole):
                g = torch.from_numpy(logical._asdict()[name])
                if name == "rated":
                    g = storage.unpack_bits(g, n_bits)
                assert torch.equal(g, w.reshape(g.shape)), name
        logical, relations, stats = ex["exchange"]
        assert stats["calls"] == 2
        words = 0
        for name, w in zip(whole._fields, whole):
            g = torch.from_numpy(logical._asdict()[name])
            if name in ("rated", "co"):
                assert g.shape[0] == 0, name
                continue
            if name[:2] in ("u_", "i_"):
                w = w[live[name[0]]]
            assert torch.equal(g, w.reshape(g.shape)), name
            words += g.numel()
        for name, w in zip(rel._fields, rel):
            g = torch.from_numpy(relations._asdict()[name])
            assert torch.equal(g, w), name
            words += g.numel()
        assert rel.pu.numel() > 0
        # The lengths, then every rank's words padded to the longest.
        n_parts = len(whole._fields) - 2 + len(rel._fields)
        assert stats["bytes"] == 4 * RANKS * (
            n_parts + max(_live_words(st, w) for w in range(GRID.n_c)))
        assert sum(_live_words(st, w) for w in range(GRID.n_c)) == words


@pytest.mark.parametrize("what", ["async", "larger"])
def test_grid_session_refusals(runs, what):
    for out in runs["ranks"]:
        msg = out["refusals"][what]
        if what == "async":
            assert "item 14c" in msg
        else:
            assert msg == ("S&R grid needs 16 devices (4x4); only 4 "
                           "available")


def test_grid_session_ranks(runs):
    assert [out["info"].rank for out in runs["ranks"]] == list(range(RANKS))
    assert {out["info"].backend for out in runs["ranks"]} == {"gloo"}


# -- a world of one process -------------------------------------------------


def _world_of_one(algo, backend):
    # One worker's bucket holds a whole micro-batch: capacity factor 1.
    return dataclasses.replace(_cfg(algo, backend, rt.GridSpec.rect(1, 1)),
                               capacity_factor=1.0)


@pytest.mark.parametrize("kw", ["on_publish", "initial_states",
                                "initial_carry"])
def test_shard_map_takes_session_options(kw):
    """``shard_map`` in a world of one process takes what the session
    passes it, and equals ``scan`` given the same."""
    users, items = _stream()
    users, items = users[:512], items[:512]
    got = {}
    for backend in ("scan", "shard_map"):
        cfg = _world_of_one("disgd", backend)
        events = []
        arg = {"on_publish": dict(on_publish=events.append,
                                  publish_every=1),
               "initial_states": dict(
                   initial_states=rt.run_stream(
                       users[:256], items[:256],
                       dataclasses.replace(cfg, backend="scan"))
                   .final_states),
               "initial_carry": dict(initial_carry=(users[:40],
                                                    items[:40]))}[kw]
        res = rt.run_stream(users, items, cfg, **arg)
        got[backend] = (res, [(e.segment, e.steps_done, e.events_processed,
                               convert.states_to_numpy(e.states))
                              for e in events])
    (a, ea), (b, eb) = got["scan"], got["shard_map"]
    np.testing.assert_array_equal(a.recall.bits(), b.recall.bits())
    assert (a.events_processed, a.dropped) == (b.events_processed, b.dropped)
    sa, sb = (convert.states_to_numpy(r.final_states) for r in (a, b))
    for name in sa:
        np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)
    assert len(ea) == len(eb)
    for x, y in zip(ea, eb):
        assert x[:3] == y[:3]
        for name in x[3]:
            np.testing.assert_array_equal(x[3][name], y[3][name])
    if kw == "on_publish":
        assert len(eb) > 2


def test_shard_map_refuses_async_publishing():
    users, items = _stream()
    cfg = _world_of_one("disgd", "shard_map")
    with pytest.raises(ValueError, match="item 14c"):
        rt.run_stream(users[:300], items[:300], cfg,
                      on_publish=lambda ev: None, publish_every=1,
                      publish_sync=False)
    with pytest.raises(ValueError, match="item 14c"):
        rt.StreamSession(cfg, publish=rt.PublishPolicy(every=1,
                                                       mode="async"))
    # End-only publishing is synchronous: the async mode's default is fine.
    s = rt.StreamSession(cfg, publish=rt.PublishPolicy())
    s.ingest(users[:300], items[:300])
    with pytest.raises(ValueError, match="item 14c"):
        s.store.publish_async(s.states, 0)


# The regrid check's caps: a 4-worker `rated` under PyTorch's parallel
# grain (32,768 elements), so its operations stay on one thread when the
# suite's workers share the cores.
REGRID_CAPS = dict(u_cap=128, i_cap=32)


@pytest.mark.parametrize("algo", ALGOS)
def test_per_worker_regrid_equals_whole_grid_rows(algo):
    """``extract_logical(workers=)`` joined worker-major is the whole
    grid's, and ``build_states(workers=)`` is the whole build's rows, at
    every destination (and empty past it), under two storage policies."""
    users, items = _stream()
    for policy in (rt.StoragePolicy(), rt.StoragePolicy.compressed()):
        cfg = dataclasses.replace(_cfg(algo, "scan"), storage=policy,
                                  hyper=HYPERS[algo](**REGRID_CAPS))
        st = rt.run_stream(users[:800], items[:800], cfg).final_states
        whole = regrid.extract_logical(st, GRID, storage=policy)
        parts = []
        for w in range(GRID.n_c):
            one = _worker(st, w)
            parts.append(regrid.extract_logical(one, GRID, storage=policy,
                                                workers=range(w, w + 1)))
        for name, leaf in zip(whole._fields, whole):
            joined = torch.cat([getattr(p, name) for p in parts])
            assert torch.equal(leaf, joined.reshape(leaf.shape)), name
        for dst in (RESTORE_GRID, RESCALE_GRID, rt.GridSpec.rect(4, 2)):
            kw = dict(src=GRID, dst=dst, storage=policy, **REGRID_CAPS)
            full = convert.states_to_numpy(regrid.build_states(whole, **kw))
            for w in range(dst.n_c + 1):
                rows = convert.states_to_numpy(regrid.build_states(
                    whole, workers=range(w, min(w + 1, dst.n_c)), **kw))
                for name, leaf in full.items():
                    np.testing.assert_array_equal(
                        rows[name], leaf[w:w + 1], err_msg=f"{dst} {w} {name}")
