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

Under ``PublishPolicy(every=2, mode="async")`` (``_async_lifecycle``:
two ``ingest`` calls, a miss and a hit, ``checkpoint``, ``rescale`` to
``RESCALE_GRID`` and ``recommend``) every rank equals the port's
``scan`` session under the same policy bit for bit (the grid never
coalesces: its versions are ``scan``'s plus what ``scan`` coalesced)
and JAX's sync ``scan`` session as above. Then, in the same spawn:

  * a reader thread a rank calls ``recommend`` on a seeded schedule
    while ``ingest`` runs, under an async and a sync policy: no rank
    hangs, every call's answer is the same on every rank and equals the
    ``scan`` session's at the agreed snapshot (a replay that answers
    each served boundary as it passes it); the trainer's collectives are
    one a step and one a boundary, the reader's one all-gather a plane
    call and one all-reduce an agreement;
  * ``run_service`` interleaved (async) equals the port's ``scan`` run
    (answers, staleness, publish totals, states) and JAX's (sync);
    threaded, every rank issues the same number of query batches and
    its worker equals a query-free twin's row;
  * the ``Autoscaler`` on an undersized grid (async) takes ``scan``'s
    decisions, drops what ``scan`` drops and ends on ``scan``'s states,
    and JAX's;
  * an ``EnsembleSession`` of DICS and DISGD (async) takes ``scan``'s
    weights and answers, and JAX's;
  * a subscriber that raises on the publisher thread makes ``ingest``
    raise on every rank instead of hanging.

Besides: the resident bytes of each rank are one worker's (none on an
idle rank), the serve stats count the ranks, the plane's collectives
and the agreements, the exchanges of the logical state carry no dense
table (a checkpoint's reaches rank 0 only; a rescale's carries the live
records and entries, ``regrid.Relations``), and the refusal of a grid
larger than the group.
Without a process group the world is one process: ``shard_map`` on
``GridSpec.rect(1, 1)`` takes ``on_publish``, ``initial_states`` and
``initial_carry`` and equals ``scan``; it publishes asynchronously (0-d
tensor scalars) as ``scan`` does; the per-worker regrid halves equal the
whole grid's rows.
"""

import dataclasses
import json
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
from repro_torch.serve.loadgen import LoadConfig  # noqa: E402
from repro_torch.serve.service import ServiceConfig, run_service  # noqa: E402

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
# The reader case: a warm ingest, then the reader's calls (seeded pauses
# and query subsets) during the next ingest, publishing every step.
READER_WARM, READER_EVENTS, READER_EVERY, READER_CALLS = 256, 1024, 1, 8
MODES = ("async", "sync")
# The service runs: the stream's first events, JAX's test's shapes.
SERVICE_EVENTS = 1024
SERVICE_LOAD = dict(seed=5, query_batch=8)
SERVICE_INTERLEAVED = dict(mode="interleaved", events_per_chunk=512,
                           query_batches=6)
THREADED_WARM, THREADED_BATCHES = 256, 4
# The autoscaler: tests/test_torch_autoscaler.py's undersized grid, grown
# within the group's four ranks.
AUTOSCALE_ROUNDS, AUTOSCALE_MAX = 4, 4
# The ensemble: two segments of the stream.
ENSEMBLE_MEMBERS, ENSEMBLE_SEGMENT = ("dics", "disgd"), 256
# A failing subscriber: the async rotations after which it raises (the
# second, and the last of the reader case's stream).
FAILS = ("second", "last")


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


def _session(cfg, mode="sync", every=EVERY):
    return rt.StreamSession(
        cfg, serve=rt.ServeConfig.from_stream(cfg, batch_size=64),
        publish=rt.PublishPolicy(every=every, mode=mode))


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


def _async_lifecycle(algo, backend, ck_root) -> dict:
    """Two ``ingest`` calls under an async policy, a miss and a hit,
    ``checkpoint``, ``rescale`` to ``RESCALE_GRID`` and ``recommend``."""
    users, items = _stream()
    half = users.size // 2
    q = _queries()
    s = _session(_cfg(algo, backend), "async")
    out = {"ingest": [_run(s.ingest(users[:half], items[:half])),
                      _run(s.ingest(users[half:], items[half:]))]}
    out["miss"] = _answer(s.recommend(q))
    out["hit"] = _answer(s.recommend(q))
    out["trained"] = _view(s)
    path = s.checkpoint(os.path.join(ck_root, "async", algo))
    with open(path, "rb") as f:
        out["file"] = f.read()
    s.rescale(RESCALE_GRID)
    out["rescaled"] = _view(s)
    out["rescaled_answer"] = _answer(s.recommend(q))
    return out


def _reader_plan():
    """The reader's calls: a pause (s) and a subset of the queries each."""
    rng = np.random.default_rng(11)
    q = _queries()
    return [(float(rng.uniform(0, 0.02)),
             q[np.sort(rng.choice(q.size, 16, replace=False))])
            for _ in range(READER_CALLS)]


def _reader_case(mode) -> dict:
    """A grid session publishing every step under ``mode``: a warm
    ``ingest``, then a reader thread calls ``recommend`` on
    ``_reader_plan`` while the next ``ingest`` runs. Returns each call's
    answer and agreement, and the two groups' collectives in the
    second ``ingest``."""
    users, items = _stream()
    users, items = users[:READER_EVENTS], items[:READER_EVENTS]
    s = _session(_cfg("disgd", "shard_map"), mode, READER_EVERY)
    s.ingest(users[:READER_WARM], items[:READER_WARM])
    calls, errors = [], []

    def reader():
        try:
            for pause, q in _reader_plan():
                time.sleep(pause)
                calls.append((_answer(s.recommend(q)),
                              s.store.last_agreement))
        except BaseException as e:      # reported by the test
            errors.append(repr(e))

    distributed.reset_collective_stats()
    t = threading.Thread(target=reader)
    t.start()
    res = s.ingest(users[READER_WARM:], items[READER_WARM:])
    train = distributed.collective_stats("train")
    t.join(SPAWN_TIMEOUT)
    return dict(calls=calls, errors=errors, alive=t.is_alive(),
                train=train, serve=distributed.collective_stats("serve"),
                frontend=s.frontend.stats_snapshot(),
                store=s.store.stats_snapshot(),
                events=res.events_processed)


def _capture(session) -> list:
    """Record every ``recommend`` answer of ``session`` (``run_service``
    calls it)."""
    answers, call = [], session.recommend

    def recommend(user_ids, n=None):
        resp = call(user_ids, n)
        answers.append(_answer(resp))
        return resp
    session.recommend = recommend
    return answers


def _load(users):
    return LoadConfig(n_users=int(users.max()) + 1, **SERVICE_LOAD)


def _service_cases(backend) -> dict:
    """``run_service`` interleaved and threaded (DISGD, async) on the
    stream's first ``SERVICE_EVENTS`` events."""
    users, items = _stream()
    users, items = users[:SERVICE_EVENTS], items[:SERVICE_EVENTS]
    cfg = _cfg("disgd", backend)
    s = _session(cfg, "async")
    answers = _capture(s)
    rep = run_service(s, users, items, _load(users),
                         ServiceConfig(**SERVICE_INTERLEAVED))
    out = {"interleaved": dict(
        answers=answers, store=s.store.stats_snapshot(),
        records=[(r.staleness_events, r.snapshot_forgets, r.cache_hits,
                  r.fallbacks) for r in rep.records],
        states=convert.states_to_numpy(s.states))}
    s = _session(cfg, "async")
    s.ingest(users[:THREADED_WARM], items[:THREADED_WARM])
    s.recommend(_queries()[:8])
    rep = run_service(
        s, users[THREADED_WARM:], items[THREADED_WARM:],
        dataclasses.replace(_load(users), arrival="closed", seed=6),
        ServiceConfig(mode="threaded", query_batches=THREADED_BATCHES))
    out["threaded"] = dict(
        versions=[r.snapshot_version for r in rep.records],
        under_load=[r.under_load for r in rep.records],
        events=s.events_processed, store=s.store.stats_snapshot(),
        states=convert.states_to_numpy(s.states))
    return out


def _autoscale_case(backend) -> dict:
    """``tests/test_torch_autoscaler.py``'s undersized one-worker grid
    under an async policy, an ``Autoscaler`` step after each ingest."""
    rng = np.random.default_rng(7)
    s = rt.StreamSession(
        rt.StreamConfig(grid=rt.GridSpec.rect(1, 1), micro_batch=64,
                        capacity_factor=0.25, carry_slots=8,
                        hyper=rt.DisgdHyper(**CAPS), backend=backend,
                        device="cpu"),
        publish=rt.PublishPolicy(every=2, mode="async"))
    scaler = rt.Autoscaler(s, rt.AutoscalePolicy(max_workers=AUTOSCALE_MAX,
                                                 cooldown=0))
    actions, dropped, answers = [], 0, []
    for _ in range(AUTOSCALE_ROUNDS):
        u = rng.integers(0, 400, 512).astype(np.int32)
        i = rng.integers(0, 160, 512).astype(np.int32)
        dropped += s.ingest(u, i).dropped
        answers.append(_answer(s.recommend(u[:8])))
        actions.append(scaler.step())
    fam = s.metrics.get("autoscaler_decisions_total")
    return dict(actions=actions, dropped=dropped, answers=answers,
                grid=s.grid.shape, store=s.store.stats_snapshot(),
                trail={lab["action"]: c.value for lab, c in fam.series()},
                states=convert.states_to_numpy(s.states))


def _ensemble_case(backend) -> dict:
    """A DICS + DISGD ``EnsembleSession`` (async) over two segments, then
    a blended ``recommend``."""
    users, items = _stream()
    e = rt.EnsembleSession([_cfg(a, backend) for a in ENSEMBLE_MEMBERS],
                           publish=rt.PublishPolicy(every=2, mode="async"))
    weights = []
    for j in range(2):
        lo, hi = j * ENSEMBLE_SEGMENT, (j + 1) * ENSEMBLE_SEGMENT
        weights.append(e.ingest(users[lo:hi], items[lo:hi]).weights)
    return dict(weights=weights, answer=_answer(e.recommend(_queries())),
                resets=e.exploration_resets,
                states={name: convert.states_to_numpy(m.states)
                        for name, m in e.members.items()})


def _steps(n) -> int:
    """The engine's steps for ``n`` events: the stream's and the drain
    tail's."""
    cfg = _cfg("disgd", "shard_map")
    return -(-n // MICRO_BATCH) + -(-MICRO_BATCH // cfg.bucket_capacity)


def _failing_subscriber_case(at) -> dict:
    """A grid session publishing every step asynchronously on the reader
    case's stream, with a subscriber that raises after the ``at``-th
    rotation (``FAILS``): what ``ingest`` raised, and the rotations."""
    users, items = _stream()
    n = {"second": 2, "last": _steps(READER_EVENTS)}[at]
    s = _session(_cfg("disgd", "shard_map"), "async", 1)
    rotations = []

    def listener(snap):
        rotations.append(snap.version)
        if len(rotations) == n:
            raise ValueError("the subscriber failed")

    s.store.subscribe(listener)
    try:
        s.ingest(users[:READER_EVENTS], items[:READER_EVENTS])
        raised = None
    except RuntimeError as e:
        raised = (str(e), repr(e.__cause__))
    return dict(raised=raised, rotations=len(rotations), n=n)


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
            ("larger", lambda: rt.StreamSession(
                _cfg("disgd", "shard_map", rt.GridSpec(4)))),):
        try:
            make()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_cases(info, ck_root) -> dict:
    """Everything the module asks of one rank of the group (one intra-op
    thread a rank: the tables are below PyTorch's parallel grain, and
    idle pool threads would only spin on cores the suite shares)."""
    torch.set_num_threads(1)
    out = {algo: _lifecycle(algo, "shard_map", ck_root) for algo in ALGOS}
    out["async"] = {algo: _async_lifecycle(algo, "shard_map", ck_root)
                    for algo in ALGOS}
    out["readers"] = {mode: _reader_case(mode) for mode in MODES}
    out["service"] = _service_cases("shard_map")
    out["autoscale"] = _autoscale_case("shard_map")
    out["ensemble"] = _ensemble_case("shard_map")
    out["failing"] = {at: _failing_subscriber_case(at) for at in FAILS}
    out["refusals"] = _refusals()
    out["info"] = info
    return out


def _scan_cases(ck_root) -> dict:
    """The ranks' cases on ``backend="scan"`` in this process."""
    out = {algo: _lifecycle(algo, "scan", ck_root) for algo in ALGOS}
    out["async"] = {algo: _async_lifecycle(algo, "scan", ck_root)
                    for algo in ALGOS}
    out["service"] = _service_cases("scan")
    out["autoscale"] = _autoscale_case("scan")
    out["ensemble"] = _ensemble_case("scan")
    return out


_JAX = """
    import json, os, sys, time
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
    # The interleaved service run (tests/test_service.py's shape).
    from repro.serve.loadgen import LoadConfig
    from repro.serve.service import ServiceConfig, run_service

    su, si = users[:int(sys.argv[5])], items[:int(sys.argv[5])]
    cfg = cfgs["disgd"]
    s = repro.StreamSession(
        cfg, serve=repro.ServeConfig.from_stream(cfg, batch_size=64),
        publish=repro.PublishPolicy(every=2, mode="sync"))
    got, call = [], s.recommend
    s.recommend = lambda ids, n=None: got.append(call(ids, n)) or got[-1]
    rep = run_service(s, su, si,
                      LoadConfig(n_users=int(su.max()) + 1, seed=5,
                                 query_batch=8),
                      ServiceConfig(mode="interleaved", events_per_chunk=512,
                                    query_batches=6))
    for j, r in enumerate(got):
        answer(f"service/{j}", r)
    out["service/records"] = np.asarray(
        [[r.staleness_events, r.snapshot_forgets, r.cache_hits, r.fallbacks]
         for r in rep.records])
    states("service/states", s.states)
    # The autoscaler's rounds and the ensemble (async, as on the grid).
    def policy():
        return repro.PublishPolicy(every=2, mode="async")

    rng = np.random.default_rng(7)
    s = repro.StreamSession(
        StreamConfig(grid=GridSpec.rect(1, 1), micro_batch=64,
                     capacity_factor=0.25, carry_slots=8,
                     hyper=DisgdHyper(u_cap=256, i_cap=64), backend="scan"),
        publish=policy())
    scaler = repro.Autoscaler(s, repro.AutoscalePolicy(
        max_workers=int(sys.argv[7]), cooldown=0))
    actions, dropped = [], 0
    for j in range(int(sys.argv[6])):
        u = rng.integers(0, 400, 512).astype(np.int32)
        i = rng.integers(0, 160, 512).astype(np.int32)
        dropped += s.ingest(u, i).dropped
        answer(f"autoscale/{j}", s.recommend(u[:8]))
        actions.append(scaler.step())
    fam = s.metrics.get("autoscaler_decisions_total")
    out["autoscale/actions"] = np.asarray(actions)
    out["autoscale/counts"] = np.asarray([dropped, *s.grid.shape])
    out["autoscale/trail"] = np.asarray(json.dumps(
        {lab["action"]: c.value for lab, c in fam.series()}))
    states("autoscale/states", s.states)
    e = repro.EnsembleSession([cfgs[a] for a in ("dics", "disgd")],
                              publish=policy())
    seg = int(sys.argv[8])
    for j in range(2):
        r = e.ingest(users[j * seg:(j + 1) * seg], items[j * seg:(j + 1) * seg])
        for name, w in r.weights.items():
            out[f"ensemble/{j}/{name}"] = np.asarray(w)
    answer("ensemble/answer", e.recommend(q))
    out["ensemble/resets"] = np.asarray(e.exploration_resets)
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
         str(tmp / "out.npz"), grid_ck, str(SPAWN_TIMEOUT),
         str(SERVICE_EVENTS), str(AUTOSCALE_ROUNDS), str(AUTOSCALE_MAX),
         str(ENSEMBLE_SEGMENT)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    # The port's scan sessions on a thread of this process, beside the
    # ranks, on a share of the cores.
    scan, threads = {}, torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (RANKS + 2)))
    worker = threading.Thread(target=lambda: scan.update(
        _scan_cases(scan_ck)))
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
    assert "ensemble" in scan, "the scan sessions did not finish"
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
    # No agreement: every call runs on the ingest thread between ingests,
    # in program order.
    assert serve.pop("agreements") == 0
    assert serve == want["serve"], what


def _published(view):
    """A view's publish counters and version as if nothing coalesced
    (the grid never coalesces; ``scan`` may, by timing)."""
    st = dict(view["store"])
    c = st.pop("coalesced")
    return (dict(st, async_rotations=st["async_rotations"] + c,
                 rotations=st["rotations"] + c), view["version"] + c)


def _assert_async_views_equal(got, want, rank, n_c, what):
    assert got["store"]["coalesced"] == 0, what
    assert _published(got) == _published(want), what
    _assert_views_equal(dict(got, store=want["store"],
                             version=want["version"]),
                        want, rank, n_c, what)


def _same_answer(a, b) -> dict:
    """``a`` without the snapshot version, and ``b`` likewise: under an
    async policy ``scan``'s versions count its coalesced publishes."""
    return ({k: v for k, v in a.items() if k != "version"},
            {k: v for k, v in b.items() if k != "version"})


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


@pytest.mark.parametrize("what", ["larger"])
def test_grid_session_refusals(runs, what):
    for out in runs["ranks"]:
        assert out["refusals"][what] == ("S&R grid needs 16 devices (4x4); "
                                         "only 4 available")


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


def test_shard_map_publishes_async_in_a_world_of_one():
    """``run_stream(backend="shard_map", publish_sync=False)`` hands over
    0-d tensor scalars and equals ``scan``'s events; a session under an
    async policy and ``SnapshotStore.publish_async`` run and equal
    ``scan``'s (nothing coalesced on the grid)."""
    users, items = _stream()
    users, items = users[:512], items[:512]
    q = _queries()
    got = {}
    for backend in ("scan", "shard_map"):
        cfg = _world_of_one("disgd", backend)
        events = []
        res = rt.run_stream(users, items, cfg, on_publish=events.append,
                            publish_every=1, publish_sync=False)
        for e in events:
            for x in (e.events_processed, e.dropped, e.forgets):
                assert torch.is_tensor(x) and x.dim() == 0
        s = _session(cfg, "async", 1)
        s.ingest(users, items)
        answer = _answer(s.recommend(q))
        s.store.publish_async(s.states, s.events_processed)
        s.store.flush()
        st = s.store.stats_snapshot()
        got[backend] = (res.recall.bits(),
                        [(e.segment, e.steps_done, *e.as_ints()[1:4])
                         for e in events], answer,
                        st["async_rotations"] + st["coalesced"],
                        convert.states_to_numpy(s.states))
        if backend == "shard_map":
            assert st["coalesced"] == 0
    (ba, ea, aa, na, sa), (bb, eb, ab, nb, sb) = (got["scan"],
                                                  got["shard_map"])
    np.testing.assert_array_equal(ba, bb)
    assert ea == eb and len(eb) > 2
    _assert_answers_equal(*_same_answer(ab, aa), "world of one")
    assert na == nb
    for name in sa:
        np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)


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


# -- async publishing and serving during ingest on the grid -------------------


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_async_session_equals_scan_session(runs, algo):
    """Under an async policy every rank equals the ``scan`` session with
    the same policy bit for bit: recall bits, counters, answers, each
    rank's worker, the publish totals (nothing coalesced on the grid) and
    the checkpoint file, before and after a rescale."""
    want = runs["scan"]["async"][algo]
    for rank, out in enumerate(runs["ranks"]):
        got = out["async"][algo]
        for a, b in zip(got["ingest"], want["ingest"]):
            np.testing.assert_array_equal(a["bits"], b["bits"])
            assert (a["processed"], a["dropped"], a["forgets"]) == (
                b["processed"], b["dropped"], b["forgets"])
        for key in ("miss", "hit", "rescaled_answer"):
            _assert_answers_equal(*_same_answer(got[key], want[key]),
                                  f"rank {rank} {key}")
        assert got["file"] == want["file"]
        _assert_async_views_equal(got["trained"], want["trained"], rank,
                                  GRID.n_c, f"rank {rank} trained")
        _assert_async_views_equal(got["rescaled"], want["rescaled"], rank,
                                  RESCALE_GRID.n_c, f"rank {rank} rescaled")
        # Two ingest calls of boundaries every 2 steps, all handed over.
        assert got["trained"]["store"]["async_rotations"] > 4


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_async_session_matches_jax_scan_session(runs, algo):
    """The async grid session against JAX's (sync) ``scan`` session:
    recall bits, counters, answer ids, ``known``, cache hits and
    fallbacks exactly, scores and each rank's worker within 1e-5."""
    jx = runs["jax"]
    for rank, out in enumerate(runs["ranks"]):
        got = out["async"][algo]
        for j, run in enumerate(got["ingest"]):
            np.testing.assert_array_equal(
                _nan_free(run["bits"]), _nan_free(jx[f"{algo}/ingest{j}/bits"]))
            np.testing.assert_array_equal(
                [run["processed"], run["dropped"]],
                jx[f"{algo}/ingest{j}/counts"])
        for key in ("miss", "hit"):
            _assert_matches_jax(got[key], jx, f"{algo}/{key}")
        prefix = f"{algo}/trained/"
        for name, w in ((k[len(prefix):], v) for k, v in jx.items()
                        if k.startswith(prefix)):
            g = got["trained"]["states"][name][0]
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w[rank], rtol=RTOL, atol=ATOL,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(g, w[rank], err_msg=name)


def _assert_rows_match_jax(states, jx, prefix, rank):
    """A rank's worker ``states`` against its row of JAX's whole grid
    under ``prefix``: integers exactly, floats within 1e-5."""
    prefix += "/"
    for name, w in ((k[len(prefix):], v) for k, v in jx.items()
                    if k.startswith(prefix)):
        g = states[name]
        if rank >= w.shape[0]:
            assert g.shape[0] == 0, name
        elif w.dtype.kind == "f":
            np.testing.assert_allclose(g[0], w[rank], rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g[0], w[rank], err_msg=name)


def _assert_matches_jax(a, jx, prefix):
    np.testing.assert_array_equal(a["ids"], jx[f"{prefix}/ids"])
    np.testing.assert_array_equal(a["known"], jx[f"{prefix}/known"])
    np.testing.assert_array_equal([a["cache_hits"], a["fallbacks"]],
                                  jx[f"{prefix}/counts"][1:])
    want = jx[f"{prefix}/scores"]
    np.testing.assert_array_equal(np.isneginf(a["scores"]), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(a["scores"][fin], want[fin], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_async_checkpoint_file_is_sync_file(runs, algo):
    """The same states at the same position: the async session's
    checkpoint has the sync session's bytes."""
    for out in runs["ranks"]:
        assert out["async"][algo]["file"] == runs["scan"][algo]["file"]


def _replay(mode_calls) -> dict:
    """The ``scan`` session of ``_reader_case`` (sync, so its versions
    count the same boundaries as the grid's): each snapshot that a call
    was served from is answered as it rotates, by a fresh front-end on
    it alone (no copy kept). Returns ``{(version, queries): answer}``."""
    users, items = _stream()
    users, items = users[:READER_EVENTS], items[:READER_EVENTS]
    served = {}
    for answer, agreement in mode_calls:
        served.setdefault(agreement.version, []).append(answer)
    plan = [q for _, q in _reader_plan()]
    s = _session(_cfg("disgd", "scan"), "sync", READER_EVERY)
    want = {}

    def answer_at(snap):
        if snap.version not in served:
            return
        one = rt.SnapshotStore()
        one.publish(snap.states, snap.events_processed, snap.forgets)
        front = rt.QueryFrontend(one, s.frontend.cfg)
        for q in plan:
            want[(snap.version, q.tobytes())] = (
                snap.events_processed, _answer(front.serve(q)))

    s.store.subscribe(answer_at)
    s.ingest(users[:READER_WARM], items[:READER_WARM])
    s.ingest(users[READER_WARM:], items[READER_WARM:])
    return want


@pytest.mark.parametrize("mode", MODES)
def test_grid_reader_during_ingest(runs, mode):
    """A reader thread a rank calls ``recommend`` during ``ingest``: no
    rank hangs or fails, every call's answer and agreement are the same
    on every rank, and each answer is the ``scan`` session's at the
    agreed snapshot."""
    cases = [out["readers"][mode] for out in runs["ranks"]]
    for rank, case in enumerate(cases):
        assert not case["errors"] and not case["alive"], (rank, case)
        assert len(case["calls"]) == READER_CALLS
    base = cases[0]["calls"]
    for rank, case in enumerate(cases[1:], 1):
        for j, ((a, ga), (b, gb)) in enumerate(zip(case["calls"], base)):
            assert ga == gb, (rank, j)
            _assert_answers_equal(a, b, f"rank {rank} call {j}")
    want = _replay(base)
    plan = [q for _, q in _reader_plan()]
    versions = []
    for (got, agreement), q in zip(base, plan):
        events, answer = want[(agreement.version, q.tobytes())]
        assert agreement.events_processed == events
        assert got["version"] == agreement.version
        for key in ("ids", "scores", "known", "fallbacks"):
            np.testing.assert_array_equal(got[key], answer[key], err_msg=key)
        versions.append(agreement.version)
    assert versions == sorted(versions)


@pytest.mark.parametrize("mode", MODES)
def test_grid_collectives_with_a_reader(runs, mode):
    """With a reader running, the trainer's group carries one all-reduce
    a step and one all-gather a boundary (the popularity head's, on the
    trainer's thread in both modes) and nothing else; the serve group
    carries one all-gather a plane call and the agreements' all-reduces.
    The async boundaries were all rotated, none coalesced."""
    n = READER_EVENTS - READER_WARM
    boundaries = -(-_steps(n) // READER_EVERY)
    warm = -(-_steps(READER_WARM) // READER_EVERY)
    for out in runs["ranks"]:
        case = out["readers"][mode]
        assert case["events"] == n
        assert case["train"]["calls"] == _steps(n) + boundaries + 1
        front = case["frontend"]
        assert front["agreements"] >= READER_CALLS
        assert case["serve"]["calls"] == (front["collectives"]
                                           + front["agreements"])
        store = case["store"]
        assert store["coalesced"] == 0
        assert store["async_rotations"] == (
            0 if mode == "sync" else warm + boundaries)


def test_grid_interleaved_service_equals_scan_and_jax(runs):
    """``run_service`` interleaved under an async policy: every rank's
    answers, staleness, cache hits, fallbacks, publish totals and worker
    equal the ``scan`` run's bit for bit; against JAX's (sync) run the
    answers as in ``_assert_matches_jax`` and the states within 1e-5."""
    want = runs["scan"]["service"]["interleaved"]
    jx = runs["jax"]
    for rank, out in enumerate(runs["ranks"]):
        got = out["service"]["interleaved"]
        assert got["records"] == want["records"]
        assert len(got["answers"]) == SERVICE_INTERLEAVED["query_batches"]
        for j, (a, b) in enumerate(zip(got["answers"], want["answers"])):
            _assert_answers_equal(*_same_answer(a, b), f"rank {rank} {j}")
            _assert_matches_jax(a, jx, f"service/{j}")
        np.testing.assert_array_equal(
            [r[:1] + r[2:] for r in got["records"]],
            jx["service/records"][:, [0, 2, 3]])
        assert got["store"]["coalesced"] == 0
        st = dict(want["store"])
        assert got["store"]["async_rotations"] == (
            st["async_rotations"] + st["coalesced"])
        for name, w in _rows(want["states"], rank, GRID.n_c).items():
            np.testing.assert_array_equal(got["states"][name], w,
                                          err_msg=name)
            j = jx[f"service/states/{name}"][rank]
            if j.dtype.kind == "f":
                np.testing.assert_allclose(got["states"][name][0], j,
                                           rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(got["states"][name][0], j)


def test_grid_threaded_service_keeps_ranks_in_step(runs):
    """``run_service`` threaded: every rank issues the same number of
    query batches, under load alike (the loop decides from the
    agreements), their versions never go back, and each rank's worker is
    its row of a twin fed the same events without queries."""
    users, items = _stream()
    users, items = users[:SERVICE_EVENTS], items[:SERVICE_EVENTS]
    twin = _session(_cfg("disgd", "scan"))
    twin.ingest(users[:THREADED_WARM], items[:THREADED_WARM])
    twin.ingest(users[THREADED_WARM:], items[THREADED_WARM:])
    want = convert.states_to_numpy(twin.states)
    cases = [out["service"]["threaded"] for out in runs["ranks"]]
    for rank, got in enumerate(cases):
        assert len(got["versions"]) >= THREADED_BATCHES
        assert got["versions"] == cases[0]["versions"]
        assert got["under_load"] == cases[0]["under_load"]
        assert got["versions"] == sorted(got["versions"])
        assert got["events"] == users.size
        assert got["store"]["coalesced"] == 0
        for name, w in _rows(want, rank, GRID.n_c).items():
            np.testing.assert_array_equal(got["states"][name], w,
                                          err_msg=name)


def test_grid_autoscaler_equals_scan(runs):
    """The ``Autoscaler`` on an undersized grid under an async policy:
    every rank takes ``scan``'s decisions after each ingest's final
    publish, drops what it drops, answers alike and ends on its grid and
    states; JAX's ``scan`` session's decisions, drops, trail and grid
    exactly, its answers as in ``_assert_matches_jax`` and its states
    within 1e-5."""
    want = runs["scan"]["autoscale"]
    jx = runs["jax"]
    assert want["actions"] == jx["autoscale/actions"].tolist()
    assert [want["dropped"], *want["grid"]] == jx["autoscale/counts"].tolist()
    assert want["trail"] == json.loads(str(jx["autoscale/trail"]))
    assert "grow" in want["actions"]
    for rank, out in enumerate(runs["ranks"]):
        got = out["autoscale"]
        for key in ("actions", "dropped", "trail", "grid"):
            assert got[key] == want[key], (rank, key)
        for j, (a, b) in enumerate(zip(got["answers"], want["answers"])):
            _assert_answers_equal(*_same_answer(a, b), f"rank {rank} {j}")
            _assert_matches_jax(a, jx, f"autoscale/{j}")
        assert got["store"]["coalesced"] == 0
        n_c = want["grid"][0] * want["grid"][1]
        for name, w in _rows(want["states"], rank, n_c).items():
            np.testing.assert_array_equal(got["states"][name], w,
                                          err_msg=name)
        _assert_rows_match_jax(got["states"], jx, "autoscale/states", rank)


def test_grid_ensemble_equals_scan(runs):
    """An ``EnsembleSession`` whose members are grid sessions publishing
    asynchronously: ``scan``'s weights after each segment, its resets,
    its blended answer and each member's worker rows; JAX's ``scan``
    ensemble's resets exactly, its weights within 1e-5 and its answer as
    in ``_assert_matches_jax``."""
    want = runs["scan"]["ensemble"]
    jx = runs["jax"]
    assert want["resets"] == int(jx["ensemble/resets"])
    for rank, out in enumerate(runs["ranks"]):
        got = out["ensemble"]
        assert len(got["weights"]) == len(want["weights"]) == 2
        for j, (a, b) in enumerate(zip(got["weights"], want["weights"])):
            assert a.keys() == b.keys() == set(ENSEMBLE_MEMBERS)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name])
                np.testing.assert_allclose(a[name], jx[f"ensemble/{j}/{name}"],
                                           rtol=RTOL, atol=ATOL)
        assert got["resets"] == want["resets"]
        _assert_answers_equal(*_same_answer(got["answer"], want["answer"]),
                              f"rank {rank}")
        _assert_matches_jax(got["answer"], jx, "ensemble/answer")
        for member, states in want["states"].items():
            for name, w in _rows(states, rank, GRID.n_c).items():
                np.testing.assert_array_equal(got["states"][member][name], w,
                                              err_msg=f"{member} {name}")


@pytest.mark.parametrize("at", FAILS)
def test_grid_failing_subscriber_raises_on_every_rank(runs, at):
    """A subscriber that raises on the publisher thread, after the second
    rotation or the last: ``ingest`` raises ``RuntimeError`` on every
    rank (at the same boundary, or in the final ``flush``) instead of
    hanging, and no rank rotates past the failure."""
    for rank, out in enumerate(runs["ranks"]):
        got = out["failing"][at]
        assert got["raised"] is not None, (rank, got)
        message, cause = got["raised"]
        assert message == "the snapshot publisher failed", rank
        assert "the subscriber failed" in cause, rank
        assert got["rotations"] == got["n"], rank
