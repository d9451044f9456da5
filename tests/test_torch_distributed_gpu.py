"""The S&R worker grid across processes on the card.

Every test carries the ``gpu`` marker and needs a CUDA device (decided in
a fixture, never at import). This file imports no jax, and the ranks
import it for their functions:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_distributed_gpu.py

  * four gloo ranks sharing one card (``launch.mesh.run_on_ranks``)
    against ``backend="scan"`` in one process on the card, for DISGD,
    DICS and BPR-MF on ``tests/test_torch_distributed.py``'s stream:
    counters, the load history and integers exactly, each rank's worker
    against its row, floats within RTOL 1e-4 / ATOL 1e-5, recall bits
    equal;
  * with two cards or more, NCCL ranks, one a card, against the same;
  * NCCL at world size 1 (``GridSpec.rect(1, 1)``): every step of the
    loop runs under ``torch.cuda.set_sync_debug_mode("error")`` (NCCL
    does not stage through the host), and the result equals ``scan``;
  * a ``StreamSession`` on two gloo ranks sharing the card
    (``GridSpec.rect(1, 2)``, publishing every 2 micro-batches): its
    ``recommend`` equals the one-process ``scan`` session's bit for bit,
    and each rank launched ``fused_topn`` for its own worker;
  * an async grid session (publishing every step) with a reader thread
    a rank calling ``recommend`` during ``ingest``, on four gloo ranks
    sharing the card: every call's answer is the same on every rank and
    equals the ``scan`` session's at the agreed snapshot, and each rank
    launched ``fused_topn`` once a plane call;
  * the same at NCCL world size 1, every step, async boundary and
    ``publish_async`` under sync debug mode "error" (the reader's calls,
    which read their answers back, take turns with them: the mode is
    the process's).
"""

import threading
import time

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import convert, distributed, engine  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ALGOS = ("disgd", "dics", "bpr")
HYPERS = {"disgd": rt.DisgdHyper, "dics": rt.DicsHyper, "bpr": rt.BprHyper}
TIMEOUT = 600.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grid's ranks run on the card")
    return torch.device("cuda")


def _stream():
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:1000], items[:1000]


def _cfg(algo, grid=rt.GridSpec(2)):
    return rt.StreamConfig(algorithm=algo, grid=grid, micro_batch=256,
                           hyper=HYPERS[algo](u_cap=128, i_cap=32),
                           backend="scan", device="cuda")


def _cases(grid):
    users, items = _stream()
    return [(users, items, _cfg(a, grid)) for a in ALGOS]


def _no_sync_rank(info, cases):
    """``stream_on_rank`` with every loop step under sync debug mode
    "error" (a synchronizing call raises)."""
    make = engine._make_batch_step

    def checked(*args):
        step = make(*args)

        def run(*a):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    engine._make_batch_step = checked
    return distributed.stream_on_rank(info, cases)


def _assert_grid_equals_scan(run, cases):
    for (users, items, cfg), *outs in zip(cases, *run.results):
        want = rt.run_stream(users, items, cfg)
        states = convert.states_to_numpy(want.final_states)
        for rank, out in enumerate(outs):
            res = out.result
            what = f"{cfg.algorithm} rank {rank}"
            assert (res.events_processed, res.dropped) == (
                want.events_processed, want.dropped), what
            np.testing.assert_array_equal(np.stack(res.load_history),
                                          np.stack(want.load_history))
            a, b = res.recall.bits(), want.recall.bits()
            differ = np.flatnonzero(~((a == b) | (np.isnan(a) & np.isnan(b))))
            assert differ.size == 0, (
                f"{what}: {differ.size} recall bits differ, the first at "
                f"event {differ[:1]}")
            for name, w in states.items():
                got = res.final_states[name][0]
                if w.dtype.kind == "f":
                    np.testing.assert_allclose(got, w[rank], rtol=RTOL,
                                               atol=ATOL, err_msg=name)
                else:
                    np.testing.assert_array_equal(got, w[rank], err_msg=name)
            assert out.peak_bytes > 0


@pytest.mark.gpu
def test_gloo_ranks_on_one_card_match_scan(cuda_device):
    cases = _cases(rt.GridSpec(2))
    run = mesh_lib.run_on_ranks(distributed.stream_on_rank, 4, "cuda",
                                cases, timeout=TIMEOUT)
    if torch.cuda.device_count() < 4:
        assert run.backend == "gloo"
    _assert_grid_equals_scan(run, cases)


@pytest.mark.gpu
def test_nccl_ranks_match_scan(cuda_device):
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"NCCL takes one card a rank and this machine has "
                    f"{cards}: the grid needs two cards or more")
    grid = rt.GridSpec(2) if cards >= 4 else rt.GridSpec.rect(1, 2)
    cases = _cases(grid)
    run = mesh_lib.run_on_ranks(distributed.stream_on_rank, grid.n_c,
                                "cuda", cases, timeout=TIMEOUT)
    assert run.backend == "nccl" and run.ranks_per_card == 1
    _assert_grid_equals_scan(run, cases)


@pytest.mark.gpu
def test_nccl_world_of_one_never_syncs(cuda_device):
    grid = rt.GridSpec.rect(1, 1)
    cases = _cases(grid)
    run = mesh_lib.run_on_ranks(_no_sync_rank, 1, "cuda", cases,
                                timeout=TIMEOUT)
    assert run.backend == "nccl"
    _assert_grid_equals_scan(run, cases)
    for (users, _, cfg), out in zip(cases, run.results[0]):
        steps = (-(-users.size // cfg.micro_batch)
                 + -(-cfg.micro_batch // cfg.bucket_capacity))
        assert out.collectives["calls"] == steps


@pytest.mark.gpu
def test_one_worker_per_rank_holds_one_table(cuda_device):
    """Shared nothing: a rank allocates its own worker's tables only."""
    cfg = _cfg("disgd", rt.GridSpec.rect(1, 1))
    states = distributed.init_grid_states(cfg,
                                          mesh_lib.make_grid_mesh(cfg.grid))
    assert states.rated.shape[0] == 1 and states.rated.is_cuda


@pytest.mark.gpu
@pytest.mark.parametrize("algo,kernel", [("disgd", "fused_topn"),
                                         ("dics", "dics_topn")])
def test_grid_session_on_one_card_matches_scan(cuda_device, algo, kernel):
    """Two ranks sharing the card: every rank's answer is the ``scan``
    session's, and each launches the serve leaf's kernel as often as the
    ``scan`` session does (one launch a plane call)."""
    cfg = _cfg(algo, rt.GridSpec.rect(1, 2))
    users, items = _stream()
    q = np.concatenate([np.unique(users)[:100], [10**6]])
    run = mesh_lib.run_on_ranks(mesh_lib.session_on_rank, 2, "cuda",
                                [(users, items, cfg, q)], timeout=TIMEOUT)
    s = rt.StreamSession(cfg, publish=rt.PublishPolicy(every=2, mode="sync"))
    s.ingest(users, items)
    ops.reset_launch_counts()
    want = s.recommend(q)
    launches = ops.launch_counts()[kernel]
    assert launches > 0
    for (out,) in run.results:
        assert out.launches[kernel] == launches
        got = out.response
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.scores, want.scores)
        np.testing.assert_array_equal(got.known, want.known)
        assert (got.snapshot_version, got.fallbacks) == (
            want.snapshot_version, want.fallbacks)


def _async_reader_rank(info, users, items, cfg, queries, checked=False):
    """An async grid session publishing every step on this rank: a warm
    ``ingest``, then a reader thread's ``recommend`` calls during the
    next one; with ``checked``, every loop step, async boundary and
    ``publish_async`` under sync debug mode "error", the reader taking
    turns with them."""
    import dataclasses

    gate = threading.Lock()

    def gated(fn):
        def call(*a, **k):
            with gate:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        return call

    if checked:
        make = engine._make_batch_step
        engine._make_batch_step = lambda *a: gated(make(*a))
        engine._publish_event = gated(engine._publish_event)
    cfg = dataclasses.replace(cfg, backend="shard_map", device=info.device)
    s = rt.StreamSession(cfg, publish=rt.PublishPolicy(every=1,
                                                       mode="async"))
    if checked:
        s.store.publish_async = gated(s.store.publish_async)
    s.ingest(users[:256], items[:256])
    ops.reset_launch_counts()
    calls, errors = [], []

    def reader():
        try:
            for _ in range(READS):
                with gate:
                    r = s.recommend(queries)
                    calls.append((r.ids, r.scores, r.known, r.fallbacks,
                                  s.store.last_agreement))
                time.sleep(0.01)
        except BaseException as e:      # reported by the test
            errors.append(repr(e))

    t = threading.Thread(target=reader)
    t.start()
    s.ingest(users[256:], items[256:])
    t.join(TIMEOUT)
    return dict(calls=calls, errors=errors, alive=t.is_alive(),
                launches=ops.launch_counts()["fused_topn"],
                plane=s.frontend.stats_snapshot()["plane_batches"],
                store=s.store.stats_snapshot())


READS = 4


def _assert_reads_equal_scan(run, users, items, cfg, queries):
    """Every rank's calls alike, each the ``scan`` session's answer at
    the agreed snapshot (a sync session: the same versions), answered as
    it rotates."""
    cases = [r for r in run.results]
    for rank, case in enumerate(cases):
        assert not case["errors"] and not case["alive"], (rank, case)
        assert len(case["calls"]) == READS
        assert case["store"]["coalesced"] == 0
        for a, b in zip(case["calls"], cases[0]["calls"]):
            assert a[4] == b[4]
            for x, y in zip(a[:4], b[:4]):
                np.testing.assert_array_equal(x, y)
    served = {c[4].version for c in cases[0]["calls"]}
    s = rt.StreamSession(cfg, publish=rt.PublishPolicy(every=1, mode="sync"))
    want = {}

    def answer_at(snap):
        if snap.version in served:
            one = rt.SnapshotStore()
            one.publish(snap.states, snap.events_processed, snap.forgets)
            r = rt.QueryFrontend(one, s.frontend.cfg).serve(queries)
            want[snap.version] = (snap.events_processed,
                                  (r.ids, r.scores, r.known, r.fallbacks))

    s.store.subscribe(answer_at)
    s.ingest(users[:256], items[:256])
    s.ingest(users[256:], items[256:])
    for call in cases[0]["calls"]:
        events, answer = want[call[4].version]
        assert call[4].events_processed == events
        for x, y in zip(call[:4], answer):
            np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
def test_grid_async_session_with_a_reader_on_one_card(cuda_device):
    cfg = _cfg("disgd")
    users, items = _stream()
    q = np.concatenate([np.unique(users)[:100], [10**6]])
    run = mesh_lib.run_on_ranks(_async_reader_rank, 4, "cuda", users, items,
                                cfg, q, timeout=TIMEOUT)
    _assert_reads_equal_scan(run, users, items, cfg, q)
    for case in run.results:
        assert case["launches"] == case["plane"] > 0


@pytest.mark.gpu
def test_nccl_world_of_one_async_reader_never_syncs(cuda_device):
    cfg = _cfg("disgd", rt.GridSpec.rect(1, 1))
    users, items = _stream()
    q = np.concatenate([np.unique(users)[:100], [10**6]])
    run = mesh_lib.run_on_ranks(_async_reader_rank, 1, "cuda", users, items,
                                cfg, q, True, timeout=TIMEOUT)
    assert run.backend == "nccl"
    _assert_reads_equal_scan(run, users, items, cfg, q)
