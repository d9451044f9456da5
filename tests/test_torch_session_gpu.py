"""The session and serving runtime on the card.

Every test carries the ``gpu`` marker and needs a CUDA device (decided in
the ``cuda_device`` fixture, never at import). This file imports no jax:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_session_gpu.py

  * a held snapshot stays unchanged while the ``cuda`` backend keeps
    updating the live states in place;
  * an async publish boundary never synchronizes the trainer: with a
    long sleep queued on the stream, the engine's boundary and
    ``publish_async`` return while the sleep still runs, and no
    synchronizing call happens under ``torch.cuda.set_sync_debug_mode``;
  * the publisher thread waits on the boundary's event and on nothing
    else: the rotation lands while work queued after the boundary still
    runs;
  * a session on the card trains exactly as a plain ``run_stream`` and
    serves exactly ``grid_topn``'s lists (K1-K5).
"""

import time

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import convert, engine, state as state_lib  # noqa: E402
from repro_torch.data.stream import (MOVIELENS_25M, NETFLIX, scaled,  # noqa: E402
                                     synth_stream)

CAPS = dict(u_cap=256, i_cap=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only "
                    "on the card")
    return torch.device("cuda")


def _stream(algo):
    if algo == "dics":
        users, items, _ = synth_stream(scaled(NETFLIX, 0.0015, n_items=128),
                                       seed=0)
    else:
        users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users, items


def _cfg(algo="disgd"):
    hyper = {"disgd": rt.DisgdHyper, "dics": rt.DicsHyper,
             "bpr": rt.BprHyper}[algo](**CAPS)
    return rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2),
                           micro_batch=256, hyper=hyper, backend="cuda",
                           device="cuda")


def _sleep_cycles(seconds: float) -> int:
    """Card cycles of ``torch.cuda._sleep`` that last about ``seconds``."""
    probe = 10_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * seconds * 1e3 / start.elapsed_time(end))


def _small_states():
    users, items = _stream("disgd")
    return rt.run_stream(users[:600], items[:600], _cfg()).final_states


def _assert_states_equal(got, want):
    want = convert.flatten_state(want)
    for name, t in convert.flatten_state(got).items():
        assert torch.equal(t, want[name]), name


@pytest.mark.gpu
def test_held_snapshot_unchanged_after_further_cuda_steps(cuda_device):
    users, items = _stream("disgd")
    store = rt.SnapshotStore()
    held = {}
    q = torch.as_tensor(np.unique(users)[:64], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(grid=rt.GridSpec(2), top_n=10, u_cap=256, qcap=64)

    def on_publish(ev):
        store.publish(ev.states, ev.events_processed)
        if ev.segment == 0:
            held["snap"] = store.acquire()
            held["copy"] = state_lib.clone_state(held["snap"].states)
            held["answer"] = rt.grid_topn(held["snap"].states, q, **kw)

    res = rt.run_stream(users, items, _cfg(), publish_every=2,
                        on_publish=on_publish)
    assert store.latest_version > 2
    assert not torch.equal(res.final_states.rated, held["copy"].rated)
    _assert_states_equal(held["snap"].states, held["copy"])
    for a, b in zip(rt.grid_topn(held["snap"].states, q, **kw),
                    held["answer"]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_async_publish_never_synchronizes_the_trainer(cuda_device,
                                                      monkeypatch):
    states = _small_states()
    store = rt.SnapshotStore()
    syncs = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (syncs.append(a), real_sync(*a))[1])

    def checked(fn):
        """``fn`` under sync debug mode "error", with no synchronize."""
        def call(*args):
            before = len(syncs)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                assert len(syncs) == before, "the boundary synchronized"
        return call

    scalars = (torch.tensor(7, device=cuda_device),
               torch.tensor(0, device=cuda_device))
    torch.cuda._sleep(_sleep_cycles(0.3))     # the segment still running
    t0 = time.perf_counter()
    checked(lambda: store.publish_async(state_lib.clone_state(states),
                                        *scalars))()
    boundary_s = time.perf_counter() - t0
    assert not torch.cuda.current_stream().query(), (
        "the boundary waited for the card")
    assert boundary_s < 0.1
    assert store.flush(timeout=30.0)
    assert store.acquire().events_processed == 7

    # The engine's own async boundary and the store's hook, under the
    # same checks, on a whole stream (6 boundaries).
    monkeypatch.setattr(engine, "_publish_event",
                        checked(engine._publish_event))
    users, items = _stream("disgd")
    res = rt.run_stream(users, items, _cfg(), publish_every=2,
                        on_publish=checked(store.subscriber("async")),
                        publish_sync=False)
    assert store.flush(timeout=30.0)
    stats = store.stats_snapshot()
    assert stats["async_rotations"] + stats["coalesced"] == 1 + 6
    assert store.acquire().events_processed == res.events_processed


@pytest.mark.gpu
def test_publisher_waits_only_on_the_boundary_event(cuda_device):
    states = _small_states()
    store = rt.SnapshotStore()
    torch.cuda._sleep(_sleep_cycles(0.1))          # the segment
    store.publish_async(state_lib.clone_state(states), 11)
    torch.cuda._sleep(_sleep_cycles(3.0))          # training after it
    later = torch.cuda.Event()
    later.record()
    try:
        assert store.flush(timeout=2.0), "the rotation waited past its event"
        assert not later.query()
        assert store.acquire().events_processed == 11
    finally:
        later.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["disgd", "dics", "bpr"])
def test_session_on_the_card_equals_plain_run(cuda_device, algo):
    users, items = _stream(algo)
    cfg = _cfg(algo)
    s = rt.StreamSession(cfg, serve=rt.ServeConfig.from_stream(
        cfg, batch_size=128), publish=rt.PublishPolicy(every=2))
    half = users.size // 2
    s.ingest(users[:half], items[:half])
    s.ingest(users[half:], items[half:])
    plain = rt.run_stream(users[:half], items[:half], cfg)
    plain = rt.run_stream(users[half:], items[half:], cfg,
                          initial_states=plain.final_states)
    _assert_states_equal(s.states, plain.final_states)
    stats = s.store.stats_snapshot()
    assert stats["sync_rotations"] == 2
    q = np.unique(users)[:100]
    resp = s.recommend(np.concatenate([q, [10**6]]))
    kw = dict(algorithm=algo, grid=cfg.grid, top_n=10, u_cap=256, qcap=128)
    ids, scores, known, served = rt.grid_topn(
        s.states, torch.as_tensor(np.concatenate([q, [10**6]]),
                                  dtype=torch.int32, device=cuda_device), **kw)
    assert served.all()
    k = known.cpu().numpy()
    np.testing.assert_array_equal(resp.known, k)
    np.testing.assert_array_equal(resp.ids[k], ids.cpu().numpy()[k])
    np.testing.assert_array_equal(resp.scores[k], scores.cpu().numpy()[k])
    assert resp.fallbacks == int((~k).sum()) >= 1
