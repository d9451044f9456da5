"""The port's serving runtime against the JAX package: publish hooks,
snapshot store, query front-end, publish policy and metrics registry.

On the CPU, at grid 2 x 2, u_cap 256, i_cap 64, micro-batch 256, for
DISGD and BPR-MF on ``synth_stream(scaled(MOVIELENS_25M, 0.002))`` and
DICS on ``synth_stream(scaled(NETFLIX, 0.0015, n_items=128))``:

  * the ``PublishEvent`` sequence of ``run_stream(publish_every=...)``
    (segment, steps_done, events_processed, dropped, forgets and each
    event's states, the host loop's tail publish included) for each
    port backend against the JAX backend it is held to (``scan`` /
    ``scan``, ``cuda`` / ``pallas``, ``host`` / ``host``);
  * ``popularity_topn`` and ``QueryFrontend.serve`` on the same states
    carried across with ``core.convert``;
  * ``PublishPolicy``'s errors and the registry's exports on the same
    operations.

Integers, ids, counters and versions exactly; factor vectors and DISGD /
BPR scores within RTOL 1e-5 / ATOL 1e-5 (``test_torch_pipeline.py``'s
tolerance); DICS bit for bit. Then the port-only semantics that JAX's
own tests pin (``test_serve_grid.py``, ``test_service.py``), with the
in-place case they cannot have: a held snapshot stays unchanged while
the loop keeps updating its states, and the async backlog holds at most
one pending copy.
"""

import dataclasses
import functools
import threading
import time

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.algos import bpr as jbpr  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.dics import DicsHyper as JDics  # noqa: E402
from repro.core.disgd import DisgdHyper as JDisgd  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.serve import frontend as jfrontend  # noqa: E402
from repro.serve import policy as jpolicy  # noqa: E402
from repro.serve import snapshot as jsnapshot  # noqa: E402
from repro_torch.core import convert, engine  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.data.stream import (MOVIELENS_25M, NETFLIX, scaled,  # noqa: E402
                                     synth_stream)
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.serve import (PublishPolicy, QueryFrontend, ServeConfig,  # noqa: E402
                               SnapshotStore, StaleSnapshotError,
                               popularity_topn)

RTOL, ATOL = 1e-5, 1e-5
CAPS = dict(u_cap=256, i_cap=64)
MB = 256
HYPERS = {"disgd": (rt.DisgdHyper, JDisgd), "dics": (rt.DicsHyper, JDics),
          "bpr": (rt.BprHyper, jbpr.BprHyper)}
ALGOS = sorted(HYPERS)
BACKENDS = [("scan", "scan"), ("cuda", "pallas"), ("host", "host")]


@functools.lru_cache(maxsize=None)
def _stream(algo):
    if algo == "dics":
        users, items, _ = synth_stream(scaled(NETFLIX, 0.0015, n_items=128),
                                       seed=0)
    else:
        users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users, items


def _cfgs(algo, backend_t="cuda", backend_j="pallas", **over):
    th, jh = HYPERS[algo]
    t = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2), micro_batch=MB,
                        backend=backend_t, hyper=th(**CAPS), device="cpu",
                        telemetry=False, **over)
    j = jpipe.StreamConfig(algorithm=algo, grid=JGrid(2), micro_batch=MB,
                           backend=backend_j, hyper=jh(**CAPS),
                           telemetry=False, **over)
    return t, j


def _flat(j_states):
    return convert.flatten_state(jax.tree.map(np.asarray, j_states))


def _assert_states_match(t_states, j_states, algo, what=""):
    got = convert.states_to_numpy(t_states)
    for name, want in _flat(j_states).items():
        if want.dtype.kind == "f" and algo != "dics":
            np.testing.assert_allclose(got[name], want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(got[name], want,
                                          err_msg=f"{what}: {name}")


@functools.lru_cache(maxsize=None)
def _jax_events(algo, backend_j, n, every):
    users, items = (x[:n] for x in _stream(algo))
    events = []
    jpipe.run_stream(users, items, _cfgs(algo, "scan", backend_j)[1],
                     publish_every=every, on_publish=events.append)
    return events


@functools.lru_cache(maxsize=None)
def _jax_final(algo):
    """JAX ``pallas`` over the whole stream and its first half."""
    users, items = _stream(algo)
    cfg = _cfgs(algo)[1]
    half = users.size // 2
    return (jpipe.run_stream(users, items, cfg).final_states,
            jpipe.run_stream(users[:half], items[:half], cfg).final_states)


_FIELDS = ("segment", "steps_done", "events_processed", "dropped", "forgets")


# -- publish hooks ------------------------------------------------------------


@pytest.mark.parametrize("backends", BACKENDS, ids=[b[0] for b in BACKENDS])
@pytest.mark.parametrize("algo", ALGOS)
def test_publish_events_match_jax(algo, backends):
    """1,500 events: 6 micro-batches, so the host loop publishes at batch
    4 and once more at its tail; the device loops publish after 4 and 8
    steps (6 batches + 2 drain steps)."""
    n, every = 1500, 4
    users, items = (x[:n] for x in _stream(algo))
    events = []
    res = rt.run_stream(users, items, _cfgs(algo, *backends)[0],
                        publish_every=every, on_publish=events.append)
    want = _jax_events(algo, backends[1], n, every)
    assert [tuple(getattr(e, f) for f in _FIELDS) for e in events] == \
        [tuple(getattr(e, f) for f in _FIELDS) for e in want]
    assert [e.steps_done for e in events] == (
        [4, 6] if backends[0] == "host" else [4, 8])
    assert events[-1].events_processed == res.events_processed
    for k, (got, exp) in enumerate(zip(events, want)):
        assert isinstance(got.events_processed, int)
        assert got.detector is None and got.telemetry is None
        _assert_states_match(got.states, exp.states, algo, f"event {k}")


@pytest.mark.parametrize("algo", ALGOS)
def test_async_boundary_hands_tensor_scalars(algo):
    """``publish_sync=False``: the progress scalars are 0-d tensors (no
    read at the boundary); resolved, the events equal JAX's."""
    n, every = 1500, 4
    users, items = (x[:n] for x in _stream(algo))
    events = []
    rt.run_stream(users, items, _cfgs(algo)[0], publish_every=every,
                  on_publish=events.append, publish_sync=False)
    for e in events:
        assert all(torch.is_tensor(getattr(e, f)) and getattr(e, f).dim() == 0
                   for f in ("events_processed", "dropped", "forgets"))
    got = [e.as_ints() for e in events]
    want = _jax_events(algo, "pallas", n, every)
    assert [tuple(getattr(e, f) for f in _FIELDS) for e in got] == \
        [tuple(getattr(e, f) for f in _FIELDS) for e in want]
    for g, w in zip(got, want):
        _assert_states_match(g.states, w.states, algo)


def test_on_publish_without_cadence_publishes_once_at_the_end():
    users, items = (x[:700] for x in _stream("disgd"))
    t_cfg, j_cfg = _cfgs("disgd")
    got, want = [], []
    rt.run_stream(users, items, t_cfg, on_publish=got.append)
    jpipe.run_stream(users, items, j_cfg, on_publish=want.append)
    assert len(got) == len(want) == 1
    assert [getattr(got[0], f) for f in _FIELDS] == \
        [getattr(want[0], f) for f in _FIELDS]


@pytest.mark.parametrize("backend", ["scan", "cuda", "host"])
def test_held_snapshot_unaffected_by_further_training(backend):
    """The port's loops update their states in place: a snapshot held
    from the first boundary must still answer as it did after later
    micro-batches changed the live states."""
    users, items = _stream("disgd")
    cfg = _cfgs("disgd", backend, "scan")[0]
    store = SnapshotStore()
    held, answers = {}, {}
    q = torch.as_tensor(np.unique(users)[:16], dtype=torch.int32)
    kw = dict(algorithm="disgd", grid=rt.GridSpec(2), top_n=10, u_cap=256,
              qcap=16)

    def on_publish(ev):
        store.publish(ev.states, ev.events_processed, ev.forgets)
        if ev.segment == 0:
            held["snap"] = store.acquire()
            held["rated"] = held["snap"].states.rated.clone()
            answers["then"] = [t.clone() for t in
                               rt.grid_topn(held["snap"].states, q, **kw)]

    res = rt.run_stream(users, items, cfg, publish_every=2,
                        on_publish=on_publish)
    assert store.latest_version > 1
    assert not torch.equal(res.final_states.rated, held["rated"])
    again = rt.grid_topn(held["snap"].states, q, **kw)
    for a, b in zip(answers["then"], again):
        assert torch.equal(a, b)
    assert torch.equal(held["snap"].states.rated, held["rated"])


def test_snapshot_is_exact_micro_batch_boundary_state():
    """Each published state equals an independent run over exactly the
    events of the first ``steps_done`` micro-batches, bit for bit."""
    users, items = _stream("disgd")
    cfg = _cfgs("disgd", "scan", "scan", capacity_factor=4.0)[0]
    published = []
    rt.run_stream(users, items, cfg, publish_every=2,
                  on_publish=published.append)
    assert len(published) >= 3
    for ev in published[:3]:
        e = ev.events_processed
        assert e == min(ev.steps_done * MB, users.size)
        ref = rt.run_stream(users[:e], items[:e], cfg)
        for a, b in zip(convert.states_to_numpy(ev.states).values(),
                        convert.states_to_numpy(ref.final_states).values()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["cuda", "host"])
def test_publishing_leaves_training_and_wall_clock_accounting_alone(backend):
    users, items = (x[:1500] for x in _stream("disgd"))
    cfg = _cfgs("disgd", backend, backend)[0]
    plain = rt.run_stream(users, items, cfg)
    t0 = time.perf_counter()
    slow = rt.run_stream(users, items, cfg, publish_every=1,
                         on_publish=lambda ev: time.sleep(0.1))
    outer = time.perf_counter() - t0
    for a, b in zip(convert.states_to_numpy(plain.final_states).values(),
                    convert.states_to_numpy(slow.final_states).values()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(plain.recall.bits(), slow.recall.bits())
    # The subscriber's sleeps (one a boundary: 8 on the device loop, 6 on
    # the host loop) are left out of the trainer's wall clock.
    boundaries = 6 if backend == "host" else 8
    assert 0 < slow.wall_seconds <= outer - 0.1 * boundaries


# -- popularity head and front-end --------------------------------------------


@pytest.mark.parametrize("algo", ALGOS)
def test_popularity_topn_matches_jax(algo):
    j_states = _jax_final(algo)[0]
    t_states = convert.states_from_numpy(_flat(j_states), device="cpu")
    for n in (5, 100, 4096):
        got_ids, got_mass = popularity_topn(t_states, n)
        want_ids, want_mass = jsnapshot.popularity_topn(j_states, n)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_mass, want_mass)
        assert got_ids.dtype == np.int64 and got_mass.dtype == np.float64
    assert (got_ids == -1).any()        # fewer live items than 4,096


def _queries(algo):
    """40 stream users, 30 of them in grid column 0 (so batches of 16
    overflow a column's 8 slots), 5 repeated, padding, 2 unknown ids."""
    users = np.unique(_stream(algo)[0])
    rng = np.random.default_rng(5)
    known = np.concatenate([rng.choice(users[users % 2 == c], m, replace=False)
                            for c, m in ((0, 30), (1, 10))])
    known = rng.permutation(known)
    return np.concatenate([known, known[:5], [-1, 10**6, 10**6 + 3]])


def _assert_responses_match(got, want, algo):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.known, np.asarray(want.known))
    np.testing.assert_array_equal(np.isneginf(got.scores),
                                  np.isneginf(want.scores))
    fin = np.isfinite(want.scores)
    if algo == "dics":
        np.testing.assert_array_equal(got.scores, want.scores)
    else:
        np.testing.assert_allclose(got.scores[fin], want.scores[fin],
                                   rtol=RTOL, atol=ATOL)
    for f in ("snapshot_version", "cache_hits", "fallbacks",
              "staleness_events", "snapshot_forgets"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.ids.dtype == np.int32 and got.scores.dtype == np.float32


@pytest.mark.parametrize("algo", ALGOS)
def test_frontend_matches_jax(algo):
    """Misses (with column overflow re-queued at query capacity 8),
    duplicates, padding and unknown users; then the same call as cache
    hits; then a rotation to another state and a lazily invalidated
    cache; the counters after each call."""
    j_full, j_half = _jax_final(algo)
    t_full, t_half = (convert.states_from_numpy(_flat(s), device="cpu")
                      for s in (j_full, j_half))
    kw = dict(algorithm=algo, u_cap=256, top_n=10, k_nn=10, batch_size=16,
              query_capacity=8, cache_capacity=32)
    j_store, t_store = jsnapshot.SnapshotStore(), SnapshotStore()
    j_fe = jfrontend.QueryFrontend(j_store, jfrontend.ServeConfig(
        grid=JGrid(2), **kw))
    t_fe = QueryFrontend(t_store, ServeConfig(grid=rt.GridSpec(2), **kw))
    q = _queries(algo)
    j_store.publish(j_half, 1000)
    t_store.publish(t_half, 1000)
    for step in range(3):
        if step == 2:
            j_store.publish(j_full, 2000, forgets=1)
            t_store.publish(t_full, 2000, forgets=1)
        got, want = t_fe.serve(q), j_fe.serve(q)
        _assert_responses_match(got, want, algo)
        assert t_fe.stats_snapshot() == j_fe.stats_snapshot()
    stats = t_fe.stats_snapshot()
    assert stats["requeued"] > 0 and stats["lazy_drops"] > 0
    assert stats["invalidations"] == 1 and got.fallbacks >= 2


@pytest.mark.parametrize("algo", ALGOS)
def test_serve_config_from_stream_matches_jax(algo):
    t_cfg, j_cfg = _cfgs(algo)
    got = ServeConfig.from_stream(t_cfg, batch_size=32)
    want = jfrontend.ServeConfig.from_stream(j_cfg, batch_size=32)
    for f in ("algorithm", "u_cap", "top_n", "k_nn", "batch_size", "qcap",
              "cache_capacity", "max_staleness_events", "storage"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.grid.n_i, got.grid.g) == (want.grid.n_i, want.grid.g)


# -- publish policy and the metrics registry ----------------------------------


@pytest.mark.parametrize("kw", [dict(mode="eventually"), dict(every=-1),
                                dict(max_staleness_events=-1)],
                         ids=["mode", "every", "staleness"])
def test_publish_policy_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jpolicy.PublishPolicy(**kw)
    with pytest.raises(ValueError) as got:
        PublishPolicy(**kw)
    assert str(got.value) == str(want.value)


def test_publish_policy_matches_jax():
    for kw in (dict(), dict(every=8, mode="sync"),
               dict(every=3, max_staleness_events=0)):
        got, want = PublishPolicy(**kw), jpolicy.PublishPolicy(**kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.is_async == want.is_async
        for mb in (1, 256):
            assert (got.staleness_bound_events(mb)
                    == want.staleness_bound_events(mb))


def _exercise(mod):
    reg = mod.MetricsRegistry()
    reg.counter("events", "Events in", labels=("algo",)).labels(
        algo="disgd").inc(3)
    reg.counter("events", labels=("algo",)).labels(algo="dics").inc(2.5)
    g = reg.gauge("depth", "Queue depth")
    g.set(4)
    g.set_max(2)
    g.inc(3)
    reg.gauge("hwm", labels=("w",)).labels(w="0").set_max(7)
    h = reg.histogram("lat", "Latency", labels=("stage",))
    for v in (1e-7, 3e-6, 0.004, 0.004, 2.5, 1e5):
        h.labels(stage="serve").observe(v)
    h.labels(stage="ingest").observe(0.25)
    scoped = mod.ScopedRegistry(reg, member="bpr")
    scoped.counter("rounds", "Rounds").inc()
    scoped.histogram("scoped_lat", labels=("stage",)).labels(stage="x").observe(1)
    small = mod.MetricsRegistry().histogram("s", keep_samples=2)
    for v in (0.1, 0.2, 0.3, 50.0):
        small.observe(v)
    merged = mod.merge_histograms(h.labels(stage="serve").snapshot(),
                                  h.labels(stage="ingest").snapshot())
    return (reg.to_prometheus(), reg.to_json(), merged.count, merged.counts,
            merged.percentile(50), small.percentile(90),
            h.labels(stage="serve").percentile(99), mod.default_buckets())


def test_registry_exports_match_jax():
    got, want = _exercise(tmetrics), _exercise(jmetrics)
    assert got[0] == want[0]                # Prometheus text, byte for byte
    assert got[1] == want[1]                # JSON
    assert got[2:] == want[2:]


def test_registry_rejects_what_jax_rejects():
    for mod in (tmetrics, jmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("c", labels=("a",))
        with pytest.raises(ValueError):
            reg.gauge("c")
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)
        with pytest.raises(ValueError):
            mod.ScopedRegistry(reg)


# -- snapshot store (JAX's test_serve_grid.py / test_service.py) ---------------


def _random_grid(seed, n_i, g, u_cap=24, i_cap=16, k=4):
    """Stacked [n_c, ...] DISGD states with slot-consistent global ids."""
    rng = np.random.default_rng(seed)
    n_c = n_i * g
    uid = np.full((n_c, u_cap), -1, np.int64)
    iid = np.full((n_c, i_cap), -1, np.int64)
    for w in range(n_c):
        row, col = divmod(w, g)
        for s in range(u_cap):
            if rng.random() < 0.6:
                uid[w, s] = g * (s + u_cap * rng.integers(0, 3)) + col
        for s in range(i_cap):
            if rng.random() < 0.7:
                iid[w, s] = n_i * (s + i_cap * rng.integers(0, 3)) + row
    zero = np.zeros((n_c,), np.int32)
    flat = dict(user_ids=uid, item_ids=iid,
                user_freq=rng.integers(0, 5, (n_c, u_cap)),
                item_freq=np.where(iid >= 0, rng.integers(1, 9, (n_c, i_cap)),
                                   0),
                user_ts=np.zeros((n_c, u_cap)), item_ts=np.zeros((n_c, i_cap)),
                clock=zero,
                user_vecs=rng.normal(size=(n_c, u_cap, k)).astype(np.float32),
                item_vecs=rng.normal(size=(n_c, i_cap, k)).astype(np.float32),
                rated=rng.random((n_c, u_cap, i_cap)) < 0.2)
    return convert.states_from_numpy(flat, device="cpu")


def _frontend(n_i=1, g=1, seed=0, **over):
    states = _random_grid(seed, n_i, g)
    store = SnapshotStore()
    store.publish(states, events_processed=0)
    cfg = ServeConfig(algorithm="disgd", grid=rt.GridSpec(n_i), u_cap=24,
                      top_n=5, batch_size=16, **over)
    return states, store, QueryFrontend(store, cfg)


def _live_users(states):
    uids = states.tables.user_ids.reshape(-1).numpy()
    return uids[uids >= 0]


def test_staleness_bound_enforced():
    states = _random_grid(0, 1, 1)
    store = SnapshotStore()
    with pytest.raises(LookupError):
        store.acquire()
    store.publish(states, events_processed=1000)
    assert store.acquire(max_staleness_events=0).version == 1
    store.report_progress(1500)
    assert store.staleness() == 500
    store.acquire(max_staleness_events=500)
    with pytest.raises(StaleSnapshotError):
        store.acquire(max_staleness_events=499)
    store.publish(states, events_processed=1500)
    assert store.acquire(max_staleness_events=0).version == 2
    with pytest.raises(ValueError, match="2 slots"):
        SnapshotStore(slots=1)


def test_fallback_pads_with_neg_inf_when_grid_has_few_items():
    states = _random_grid(0, 1, 1, u_cap=8, i_cap=8)
    t = states.tables
    t.item_ids.fill_(-1)
    t.item_ids[0, :2] = torch.tensor([5, 3], dtype=torch.int32)
    t.item_freq[0, :2] = torch.tensor([7, 2], dtype=torch.int32)
    store = SnapshotStore()
    store.publish(states, events_processed=0)
    fe = QueryFrontend(store, ServeConfig(grid=rt.GridSpec(1), u_cap=8,
                                          top_n=5, batch_size=4))
    resp = fe.serve(np.asarray([12345]))
    assert resp.fallbacks == 1
    np.testing.assert_array_equal(resp.ids[0], [5, 3, -1, -1, -1])
    assert resp.scores[0][0] == 7.0 and resp.scores[0][1] == 2.0
    assert np.isneginf(resp.scores[0][2:]).all()


def test_frontend_caches_and_invalidates_on_rotation():
    states, store, fe = _frontend()
    q = _live_users(states)[:6]
    first, second = fe.serve(q), fe.serve(q)
    assert first.cache_hits == 0 and second.cache_hits == len(q)
    np.testing.assert_array_equal(first.ids, second.ids)
    assert fe.stats_snapshot()["plane_batches"] == 1
    store.publish(states, events_processed=10)
    assert fe.serve(q).cache_hits == 0
    assert fe.stats_snapshot()["invalidations"] == 1
    store.publish(states, events_processed=20, forgets=1)
    assert fe.serve(q).cache_hits == 0
    assert fe.stats_snapshot()["invalidations"] == 2


def test_frontend_requeues_column_overflow():
    g = 2
    states, store, fe = _frontend(n_i=g, g=g, query_capacity=8)
    uids = _live_users(states)
    col0 = np.unique(uids[uids % g == 0])[:16]
    assert col0.size == 16
    resp = fe.serve(col0)
    assert fe.stats_snapshot()["requeued"] > 0
    assert resp.known.all() and (resp.ids >= 0).all()


def test_frontend_answers_batches_larger_than_the_cache():
    states, store, fe = _frontend(cache_capacity=4)
    q = np.unique(_live_users(states))[:10]
    assert q.size == 10
    resp = fe.serve(q)
    assert resp.known.all() and (resp.ids >= 0).any(axis=1).all()
    first = fe.serve(q[:1])
    mixed = fe.serve(q)
    assert mixed.known.all() and mixed.cache_hits >= 1
    np.testing.assert_array_equal(mixed.ids[0], first.ids[0])


def test_frontend_enforces_staleness_bound():
    states, store, fe = _frontend(
        publish=PublishPolicy(max_staleness_events=100))
    q = _live_users(states)[:2]
    assert fe.serve(q).staleness_events == 0
    store.report_progress(500)
    with pytest.raises(StaleSnapshotError):
        fe.serve(q)
    store.publish(states, events_processed=500)
    fe.serve(q)
    h = fe.metrics.get("serve_staleness_events").snapshot()
    assert h.count == 2


def test_retarget_drops_the_cache():
    states, store, fe = _frontend()
    q = _live_users(states)[:4]
    fe.serve(q)
    fe.retarget(rt.GridSpec(1), u_cap=24)
    assert fe.serve(q).cache_hits == 0
    assert fe.stats_snapshot()["retargets"] == 1
    assert fe.cfg.u_cap == 24 and fe.cfg.storage is None


def test_publish_async_flush_is_deterministic_and_coalesces():
    states = _random_grid(0, 2, 2)
    store = SnapshotStore()
    n = 25
    for k in range(n):
        store.publish_async(states, (k + 1) * 10)
    assert store.flush(timeout=10.0)
    assert store.acquire().events_processed == n * 10
    assert store.progress == n * 10
    stats = store.stats_snapshot()
    assert stats["async_rotations"] == store.latest_version
    assert stats["async_rotations"] + stats["coalesced"] == n


def test_async_backlog_holds_at_most_one_pending_copy():
    """While a rotation is in flight, every further publish but the
    newest is coalesced at once; the newest rotates after it."""
    states = _random_grid(0, 1, 1)
    store = SnapshotStore()
    entered, release = threading.Event(), threading.Event()

    def block(snap):
        if snap.version == 1:
            entered.set()
            assert release.wait(10.0)

    store.subscribe(block)
    store.publish_async(states, 1)
    assert entered.wait(10.0)           # rotation 1 in flight
    for k in range(2, 12):
        store.publish_async(states, k)
    assert store.stats_snapshot()["coalesced"] == 9
    release.set()
    assert store.flush(timeout=10.0)
    stats = store.stats_snapshot()
    assert stats == {"async_rotations": 2, "sync_rotations": 0,
                     "rotations": 2, "coalesced": 9}
    assert store.acquire().events_processed == 11
    assert store.metrics.get("snapshot_coalesced_total").value == 9


def test_publish_async_accepts_tensor_scalars():
    store = SnapshotStore()
    store.publish_async(_random_grid(0, 1, 1), torch.tensor(640),
                        torch.tensor(2, dtype=torch.int32))
    assert store.flush(timeout=10.0)
    snap = store.acquire()
    assert snap.events_processed == 640 and snap.forgets == 2
    assert isinstance(snap.events_processed, int)


def test_publish_async_repeated_flush_cycles_never_strand_buffers():
    states = _random_grid(0, 1, 1)
    store = SnapshotStore()
    for k in range(200):
        store.publish_async(states, k + 1)
        assert store.flush(timeout=10.0)
        assert store.acquire().events_processed == k + 1


def test_subscribe_listener_fires_after_async_rotation():
    states = _random_grid(0, 1, 1)
    store = SnapshotStore()
    seen = []
    store.subscribe(lambda snap: seen.append(snap.version))
    store.publish(states, 10)
    store.publish_async(states, 20)
    assert store.flush(timeout=10.0)
    assert seen[0] == 1 and seen[-1] == store.latest_version


def test_failing_rotation_does_not_wedge_the_store():
    states = _random_grid(0, 1, 1)
    store = SnapshotStore()
    fail = [True]

    def listener(snap):
        if fail[0]:
            fail[0] = False
            raise RuntimeError("listener failed")

    store.subscribe(listener)
    hook = threading.excepthook
    threading.excepthook = lambda args: None
    try:
        store.publish_async(states, 1)
        assert store.flush(timeout=10.0)
        store.publish_async(states, 2)
        assert store.flush(timeout=10.0)
    finally:
        threading.excepthook = hook
    assert store.acquire().events_processed == 2


def test_store_subscriber_adapts_the_engine_hook():
    users, items = (x[:1500] for x in _stream("disgd"))
    cfg = _cfgs("disgd")[0]
    for mode in ("sync", "async"):
        store = SnapshotStore()
        res = rt.run_stream(users, items, cfg, publish_every=2,
                            on_publish=store.subscriber(mode),
                            publish_sync=mode == "sync")
        assert store.flush(timeout=10.0)
        snap = store.acquire()
        assert snap.events_processed == res.events_processed
        stats = store.stats_snapshot()
        assert stats[f"{mode}_rotations"] + stats["coalesced"] == 4
        for a, b in zip(convert.states_to_numpy(snap.states).values(),
                        convert.states_to_numpy(res.final_states).values()):
            np.testing.assert_array_equal(a, b)


def test_publish_event_as_ints():
    ev = engine.PublishEvent(None, torch.tensor(5), torch.tensor(1),
                             torch.tensor(0), 0, 4)
    got = ev.as_ints()
    assert (got.events_processed, got.dropped, got.forgets) == (5, 1, 0)
    assert got.steps_done == 4 and ev.as_ints().as_ints() == got
    assert tpipe.run_stream.__defaults__[:3] == (0, None, True)
