"""``StreamSession`` of the port against the JAX package's.

On the CPU, at grid 2 x 2, u_cap 256, i_cap 64, micro-batch 256, for
DISGD, DICS and BPR-MF (port backend ``cuda`` on CPU tensors against JAX
``pallas``): two ``ingest`` calls then ``recommend`` under a sync, an
async and an end-only publish policy, and ``recommend`` before any
``ingest``. Counters, versions, ids and integer state exactly; factors
and DISGD / BPR scores within RTOL 1e-5 / ATOL 1e-5; DICS bit for bit.
Then the port's own contracts: the async policy never changes training,
the final publish drains the backlog, snapshots are copies the next
``ingest`` cannot change, one policy governs both halves, spans and
table bytes land in the session's registry. Checkpoint, restore and
rescale are held to JAX's session in ``tests/test_torch_checkpoint.py``.
"""

import dataclasses
import functools
import json

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro.algos import bpr as jbpr  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import storage as jstorage  # noqa: E402
from repro.core.dics import DicsHyper as JDics  # noqa: E402
from repro.core.disgd import DisgdHyper as JDisgd  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro_torch.core import convert, storage  # noqa: E402
from repro_torch.data.stream import (MOVIELENS_25M, NETFLIX, scaled,  # noqa: E402
                                     synth_stream)
from repro_torch.obs import trace  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
CAPS = dict(u_cap=256, i_cap=64)
HYPERS = {"disgd": (rt.DisgdHyper, JDisgd), "dics": (rt.DicsHyper, JDics),
          "bpr": (rt.BprHyper, jbpr.BprHyper)}
ALGOS = sorted(HYPERS)
POLICIES = {"sync_2": dict(every=2, mode="sync"),
            "async_2": dict(every=2, mode="async"),
            "end_only": dict()}


@functools.lru_cache(maxsize=None)
def _stream(algo):
    if algo == "dics":
        users, items, _ = synth_stream(scaled(NETFLIX, 0.0015, n_items=128),
                                       seed=0)
    else:
        users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users, items


def _cfgs(algo, **over):
    th, jh = HYPERS[algo]
    t = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2), micro_batch=256,
                        hyper=th(**CAPS), device="cpu", **over)
    j = jpipe.StreamConfig(algorithm=algo, grid=JGrid(2), micro_batch=256,
                           backend="pallas", hyper=jh(**CAPS),
                           telemetry=False, **over)
    return t, j


def _sessions(algo, **policy):
    t_cfg, j_cfg = _cfgs(algo)
    t = rt.StreamSession(t_cfg, serve=rt.ServeConfig.from_stream(
        t_cfg, batch_size=64), publish=rt.PublishPolicy(**policy))
    j = repro.StreamSession(j_cfg, serve=repro.ServeConfig.from_stream(
        j_cfg, batch_size=64), publish=repro.PublishPolicy(**policy))
    return t, j


def _assert_states_match(t_states, j_states, algo):
    got = convert.states_to_numpy(t_states)
    want = convert.flatten_state(jax.tree.map(np.asarray, j_states))
    for name, w in want.items():
        if w.dtype.kind == "f" and algo != "dics":
            np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def _assert_responses_match(got, want, algo, versions=True):
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
    fields = ["cache_hits", "fallbacks", "staleness_events",
              "snapshot_forgets"]
    for f in fields + (["snapshot_version"] if versions else []):
        assert getattr(got, f) == getattr(want, f), f


def _queries(algo):
    users = np.unique(_stream(algo)[0])
    rng = np.random.default_rng(9)
    known = rng.choice(users, 60, replace=False)
    return np.concatenate([known, known[:4], [-1, 10**6]])


def _series(registry, name):
    fam = registry.get(name)
    return sorted((tuple(sorted(lab.items())), inst.value)
                  for lab, inst in fam.series())


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("algo", ALGOS)
def test_ingest_then_recommend_matches_jax(algo, policy):
    users, items = _stream(algo)
    half = users.size // 2
    t, j = _sessions(algo, **POLICIES[policy])
    for lo, hi in ((0, half), (half, users.size)):
        tr = t.ingest(users[lo:hi], items[lo:hi])
        jr = j.ingest(users[lo:hi], items[lo:hi])
        assert (tr.events_processed, tr.dropped) == (jr.events_processed,
                                                     jr.dropped)
    assert t.events_processed == j.events_processed == users.size
    _assert_states_match(t.states, j.states, algo)
    is_async = POLICIES[policy].get("mode", "async") == "async"
    t_stats, j_stats = t.store.stats_snapshot(), j.store.stats_snapshot()
    if is_async:        # how many publishes coalesce is a matter of timing
        for stats in (t_stats, j_stats):
            stats["async_rotations"] += stats.pop("coalesced")
            del stats["rotations"]
    assert t_stats == j_stats
    assert t.store.acquire().events_processed == users.size
    assert t.store.acquire().version == t.store.latest_version
    q = _queries(algo)
    for n in (None, None, 5):
        got, want = t.recommend(q, n=n), j.recommend(q, n=n)
        _assert_responses_match(got, want, algo, versions=not is_async)
        assert got.snapshot_version == t.store.latest_version
    assert got.ids.shape == (q.size, 5) and got.cache_hits == 0
    assert t.frontend.stats_snapshot() == j.frontend.stats_snapshot()
    assert _series(t.metrics, "table_bytes") == _series(j.metrics,
                                                        "table_bytes")


@pytest.mark.parametrize("algo", ALGOS)
def test_recommend_before_ingest_matches_jax(algo):
    """A cold session publishes its zero state: nobody is known and the
    popularity head is empty."""
    t, j = _sessions(algo)
    got, want = t.recommend([3, 5, -1]), j.recommend([3, 5, -1])
    _assert_responses_match(got, want, algo)
    assert not got.known.any() and (got.ids == -1).all()
    assert got.fallbacks == 2 and got.snapshot_version == 1
    assert t.store.stats_snapshot() == j.store.stats_snapshot()


@pytest.mark.parametrize("algo", ALGOS)
def test_state_nbytes_matches_jax(algo):
    t_cfg, j_cfg = _cfgs(algo)
    got = storage.state_nbytes(rt.StreamSession(t_cfg).states)
    assert got == jstorage.state_nbytes(jpipe.init_states(j_cfg))
    assert storage.total_nbytes(rt.StreamSession(t_cfg).states) == sum(
        n for _, n in got.values())


def test_async_policy_never_changes_training_results():
    users, items = _stream("disgd")
    cfg = _cfgs("disgd")[0]
    s = rt.StreamSession(cfg, publish=rt.PublishPolicy(every=1,
                                                       mode="async"))
    res = s.ingest(users, items)
    plain = rt.run_stream(users, items, cfg)
    for a, b in zip(convert.states_to_numpy(s.states).values(),
                    convert.states_to_numpy(plain.final_states).values()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res.recall.bits(), plain.recall.bits())
    stats = s.store.stats_snapshot()
    assert stats["async_rotations"] >= 1
    assert stats["async_rotations"] + stats["coalesced"] == 12  # 10 + 2 drain


def test_ingest_final_publish_drains_async_backlog_first():
    """No flush here: the final synchronous publish drains the backlog
    before rotating, so the front never regresses to a mid-stream copy."""
    users, items = _stream("disgd")
    s = rt.StreamSession(_cfgs("disgd")[0],
                         publish=rt.PublishPolicy(every=1, mode="async"))
    s.ingest(users, items)
    snap = s.store.acquire()
    assert snap.events_processed == users.size
    assert snap.version == s.store.latest_version


def test_snapshots_are_copies_the_next_ingest_cannot_change():
    users, items = _stream("disgd")
    half = users.size // 2
    s = rt.StreamSession(_cfgs("disgd")[0])
    s.ingest(users[:half], items[:half])
    held = s.store.acquire()
    before = convert.states_to_numpy(held.states)
    first = s.recommend(users[:32])
    s.ingest(users[half:], items[half:])
    assert held.states.rated is not s.states.rated
    for name, a in convert.states_to_numpy(held.states).items():
        np.testing.assert_array_equal(a, before[name], err_msg=name)
    assert not np.array_equal(before["rated"],
                              convert.states_to_numpy(s.states)["rated"])
    again = rt.QueryFrontend(_HeldStore(held), s.frontend.cfg).serve(
        users[:32])
    np.testing.assert_array_equal(again.ids, first.ids)


class _HeldStore(rt.SnapshotStore):
    """A store whose front is one held snapshot."""

    def __init__(self, snap):
        super().__init__()
        self._snap = snap

    def acquire(self, max_staleness_events=None):
        return self._snap


def test_session_owns_one_policy_for_ingest_and_serve():
    cfg = _cfgs("disgd")[0]
    policy = rt.PublishPolicy(every=2, mode="sync", max_staleness_events=512)
    s = rt.StreamSession(cfg, publish=policy)
    assert s.publish_policy is policy and s.frontend.cfg.publish is policy
    serve = rt.ServeConfig.from_stream(cfg, publish=policy)
    s = rt.StreamSession(cfg, serve=serve)
    assert s.publish_policy is policy
    assert s.grid == cfg.grid and s.algorithm.name == "disgd"


def test_recommend_n_keeps_the_registry():
    users, items = _stream("disgd")
    s = rt.StreamSession(_cfgs("disgd")[0])
    s.ingest(users[:512], items[:512])
    s.recommend(users[:8])
    resp = s.recommend(users[:8], n=3)
    assert resp.ids.shape == (8, 3) and s.frontend.cfg.top_n == 3
    assert s.metrics.get("serve_queries_total").value == 16


def test_spans_land_in_the_registry():
    users, items = _stream("disgd")
    s = rt.StreamSession(_cfgs("disgd")[0])
    s.ingest(users[:512], items[:512])
    s.recommend(users[:8])
    stages = {lab["stage"] for lab, _ in s.metrics.get(
        "span_seconds").series()}
    assert stages == {"ingest", "publish", "serve"}
    text = s.metrics.to_prometheus()
    assert 'span_seconds_count{stage="ingest"} 1' in text
    assert 'table_bytes{algorithm="disgd",table="rated",dtype="bool"}' in text


def test_span_nesting_and_profile_capture(tmp_path):
    reg = rt.MetricsRegistry()
    assert trace.current_span() == ""
    with trace.profile(str(tmp_path)):
        with trace.span("ingest", reg) as outer:
            with trace.span("publish", reg) as inner:
                assert trace.current_span() == "ingest/publish"
                torch.ones(4).sum()
    assert (outer, inner) == ("ingest", "ingest/publish")
    assert trace.current_span() == ""
    assert reg.get("span_seconds").labels(stage="ingest/publish").count == 1
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"ingest", "ingest/publish"} <= names


def test_public_surface():
    from repro_torch import obs, serve, session
    from repro_torch.core import algorithm

    for name in ("StreamSession", "PublishPolicy", "ServeConfig",
                 "ServeResponse", "QueryFrontend", "SnapshotStore",
                 "StaleSnapshotError", "MetricsRegistry", "ScopedRegistry",
                 "register", "get_algorithm", "registered", "StreamConfig",
                 "run_stream", "grid_topn", "BprHyper"):
        assert name in rt.__all__ and hasattr(rt, name), name
    assert rt.StreamSession is session.StreamSession
    assert rt.SnapshotStore is serve.SnapshotStore
    assert rt.MetricsRegistry is obs.MetricsRegistry
    assert rt.registered() == algorithm.registered() == ("bpr", "dics",
                                                         "disgd")
    assert set(serve.__all__) == set(repro.serve.__all__) - {
        "AutoscalePolicy", "Autoscaler", "balanced_grid"}
    assert rt.StreamSession.__init__.__kwdefaults__ == {
        "serve": None, "publish": None, "snapshot_slots": 2, "metrics": None}
    assert ([f.name for f in dataclasses.fields(rt.ServeConfig)]
            == [f.name for f in dataclasses.fields(repro.ServeConfig)])
