"""The mixed-load service harness of the PyTorch port against JAX's.

  * ``LoadConfig`` / ``QueryLoad`` (every arrival mode, unknown users,
    Zipf skew) and ``mixed_schedule``: for a seed, the same batches, gaps
    and schedules as the JAX package's, bit for bit, and the same
    validation errors;
  * ``run_service`` in ``interleaved`` mode (DISGD, ``GridSpec(2)``,
    micro-batch 128, sync and async publishing every 2) on the first 1,536
    events of ``synth_stream(scaled(MOVIELENS_25M, 0.002))``: the states
    equal a straight ingest of the same events, and JAX's interleaved run
    (the states; staleness, forgets, cache hits and fallbacks of every
    query batch; snapshot versions under sync publishing, since how many
    async publishes coalesce is a matter of timing); the summary has
    JAX's keys;
  * ``threaded`` mode overlaps ingest and queries (versions never go
    back), restores the switch interval, and re-raises a crash of the
    trainer thread;
  * ``ServiceReport.summary()`` from the per-run histograms equals the
    inline percentiles over the same records.
"""

import dataclasses
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro.serve import loadgen as jload  # noqa: E402
from repro.serve import service as jservice  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.serve import loadgen as tload  # noqa: E402
from repro_torch.serve import service as tservice  # noqa: E402
from tests.test_torch_ensemble import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-5
LOADS = {
    "poisson": dict(n_users=200, seed=42, query_batch=8),
    "bursty": dict(n_users=200, seed=42, query_batch=8, arrival="bursty",
                   burst_factor=50.0, burst_len=30, quiet_len=30),
    "closed_cold": dict(n_users=64, seed=1, unknown_frac=1.0,
                        arrival="closed"),
    "skewed_known": dict(n_users=50, seed=0, query_batch=16, zipf_a=1.2,
                         unknown_frac=0.0),
}


def _stream(n=1536):
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:n], items[:n]


def _cfgs(micro_batch=128):
    th = rt.DisgdHyper(u_cap=512, i_cap=128)
    jh = repro.DisgdHyper(u_cap=512, i_cap=128)
    return (rt.StreamConfig(grid=rt.GridSpec(2), micro_batch=micro_batch,
                            hyper=th, backend="scan", device="cpu"),
            jpipe.StreamConfig(grid=JGrid(2), micro_batch=micro_batch,
                               hyper=jh, backend="scan"))


@pytest.mark.parametrize("load", sorted(LOADS))
def test_loadgen_trace_matches_jax(load):
    t = tload.QueryLoad(tload.LoadConfig(**LOADS[load]))
    j = jload.QueryLoad(jload.LoadConfig(**LOADS[load]))
    for (tb, tg), (jb, jg) in zip(t.batches(300), j.batches(300)):
        assert tb.dtype == jb.dtype
        np.testing.assert_array_equal(tb, jb)
        assert tg == jg
    # The same trace again from a fresh generator.
    again = tload.QueryLoad(tload.LoadConfig(**LOADS[load]))
    fresh = tload.QueryLoad(tload.LoadConfig(**LOADS[load]))
    for (a, ga), (b, gb) in zip(again.batches(20), fresh.batches(20)):
        np.testing.assert_array_equal(a, b)
        assert ga == gb


@pytest.mark.parametrize("kw, match", [
    (dict(arrival="fractal"), "arrival"),
    (dict(n_users=0), "positive"),
    (dict(unknown_frac=1.5), "unknown_frac"),
    (dict(rate_qps=0.0), "rate_qps"),
])
def test_load_config_errors_match_jax(kw, match):
    for cls in (tload.LoadConfig, jload.LoadConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


@pytest.mark.parametrize("args", [(1000, 6, 256, 0), (1536, 6, 256, 3),
                                  (0, 4, 64, 1), (5000, 0, 512, 0),
                                  (131_072, 64, 2048, 0)])
def test_mixed_schedule_matches_jax(args):
    n, q, chunk, seed = args
    got = tload.mixed_schedule(n, q, events_per_chunk=chunk, seed=seed)
    assert got == jload.mixed_schedule(n, q, events_per_chunk=chunk,
                                       seed=seed)
    assert sum(k for op, k in got if op == "ingest") == n
    assert sum(1 for op, _ in got if op == "query") == q


@pytest.mark.parametrize("publish", ["sync", "async"])
def test_interleaved_run_matches_straight_ingest_and_jax(publish):
    users, items = _stream()
    t_cfg, j_cfg = _cfgs()
    load = dict(n_users=int(users.max()) + 1, seed=5, query_batch=8)
    svc = dict(mode="interleaved", events_per_chunk=256, query_batches=6)
    policy = dict(every=2, mode=publish)
    t = rt.StreamSession(t_cfg, publish=rt.PublishPolicy(**policy))
    j = repro.StreamSession(j_cfg, publish=repro.PublishPolicy(**policy))
    tr = tservice.run_service(t, users, items, tload.LoadConfig(**load),
                              tservice.ServiceConfig(**svc))
    jr = jservice.run_service(j, users, items, jload.LoadConfig(**load),
                              jservice.ServiceConfig(**svc))
    # Queries change no state: a straight ingest ends at the same states.
    straight = rt.StreamSession(t_cfg)
    straight.ingest(users, items)
    for name, a in convert.states_to_numpy(t.states).items():
        np.testing.assert_array_equal(
            a, convert.states_to_numpy(straight.states)[name], err_msg=name)
    want = convert.flatten_state(jax.tree.map(np.asarray, j.states))
    for name, a in convert.states_to_numpy(t.states).items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, want[name], rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(a, want[name], err_msg=name)
    assert len(tr.records) == len(jr.records) == 6
    for a, b in zip(tr.records, jr.records):
        assert (a.staleness_events, a.snapshot_forgets, a.cache_hits,
                a.fallbacks, a.under_load) == (
            b.staleness_events, b.snapshot_forgets, b.cache_hits,
            b.fallbacks, b.under_load)
        if publish == "sync":
            assert a.snapshot_version == b.snapshot_version
        assert a.latency_s > 0
    assert (tr.events_processed, tr.queries) == (jr.events_processed,
                                                 jr.queries)
    ts, js = tr.summary(), jr.summary()
    assert ts.keys() == js.keys()
    timed = {"wall_s", "combined_ops_per_s", "ingest_events_per_s",
             "p50_ms", "p99_ms", "max_ms", "rotation_batch_p99_ms",
             "steady_batch_p99_ms", "eviction_batch_max_ms", "coalesced",
             "async_rotations"}
    for key in ts.keys() - timed:
        assert ts[key] == js[key], key


def test_summary_histograms_equal_inline_percentiles():
    users, items = _stream(1024)
    t = rt.StreamSession(_cfgs()[0], publish=rt.PublishPolicy(every=1))
    report = tservice.run_service(
        t, users, items,
        tload.LoadConfig(n_users=int(users.max()) + 1, seed=2, query_batch=4),
        tservice.ServiceConfig(events_per_chunk=128, query_batches=12))
    inline = dataclasses.replace(report, metrics=None).summary()
    assert report.summary() == inline


def test_threaded_run_overlaps_ingest_and_queries():
    users, items = _stream(2048)
    s = rt.StreamSession(_cfgs()[0],
                         publish=rt.PublishPolicy(every=2, mode="async"))
    s.ingest(users[:256], items[:256])
    s.recommend(np.unique(users)[:8])
    switch = sys.getswitchinterval()
    report = tservice.run_service(
        s, users[256:], items[256:],
        tload.LoadConfig(n_users=int(users.max()) + 1, seed=6,
                         query_batch=8, arrival="closed"),
        tservice.ServiceConfig(mode="threaded", query_batches=10))
    assert sys.getswitchinterval() == switch
    assert report.events_processed == users.size - 256
    assert len(report.records) >= 10
    assert s.events_processed == users.size
    summary = report.summary()
    assert summary["p99_ms"] >= summary["p50_ms"] > 0
    versions = [r.snapshot_version for r in report.records]
    assert versions == sorted(versions)


def test_threaded_run_surfaces_ingest_crash():
    users, items = _stream(512)
    s = rt.StreamSession(_cfgs()[0])
    s.ingest(users[:256], items[:256])
    switch = sys.getswitchinterval()

    def boom(*a, **k):
        raise RuntimeError("ingest exploded")

    s.ingest = boom
    with pytest.raises(RuntimeError, match="ingest exploded"):
        tservice.run_service(
            s, users[256:], items[256:],
            tload.LoadConfig(n_users=int(users.max()) + 1, seed=7,
                             query_batch=4, arrival="closed"),
            tservice.ServiceConfig(mode="threaded", query_batches=2))
    assert sys.getswitchinterval() == switch


def test_service_config_errors_match_jax():
    for cls in (tservice.ServiceConfig, jservice.ServiceConfig):
        with pytest.raises(ValueError, match="mode"):
            cls(mode="quantum")
        with pytest.raises(ValueError):
            cls(events_per_chunk=0)
