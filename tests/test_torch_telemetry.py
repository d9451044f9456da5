"""The loop telemetry of the PyTorch port against the JAX package.

Mirrors ``tests/test_obs.py:181-253`` across the two packages, on the
CPU at ``GridSpec(2)``, micro-batch 256, u_cap 128, i_cap 32:

  * the telemetry vector with forgetting and re-queue (2,400 events of
    ``synth_stream(scaled(MOVIELENS_25M, 0.002))``, LRU every 300 events,
    buckets at 1.2x the fair share) on every port backend against the
    JAX backend it is held to, and ``host`` equal to ``scan``: exactly;
  * the precision@N head (``StreamResult.precision``) equal to JAX's
    ``precision_at_n``; ``telemetry=False`` gives ``None`` and the same
    training;
  * ``effective_list_len`` and ``storage.gather_rated`` (dense and
    packed) on seeded states;
  * publish events of an adaptive DICS stream carry the detector and the
    telemetry vector equal to JAX's events, in sync and async mode;
  * ``TelemetryFolder`` folds the same vectors into the same registry
    text; a ``StreamSession`` (adaptive DICS, sync publishing) has JAX's
    registry text after two ``ingest`` calls (span timings aside), and
    its detector, threaded across them, equals one call's.
"""

import dataclasses
import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro_torch as rt  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core import forgetting as jforget  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import storage as jstorage  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro_torch.core import convert, forgetting, storage  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.obs.telemetry import telemetry_ints  # noqa: E402
from tests.test_torch_drift import _cfgs as _drift_cfgs  # noqa: E402
from tests.test_torch_drift import _scenario  # noqa: E402
from tests.test_torch_forgetting import (  # noqa: E402
    HYPERS, _jax_state, _random_state)

CAPS = dict(u_cap=128, i_cap=32)
BACKENDS = [("scan", "scan"), ("cuda", "pallas"), ("host", "host")]
LRU = dict(policy="lru", trigger_every=300, lru_max_age=200)


@functools.lru_cache(maxsize=None)
def _stream(n):
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:n], items[:n]


def _cfgs(backend_t, backend_j, forget=None, **over):
    forget = forget or dict(policy="none")
    t = rt.StreamConfig(grid=rt.GridSpec(2), micro_batch=256,
                        backend=backend_t, hyper=rt.DisgdHyper(**CAPS),
                        device="cpu",
                        forgetting=forgetting.ForgettingConfig(**forget),
                        **over)
    j = jpipe.StreamConfig(grid=JGrid(2), micro_batch=256, backend=backend_j,
                           hyper=repro.DisgdHyper(**CAPS),
                           forgetting=jforget.ForgettingConfig(**forget),
                           **over)
    return t, j


@functools.lru_cache(maxsize=None)
def _requeue_runs(backend):
    """(port, JAX) results with forgetting and re-queue on one backend
    pair."""
    users, items = _stream(2400)
    t_cfg, j_cfg = _cfgs(backend, dict(BACKENDS)[backend], forget=LRU,
                         capacity_factor=1.2)
    return rt.run_stream(users, items, t_cfg), jpipe.run_stream(
        users, items, j_cfg)


@pytest.mark.parametrize("backend", [b[0] for b in BACKENDS])
def test_telemetry_matches_jax_with_forgetting_and_requeue(backend):
    tr, jr = _requeue_runs(backend)
    assert tr.dropped == jr.dropped == 0
    got = telemetry_ints(tr.telemetry)
    assert got == telemetry_ints(jr.telemetry)
    assert got["evictions"] > 0 and got["requeued"] > 0
    assert got["events"] == tr.events_processed == 2400
    assert tr.forgets == jr.forgets == 8
    assert isinstance(tr.telemetry, tobs.TelemetryState)
    assert all(isinstance(x, np.ndarray) for x in tr.telemetry)


def test_host_and_scan_fold_the_same_vector():
    """JAX's contract (``test_obs.py:199``): the two loops fold equal
    vectors whenever nothing is dropped."""
    assert telemetry_ints(_requeue_runs("host")[0].telemetry) == (
        telemetry_ints(_requeue_runs("scan")[0].telemetry))


def test_precision_head_matches_jax():
    tr, jr = _requeue_runs("cuda")
    tel = telemetry_ints(tr.telemetry)
    assert 0 < tr.precision < 1 and tel["hits"] <= tel["list_len"]
    assert tr.precision == tr.precision_at_n == jr.precision_at_n
    assert tr.precision == tel["hits"] / tel["list_len"]
    assert tel["evals"] == int((~np.isnan(tr.recall.bits())).sum())
    assert tel["hits"] == int(np.nansum(tr.recall.bits()))


def test_telemetry_off_yields_none_and_identical_training():
    users, items = _stream(600)
    cfg = _cfgs("cuda", "pallas", forget=LRU)[0]
    on = rt.run_stream(users, items, cfg)
    off = rt.run_stream(users, items, dataclasses.replace(cfg,
                                                          telemetry=False))
    assert on.telemetry is not None and off.telemetry is None
    assert np.isnan(off.precision)
    np.testing.assert_array_equal(on.recall.bits(), off.recall.bits())
    for a, b in zip(on.final_states.tables + on.final_states[1:],
                    off.final_states.tables + off.final_states[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("algo", sorted(HYPERS))
def test_effective_list_len_and_gather_rated_match_jax(algo):
    flat = _random_state(algo, seed=5, n_w=4, u_cap=12, i_cap=10)
    rng = np.random.default_rng(6)
    ev_u = rng.integers(-1, 40, (4, 9)).astype(np.int32)
    ev_u[:, :3] = flat["user_ids"][:, :3]          # some known users
    state = convert.states_from_numpy(flat, device="cpu")
    for top_n in (1, 3, 10):
        got = tobs.effective_list_len(state, torch.as_tensor(ev_u),
                                      top_n=top_n, g=2)
        want = jobs.effective_list_len(_jax_state(flat), jnp.asarray(ev_u),
                                       top_n=top_n, g=2,
                                       storage=jstorage.StoragePolicy())
        assert got.dtype == torch.int32 and int(got) == int(want) > 0
    slots = np.abs(ev_u) % 12
    np.testing.assert_array_equal(
        storage.gather_rated(state.rated, torch.as_tensor(slots)).numpy(),
        np.stack([np.asarray(jstorage.gather_rated(
            jnp.asarray(flat["rated"][w]), slots[w], jstorage.StoragePolicy(),
            10)) for w in range(4)]))
    # Under a packed policy: the gathered words, unpacked, equal JAX's.
    packed = storage.pack_bits(state.rated)
    np.testing.assert_array_equal(
        storage.gather_rated(packed, torch.as_tensor(slots),
                             rt.StoragePolicy(rated="packed"), 10).numpy(),
        np.stack([np.asarray(jstorage.gather_rated(
            jstorage.pack_bits(jnp.asarray(flat["rated"][w])), slots[w],
            jstorage.StoragePolicy(rated="packed"), 10)) for w in range(4)]))


@functools.lru_cache(maxsize=None)
def _jax_events(backend_j):
    users, items = _scenario()
    events = []
    jpipe.run_stream(users, items, _drift_cfgs("dics", "scan", backend_j)[1],
                     publish_every=4, on_publish=events.append)
    return events


# The host loop is synchronous by construction: no async case.
@pytest.mark.parametrize("backends,sync", [
    (("scan", "scan"), True), (("scan", "scan"), False),
    (("cuda", "pallas"), True), (("cuda", "pallas"), False),
    (("host", "host"), True)],
    ids=["scan-sync", "scan-async", "cuda-sync", "cuda-async", "host-sync"])
def test_publish_events_carry_detector_and_telemetry(backends, sync):
    users, items = _scenario()
    events = []
    rt.run_stream(users, items, _drift_cfgs("dics", *backends)[0],
                  publish_every=4, on_publish=events.append,
                  publish_sync=sync)
    want = _jax_events(backends[1])
    assert len(events) == len(want) >= 3
    fired = 0
    for got, exp in zip(events, want):
        assert torch.is_tensor(got.detector.fired)
        for f, a, b in zip(got.detector._fields, got.detector, exp.detector):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
        assert telemetry_ints(got.telemetry) == telemetry_ints(exp.telemetry)
        resolved = got.as_ints()
        assert (resolved.forgets, resolved.events_processed) == (
            exp.forgets, exp.events_processed)
        assert isinstance(resolved.telemetry.events, np.ndarray)
        fired = int(got.detector.fires)
    assert fired >= 1


def _prom(registry):
    """Prometheus text without the wall-clock span histograms."""
    return [line for line in registry.to_prometheus().splitlines()
            if "span_seconds" not in line]


def test_telemetry_folder_matches_jax():
    users, items = _stream(1200)
    t_cfg, j_cfg = _cfgs("cuda", "pallas", forget=LRU)
    t_events, j_events = [], []
    rt.run_stream(users, items, t_cfg, publish_every=2,
                  on_publish=t_events.append)
    jpipe.run_stream(users, items, j_cfg, publish_every=2,
                     on_publish=j_events.append)
    t_reg, j_reg = tobs.MetricsRegistry(), jobs.MetricsRegistry()
    t_fold, j_fold = tobs.TelemetryFolder(t_reg), jobs.TelemetryFolder(j_reg)
    t_fold.set_capacity(160)
    j_fold.set_capacity(160)
    # A first segment folded at every boundary, a second one (rebased)
    # folded only at its last: the counters add up the same way.
    for fold, evs in ((t_fold, t_events), (j_fold, j_events)):
        for ev in evs:
            fold.fold(ev.telemetry)
        fold.rebase()
        fold.fold(evs[-1].telemetry)
        assert fold.fold(None) is None
    assert _prom(t_reg) == _prom(j_reg)
    assert t_reg.counter("stream_events_total").value == 2 * 1200


def _sessions(**policy):
    t_cfg, j_cfg = _drift_cfgs("dics", "cuda", "pallas")
    publish = {"every": 4, "mode": "sync", **policy}
    return (rt.StreamSession(t_cfg, publish=rt.PublishPolicy(**publish)),
            repro.StreamSession(j_cfg, publish=repro.PublishPolicy(**publish)))


def test_session_registry_and_detector_match_jax():
    users, items = _scenario()
    half = 256 * 6
    t, j = _sessions()
    for lo, hi in ((0, half), (half, users.size)):
        tr = t.ingest(users[lo:hi], items[lo:hi])
        jr = j.ingest(users[lo:hi], items[lo:hi])
        np.testing.assert_array_equal(tr.drift_flags, jr.drift_flags)
    assert _prom(t.metrics) == _prom(j.metrics)
    assert t.metrics.counter("stream_events_total").value == users.size
    assert t.forgets == j.forgets >= 1
    one = rt.run_stream(users, items, t.cfg)
    assert one.telemetry.requeued == 0      # the halves batch as one call
    for f, a, b, c in zip(one.final_detector._fields, t._detector,
                          j._detector, one.final_detector):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
        np.testing.assert_array_equal(a, c, err_msg=f)


def test_async_session_folds_the_same_counters():
    users, items = _scenario()
    t_sync, _ = _sessions()
    t_async, _ = _sessions(mode="async")
    for s in (t_sync, t_async):
        s.ingest(users, items)
    for name in ("stream_events_total", "stream_evictions_total",
                 "stream_recall_hits_total", "stream_list_len_total"):
        assert (t_async.metrics.counter(name).value
                == t_sync.metrics.counter(name).value > 0), name


def test_public_names_match_jax():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    assert tobs.TelemetryState._fields == jobs.TelemetryState._fields
    assert tobs.HOST_CARRY_CAP == jobs.HOST_CARRY_CAP
    assert rt.StreamResult.precision_at_n is rt.StreamResult.precision
