"""The drift runtime of the PyTorch port against the JAX package.

  * every scenario of ``drift.scenarios`` at two seeds: users, items,
    timestamps and drift points bit for bit;
  * ``detector_update`` on stable recall, a collapse, empty batches and
    under warm-up: all ten fields equal JAX's bit for bit (the flags
    exactly; the float scalars too, where XLA's fused multiply-adds are
    reproduced, ``drift/detector.py``);
  * the controller: an eviction pass on a firing, the boost window's
    decay, then nothing, against ``repro.drift.make_controller``; and the
    device loop's ``live`` gate;
  * ``recovery_report`` on the same bits;
  * ``run_stream`` under an adaptive policy (detector warm-up 512, drop
    0.1, CUSUM 0.1, a boost window of 3) for DISGD, BPR-MF and DICS on
    every port backend against the JAX backend it is held to, on
    ``make_scenario("abrupt", events=6144, seed=0)`` (2,922 events) at
    ``GridSpec(2)``, micro-batch 256, u_cap 256, i_cap 64, where JAX's
    detector fires (asserted): flags, ``forgets``, the final detector,
    recall bits and the telemetry vector exactly; states as
    ``test_torch_forgetting.py`` holds them;
  * ``initial_detector`` resumes a run: two halves equal one run.
"""

import dataclasses
import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.drift as jdrift  # noqa: E402
import repro_torch as rt  # noqa: E402
import repro_torch.drift as tdrift  # noqa: E402
from repro.core import forgetting as jforget  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import forgetting  # noqa: E402
from tests.test_torch_forgetting import (  # noqa: E402
    HYPERS, _flat, _jax_state, _random_state, assert_stream_matches)

ALGOS = sorted(HYPERS)
BACKENDS = [("scan", "scan"), ("cuda", "pallas"), ("host", "host")]
CAPS = dict(u_cap=256, i_cap=64)
DETECTOR = dict(warmup=512, drop_frac=0.1, ph_lambda=0.1)


def _policies(**over):
    det = dict(DETECTOR, **over.pop("detector", {}))
    kw = dict(boost_batches=3, **over)
    return (tdrift.DriftPolicy(detector=tdrift.DetectorConfig(**det), **kw),
            jdrift.DriftPolicy(detector=jdrift.DetectorConfig(**det), **kw))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", jdrift.list_scenarios())
def test_scenarios_bit_identical_to_jax(name, seed):
    assert tdrift.list_scenarios() == jdrift.list_scenarios()
    got = tdrift.make_scenario(name, events=4096, seed=seed)
    want = jdrift.make_scenario(name, events=4096, seed=seed)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert (dataclasses.asdict(tdrift.DEFAULT_PROFILE)
            == dataclasses.asdict(jdrift.DEFAULT_PROFILE))


def test_unknown_scenario_raises():
    with pytest.raises(ValueError, match="unknown scenario"):
        tdrift.make_scenario("sideways")


def _recall_batches(rng, n_batches):
    """(hits, evaluated) a batch: stable recall, a collapse, empty
    batches and partly evaluated ones."""
    out = []
    for t in range(n_batches):
        p = 0.4 if t < 40 or t > 70 else 0.08
        ev = (np.zeros(256, bool) if t % 13 == 5
              else rng.random(256) < rng.uniform(0.4, 1.0))
        out.append((rng.random(256) < p, ev))
    return out


@pytest.mark.parametrize("cfg", [dict(warmup=1024), dict(warmup=30_000),
                                 dict(warmup=256, cooldown=2,
                                      ph_lambda=0.05)],
                         ids=["default", "warmup_blocks", "eager"])
def test_detector_update_matches_jax(cfg):
    rng = np.random.default_rng(len(str(cfg)))
    t_cfg, j_cfg = tdrift.DetectorConfig(**cfg), jdrift.DetectorConfig(**cfg)
    upd = jax.jit(jdrift.detector_update, static_argnums=3)
    t_det, j_det = tdrift.detector_init("cpu"), jdrift.detector_init()
    fires = []
    for hits, ev in _recall_batches(rng, 120):
        t_det = tdrift.detector_update(t_det, torch.as_tensor(hits),
                                       torch.as_tensor(ev), t_cfg)
        j_det = upd(j_det, jnp.asarray(hits), jnp.asarray(ev), j_cfg)
        for f, a, b in zip(t_det._fields, t_det, j_det):
            assert a.dtype == getattr(torch, str(b.dtype)), f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
        fires.append(bool(t_det.fired))
        if not ev.any():                    # an empty batch changes nothing
            assert not fires[-1]
    if cfg["warmup"] == 30_000:
        assert not any(fires)
    else:
        assert sum(fires) >= 1              # the collapse fires
        np.testing.assert_allclose(float(t_det.fast_mean),
                                   float(j_det.fast_mean), rtol=1e-6)


def _populated(n_c=2, u_cap=8, i_cap=8, k=4):
    """JAX's ``test_drift._populated_grid``: half of each table stale."""
    flat = _random_state("disgd", 0, n_w=n_c, u_cap=u_cap, i_cap=i_cap, k=k)
    flat.update(
        user_ids=np.tile(np.arange(u_cap, dtype=np.int32), (n_c, 1)),
        item_ids=np.tile(np.arange(i_cap, dtype=np.int32), (n_c, 1)),
        user_ts=np.tile(np.asarray([1, 2, 3, 4, 97, 98, 99, 100], np.int32),
                        (n_c, 1)),
        item_ts=np.tile(np.asarray([100, 99, 98, 97, 4, 3, 2, 1], np.int32),
                        (n_c, 1)),
        clock=np.full(n_c, 100, np.int32))
    return flat


def test_controller_evicts_boosts_then_relaxes_as_jax():
    kw = dict(boost_batches=2, boost_gamma=0.5)
    t_step = tdrift.make_controller(tdrift.DriftPolicy(
        eviction=forgetting.ForgettingConfig(policy="lru", lru_max_age=50),
        **kw))
    j_step = jdrift.make_controller(jdrift.DriftPolicy(
        eviction=jforget.ForgettingConfig(policy="lru", lru_max_age=50),
        **kw))
    flat = _populated()
    t_states = convert.states_from_numpy(flat, device="cpu")
    j_states = _jax_state(flat)
    t_boost, j_boost = tdrift.controller_init("cpu"), jdrift.controller_init()
    # No fire, then a fire, then two more steps: identity, evict + decay,
    # decay, relaxed.
    for fired in (False, True, False, False):
        t_states, t_boost = t_step(t_states, torch.tensor(fired), t_boost)
        j_states, j_boost = j_step(j_states, jnp.asarray(fired), j_boost)
        assert int(t_boost) == int(j_boost)
        got = convert.states_to_numpy(t_states)
        for name, w in _flat(j_states).items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    uids = convert.states_to_numpy(t_states)["user_ids"][0]
    assert (uids >= 0).tolist() == [False] * 4 + [True] * 4


def test_controller_live_gate_freezes_a_step_without_events():
    """JAX's engine skips a step without events: neither pass runs and
    the boost window does not advance."""
    pol = tdrift.DriftPolicy(boost_batches=2, boost_gamma=0.5)
    step = tdrift.make_controller(pol)
    flat = _populated()
    states = convert.states_from_numpy(flat, device="cpu")
    states, boost = step(states, torch.tensor(True),
                         torch.tensor(0, dtype=torch.int32),
                         live=torch.tensor(False))
    assert int(boost) == 0
    for name, a in convert.states_to_numpy(states).items():
        np.testing.assert_array_equal(a, flat[name], err_msg=name)
    states, boost = step(states, torch.tensor(False),
                         torch.tensor(2, dtype=torch.int32),
                         live=torch.tensor(False))
    assert int(boost) == 2
    np.testing.assert_array_equal(states.user_vecs.numpy(),
                                  flat["user_vecs"])


def test_recovery_report_matches_jax():
    rng = np.random.default_rng(3)
    bits = (rng.random(6000) < np.where(np.arange(6000) < 3000, 0.3, 0.1)
            ).astype(np.float64)
    bits[np.arange(6000) > 3600] = rng.random(2399) < 0.3
    bits[rng.random(6000) < 0.1] = np.nan
    for kw in (dict(), dict(window=200, frac=0.9), dict(dip_horizon=500)):
        for drift in (0, 2700, 5900, 10_000):
            got = tdrift.recovery_report(bits, drift, **kw)
            want = jdrift.recovery_report(bits, drift, **kw)
            assert dataclasses.asdict(got) == pytest.approx(
                dataclasses.asdict(want), nan_ok=True)
            assert got.recovery_or_censored == want.recovery_or_censored
    assert tdrift.recovery_report(np.full(8, np.nan), 3).horizon == 0


@functools.lru_cache(maxsize=None)
def _scenario():
    sc = tdrift.make_scenario("abrupt", events=6144, seed=0)
    return sc.users, sc.items


def _cfgs(algo, backend_t, backend_j):
    th, jh = HYPERS[algo]
    t_pol, j_pol = _policies()
    t = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2), micro_batch=256,
                        backend=backend_t, hyper=th(**CAPS), device="cpu",
                        drift=t_pol)
    j = jpipe.StreamConfig(algorithm=algo, grid=JGrid(2), micro_batch=256,
                           backend=backend_j, hyper=jh(**CAPS), drift=j_pol)
    return t, j


@pytest.mark.parametrize("backends", BACKENDS, ids=[b[0] for b in BACKENDS])
@pytest.mark.parametrize("algo", ALGOS)
def test_adaptive_run_stream_matches_jax(algo, backends):
    users, items = _scenario()
    t_cfg, j_cfg = _cfgs(algo, *backends)
    tr = rt.run_stream(users, items, t_cfg)
    jr = jpipe.run_stream(users, items, j_cfg)
    assert int(np.sum(jr.drift_flags)) >= 1        # not vacuous
    np.testing.assert_array_equal(tr.drift_flags, jr.drift_flags)
    assert tr.drift_flags.dtype == np.int32
    assert tr.forgets == int(np.sum(tr.drift_flags))
    for f, a, b in zip(tr.final_detector._fields, tr.final_detector,
                       jr.final_detector):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert_stream_matches(tr, jr, algo)
    assert tr.telemetry.evictions > 0


def test_initial_detector_resumes_the_stream():
    """Two halves with the detector (and states) handed over equal one
    run: the split is at a micro-batch boundary and nothing re-queues."""
    users, items = _scenario()
    cfg, _ = _cfgs("dics", "cuda", "pallas")
    whole = rt.run_stream(users, items, cfg)
    assert whole.telemetry.requeued == 0
    half = 256 * 6
    a = rt.run_stream(users[:half], items[:half], cfg)
    b = rt.run_stream(users[half:], items[half:], cfg,
                      initial_states=a.final_states,
                      initial_detector=a.final_detector)
    np.testing.assert_array_equal(
        np.concatenate([a.drift_flags, b.drift_flags]), whole.drift_flags)
    for f, x, y in zip(whole.final_detector._fields, b.final_detector,
                       whole.final_detector):
        np.testing.assert_array_equal(x, y, err_msg=f)
    for x, y in zip(convert.states_to_numpy(b.final_states).values(),
                    convert.states_to_numpy(whole.final_states).values()):
        np.testing.assert_array_equal(x, y)


def test_drift_policy_none_keeps_the_fixed_cadence():
    users, items = (x[:1024] for x in _scenario())
    t_cfg = _cfgs("disgd", "cuda", "pallas")[0]
    fixed = dict(forgetting=forgetting.ForgettingConfig(
        policy="lru", trigger_every=400, lru_max_age=100))
    a = rt.run_stream(users, items, dataclasses.replace(
        t_cfg, drift=tdrift.DriftPolicy(mode="none"), **fixed))
    b = rt.run_stream(users, items, dataclasses.replace(t_cfg, drift=None,
                                                        **fixed))
    assert a.drift_flags is None and a.final_detector is None
    assert a.forgets == b.forgets == 2


def test_public_names_match_jax():
    assert sorted(tdrift.__all__) == sorted(jdrift.__all__)
    assert tdrift.DriftPolicy._fields == jdrift.DriftPolicy._fields
    assert tdrift.DetectorConfig() == tuple(jdrift.DetectorConfig())
    assert tdrift.DetectorState._fields == jdrift.DetectorState._fields
    assert (tuple(tdrift.DriftPolicy().eviction)
            == tuple(jdrift.DriftPolicy().eviction))
    assert forgetting.ForgettingConfig._fields == (
        jforget.ForgettingConfig._fields)
    assert rt.ForgettingConfig is forgetting.ForgettingConfig
    assert rt.DriftPolicy is tdrift.DriftPolicy
