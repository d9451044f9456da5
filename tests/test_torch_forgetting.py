"""Forgetting of the PyTorch port against the JAX package.

  * ``apply_forgetting`` (``lru``, ``lfu``, ``gradual``, ``none``) on
    seeded random stacked states of DISGD, BPR-MF (DISGD's state) and
    DICS, ungated and with the loop's device gate true and false, against
    ``jax.vmap(repro.core.forgetting.apply_forgetting)``: exact, factor
    and co-count floats included (the same elementwise products);
  * ``evict_to_budget`` (``lru``, ``lfu``) at budgets 0, 1, 3 and more
    than live, on tables with ties at the threshold: exact;
  * ``run_stream`` under each policy for DISGD, BPR-MF and DICS on every
    port backend against the JAX backend it is held to (``scan`` /
    ``scan``, ``cuda`` / ``pallas``, ``host`` / ``host``), on the first
    1,024 events of ``synth_stream(scaled(MOVIELENS_25M, 0.002))``
    (DISGD, BPR) or ``synth_stream(scaled(NETFLIX, 0.0015,
    n_items=128))`` (DICS) at ``GridSpec(2)``, micro-batch 256, u_cap
    128, i_cap 32 (slots collide), a pass every 400 events, telemetry
    on in both packages:
    recall bits, ``forgets``, the occupancy history, the loads and the
    telemetry vector exactly; final states exactly but for DISGD / BPR
    factor vectors (RTOL 1e-5, ATOL 1e-5, ``test_torch_pipeline.py``'s
    tolerance); DICS ``co`` / ``item_cnt`` exactly, decayed floats
    under ``gradual`` too;
  * a cadence that is not a multiple of the micro-batch (256 against
    ``trigger_every`` 600): ``forgets == floor(processed / 600)`` on
    every backend, as in JAX.
"""

import dataclasses
import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.algos import bpr as jbpr  # noqa: E402
from repro.core import forgetting as jforget  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.dics import DicsHyper as JDics  # noqa: E402
from repro.core.disgd import DisgdHyper as JDisgd  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import forgetting  # noqa: E402
from repro_torch.data.stream import (MOVIELENS_25M, NETFLIX, scaled,  # noqa: E402
                                     synth_stream)
from repro_torch.obs.telemetry import telemetry_ints  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
CAPS = dict(u_cap=128, i_cap=32)
HYPERS = {"disgd": (rt.DisgdHyper, JDisgd), "dics": (rt.DicsHyper, JDics),
          "bpr": (rt.BprHyper, jbpr.BprHyper)}
ALGOS = sorted(HYPERS)
BACKENDS = [("scan", "scan"), ("cuda", "pallas"), ("host", "host")]
N_EVENTS = 1024
POLICIES = {
    "lru": dict(policy="lru", trigger_every=400, lru_max_age=150),
    "lfu": dict(policy="lfu", trigger_every=400, lfu_min_freq=2),
    "gradual": dict(policy="gradual", trigger_every=400, gradual_gamma=0.9),
}


def _random_state(algo, seed, n_w=2, u_cap=12, i_cap=10, k=4):
    """A seeded stacked state: some slots empty, the rest with random
    frequencies and timestamps below each worker's clock."""
    rng = np.random.default_rng(seed)

    def ids(n):
        x = rng.integers(0, 1000, (n_w, n)).astype(np.int32)
        x[rng.random((n_w, n)) < 0.25] = -1
        return x

    flat = dict(user_ids=ids(u_cap), item_ids=ids(i_cap),
                user_freq=rng.integers(1, 4, (n_w, u_cap)).astype(np.int32),
                item_freq=rng.integers(1, 4, (n_w, i_cap)).astype(np.int32),
                user_ts=rng.integers(0, 500, (n_w, u_cap)).astype(np.int32),
                item_ts=rng.integers(0, 500, (n_w, i_cap)).astype(np.int32),
                clock=np.full(n_w, 500, np.int32),
                rated=rng.random((n_w, u_cap, i_cap)) < 0.4)
    if algo == "dics":
        co = rng.integers(0, 6, (n_w, i_cap, i_cap)).astype(np.float32)
        flat.update(co=co + co.transpose(0, 2, 1),
                    item_cnt=rng.integers(0, 9, (n_w, i_cap)).astype(
                        np.float32))
    else:
        flat.update(user_vecs=rng.normal(size=(n_w, u_cap, k)).astype(
                        np.float32),
                    item_vecs=rng.normal(size=(n_w, i_cap, k)).astype(
                        np.float32))
    return flat


def _jax_state(flat):
    tables = jstate.Tables(*(jnp.asarray(flat[f])
                             for f in jstate.Tables._fields))
    if "co" in flat:
        return jstate.DicsState(tables, jnp.asarray(flat["co"]),
                                jnp.asarray(flat["item_cnt"]),
                                jnp.asarray(flat["rated"]))
    return jstate.DisgdState(tables, jnp.asarray(flat["user_vecs"]),
                             jnp.asarray(flat["item_vecs"]),
                             jnp.asarray(flat["rated"]))


def _assert_flat_equal(got, want):
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def _flat(j_states):
    return convert.flatten_state(jax.tree.map(np.asarray, j_states))


@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("policy", ["lru", "lfu", "gradual", "none"])
@pytest.mark.parametrize("algo", ALGOS)
def test_apply_forgetting_matches_jax(algo, policy, gate):
    flat = _random_state(algo, seed=len(policy) + 3 * len(algo))
    kw = dict(policy=policy, lru_max_age=150, lfu_min_freq=2,
              gradual_gamma=0.9)
    state = convert.states_from_numpy(flat, device="cpu")
    gate_t = None if gate is None else torch.tensor(gate)
    out = forgetting.apply_forgetting(state, forgetting.ForgettingConfig(**kw),
                                      gate=gate_t)
    assert out is state                     # in place
    want = flat if gate is False else _flat(jax.vmap(
        lambda s: jforget.apply_forgetting(s, jforget.ForgettingConfig(**kw))
    )(_jax_state(flat)))
    _assert_flat_equal(convert.states_to_numpy(state), want)
    if policy in ("lru", "lfu") and gate is not False:
        assert (want["user_ids"] != flat["user_ids"]).any()   # evicted some


def _tied_state(seed):
    """Scores with many ties at every threshold: ts and freq in 0..3."""
    flat = _random_state("disgd", seed, n_w=1, u_cap=16, i_cap=12)
    rng = np.random.default_rng(seed + 1)
    for f in ("user_ts", "item_ts", "user_freq", "item_freq"):
        flat[f] = rng.integers(0, 4, flat[f].shape).astype(np.int32)
    return flat


@pytest.mark.parametrize("budget", [0, 1, 3, 100])
@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_evict_to_budget_matches_jax(policy, budget):
    for seed in range(3):
        flat = _tied_state(seed)
        state = convert.states_from_numpy(flat, device="cpu")
        forgetting.evict_to_budget(state, budget, budget + 1, policy)
        # The JAX function is per worker: vmapped over the worker axis.
        want = _flat(jax.vmap(lambda s: jforget.evict_to_budget(
            s, budget, budget + 1, policy))(_jax_state(flat)))
        got = convert.states_to_numpy(state)
        _assert_flat_equal(got, want)
        live = (got["user_ids"] >= 0).sum()
        assert live == min(budget, (flat["user_ids"] >= 0).sum())
    with pytest.raises(ValueError):
        forgetting.evict_to_budget(state, 1, 1, "gradual")


@functools.lru_cache(maxsize=None)
def _stream(algo):
    if algo == "dics":
        users, items, _ = synth_stream(scaled(NETFLIX, 0.0015, n_items=128),
                                       seed=0)
    else:
        users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:N_EVENTS], items[:N_EVENTS]


def _cfgs(algo, backend_t, backend_j, **forget):
    th, jh = HYPERS[algo]
    t = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2), micro_batch=256,
                        backend=backend_t, hyper=th(**CAPS), device="cpu",
                        forgetting=forgetting.ForgettingConfig(**forget))
    j = jpipe.StreamConfig(algorithm=algo, grid=JGrid(2), micro_batch=256,
                           backend=backend_j, hyper=jh(**CAPS),
                           forgetting=jforget.ForgettingConfig(**forget))
    return t, j


def assert_stream_matches(tr, jr, algo):
    """Every result of a port run against the JAX run it is held to."""
    assert (tr.events_processed, tr.dropped, tr.forgets) == (
        jr.events_processed, jr.dropped, jr.forgets)
    np.testing.assert_array_equal(tr.recall.bits(), jr.recall.bits())
    np.testing.assert_array_equal(np.stack(tr.load_history),
                                  np.stack(jr.load_history))
    assert len(tr.user_occupancy) == len(jr.user_occupancy)
    for a, b in zip(tr.user_occupancy + tr.item_occupancy,
                    jr.user_occupancy + jr.item_occupancy):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], np.asarray(b[1]))
    got = convert.states_to_numpy(tr.final_states)
    for name, w in _flat(jr.final_states).items():
        if w.dtype.kind == "f" and algo != "dics":
            np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert (tr.telemetry is None) == (jr.telemetry is None)
    if tr.telemetry is not None:
        assert telemetry_ints(tr.telemetry) == telemetry_ints(jr.telemetry)


@pytest.mark.parametrize("backends", BACKENDS, ids=[b[0] for b in BACKENDS])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("algo", ALGOS)
def test_run_stream_with_forgetting_matches_jax(algo, policy, backends):
    users, items = _stream(algo)
    t_cfg, j_cfg = _cfgs(algo, *backends, **POLICIES[policy])
    tr = rt.run_stream(users, items, t_cfg)
    jr = jpipe.run_stream(users, items, j_cfg)
    assert_stream_matches(tr, jr, algo)
    assert tr.forgets == tr.events_processed // 400 == 2
    if policy != "gradual":
        assert tr.telemetry.evictions > 0            # the passes evicted


def test_cadence_not_a_multiple_of_the_micro_batch():
    """micro-batch 256, trigger_every 600: the remainder is carried, so
    every backend fires floor(processed / 600) passes, at JAX's steps."""
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    users, items = users[:1800], items[:1800]
    forget = dict(policy="lru", trigger_every=600, lru_max_age=100)
    j = jpipe.run_stream(users, items, _cfgs("disgd", "cuda", "pallas",
                                             **forget)[1])
    assert j.forgets == users.size // 600 == 3
    for backend in ("cuda", "scan", "host"):
        t_cfg = _cfgs("disgd", backend, "pallas", **forget)[0]
        tr = rt.run_stream(users, items, t_cfg)
        assert tr.forgets == tr.events_processed // 600 == j.forgets
        # The passes run at JAX's steps: the same occupancy history.
        assert [(n, u.tolist()) for n, u in tr.user_occupancy] == [
            (n, np.asarray(u).tolist()) for n, u in j.user_occupancy]


def test_forgetting_none_and_default_config_change_nothing():
    users, items = _stream("disgd")
    t_cfg, _ = _cfgs("disgd", "scan", "scan")
    assert rt.StreamConfig().forgetting == forgetting.ForgettingConfig()
    assert jpipe.StreamConfig().forgetting._asdict() == (
        forgetting.ForgettingConfig()._asdict())
    a = rt.run_stream(users, items, t_cfg)
    b = rt.run_stream(users, items, dataclasses.replace(t_cfg,
                                                        forgetting=None))
    assert a.forgets == b.forgets == 0
    for x, y in zip(convert.states_to_numpy(a.final_states).values(),
                    convert.states_to_numpy(b.final_states).values()):
        np.testing.assert_array_equal(x, y)
