"""Forgetting and drift control under storage policies, against JAX.

JAX wraps the forgetting pass and the drift controller in the codecs
(``enc(f(dec(s)))``, ``repro/core/engine.py:159``); the port's device
loop runs them on the worker's decoded form and rounds the lossy tables
(bf16 factors, bf16 or quantized ``co``) where JAX encodes between the
worker and the pass (``storage.round_trip``). These streams hold that to
JAX's results under every policy an algorithm stores:

  * DISGD under ``compressed()`` and ``compressed(factors="bf16")``,
    DICS under ``compressed()``, ``co="int8"`` and ``co="bf16"``;
  * a fixed-cadence stream with gradual decay (the pass that rounds)
    and one with LRU eviction, on the first 1,024 events of
    ``tests/test_torch_forgetting.py``'s streams and configuration;
  * an adaptive-drift stream (``DriftPolicy`` with a boost window of
    gradual decay) on ``tests/test_torch_drift.py``'s scenario
    and configuration;

each on the ``cuda`` loop (CPU tensors, against JAX's ``pallas``) and the
``host`` loop (drift: DICS int8 there): recall bits,
counters, forgets, occupancy, telemetry and the resident states as
``test_torch_storage.py`` holds them (factor vectors within RTOL 1e-5,
or one bf16 ulp), DICS bit for bit; drift flags and the final detector
exactly.
"""

import dataclasses
import functools

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.core import forgetting as jforget  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro_torch.core import forgetting  # noqa: E402
from tests.test_torch_drift import _policies as _drift_policies  # noqa: E402
from tests.test_torch_drift import _scenario  # noqa: E402
from tests.test_torch_storage import (_cfgs, _stream,  # noqa: E402
                                      assert_stream_matches)

CASES = [("disgd", "compressed"), ("disgd", "bf16"), ("dics", "compressed"),
         ("dics", "int8"), ("dics", "co_bf16")]
BACKENDS = [("cuda", "pallas"), ("host", "host")]
FORGET = {"gradual": dict(policy="gradual", trigger_every=400,
                          gradual_gamma=0.9),
          "lru": dict(policy="lru", trigger_every=400, lru_max_age=150)}


def _forget_cfgs(algo, backends, policy, kind):
    t, j = _cfgs(algo, *backends, policy)
    return (dataclasses.replace(
                t, forgetting=forgetting.ForgettingConfig(**FORGET[kind])),
            dataclasses.replace(
                j, forgetting=jforget.ForgettingConfig(**FORGET[kind])))


@functools.lru_cache(maxsize=None)
def _jax_forget(algo, backend_j, policy, kind):
    backends = dict((j, (t, j)) for t, j in BACKENDS)[backend_j]
    return jpipe.run_stream(*_stream(algo),
                            _forget_cfgs(algo, backends, policy, kind)[1])


@pytest.mark.parametrize("backends", BACKENDS, ids=[b[0] for b in BACKENDS])
@pytest.mark.parametrize("kind", sorted(FORGET))
@pytest.mark.parametrize("algo,policy", CASES,
                         ids=[f"{a}-{p}" for a, p in CASES])
def test_forgetting_under_a_policy_matches_jax(algo, policy, kind, backends):
    t_cfg, _ = _forget_cfgs(algo, backends, policy, kind)
    tr = rt.run_stream(*_stream(algo), t_cfg)
    jr = _jax_forget(algo, backends[1], policy, kind)
    assert tr.forgets == jr.forgets == 2
    assert_stream_matches(tr, jr)


def _drift_cfgs(algo, backends, policy):
    t, j = _cfgs(algo, *backends, policy)
    tp, jp = _drift_policies()
    hyper_t = t.hyper._replace(u_cap=256, i_cap=64)
    hyper_j = j.hyper._replace(u_cap=256, i_cap=64)
    return (dataclasses.replace(t, drift=tp, hyper=hyper_t),
            dataclasses.replace(j, drift=jp, hyper=hyper_j))


# Every policy on the cuda loop; the host loop (~20 s a JAX run on this
# scenario) under quantized co (its forgetting runs cover the rest).
DRIFT_CASES = ([(a, p, BACKENDS[0]) for a, p in CASES]
               + [("dics", "int8", BACKENDS[1])])


@pytest.mark.parametrize("algo,policy,backends", DRIFT_CASES,
                         ids=[f"{a}-{p}-{b[0]}" for a, p, b in DRIFT_CASES])
def test_adaptive_drift_under_a_policy_matches_jax(algo, policy, backends):
    users, items = _scenario()
    t_cfg, j_cfg = _drift_cfgs(algo, backends, policy)
    tr = rt.run_stream(users, items, t_cfg)
    jr = jpipe.run_stream(users, items, j_cfg)
    assert int(np.sum(jr.drift_flags)) >= 1        # not vacuous
    np.testing.assert_array_equal(tr.drift_flags, jr.drift_flags)
    for f, a, b in zip(tr.final_detector._fields, tr.final_detector,
                       jr.final_detector):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert_stream_matches(tr, jr)
