"""Forgetting, drift control and telemetry on the card.

Every test carries the ``gpu`` marker and needs a CUDA device (decided in
the ``cuda_device`` fixture, never at import). This file imports no jax:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_forgetting_gpu.py

  * no host synchronization inside the device loop with forgetting, drift
    control and telemetry on: every step of a DISGD stream under LRU and
    of a DICS stream under the adaptive policy runs under
    ``torch.cuda.set_sync_debug_mode("error")``, async publish boundaries
    included;
  * ``cuda`` equals ``scan`` on the card under every fixed policy
    (forgets, integers and the telemetry vector but its hits exactly,
    floats within RTOL 1e-4 / ATOL 1e-5: the cuda worker scores at
    bucket start, so its recall bits, and an adaptive run's flags, are
    its own), and under the adaptive policy the card's ``cuda`` equals
    the same run on CPU tensors (flags, forgets, recall bits, integers
    and telemetry exactly), and ``host`` equals ``scan`` exactly;
  * ``apply_forgetting`` on the card equals the same pass on the CPU.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import convert, engine, forgetting  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.drift import DetectorConfig, DriftPolicy, make_scenario  # noqa: E402
from repro_torch.obs.telemetry import telemetry_ints  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
HYPERS = {"disgd": rt.DisgdHyper, "dics": rt.DicsHyper, "bpr": rt.BprHyper}
FIXED = {"lru": dict(policy="lru", trigger_every=400, lru_max_age=150),
         "lfu": dict(policy="lfu", trigger_every=400, lfu_min_freq=2),
         "gradual": dict(policy="gradual", trigger_every=400,
                         gradual_gamma=0.9)}
ADAPTIVE = DriftPolicy(detector=DetectorConfig(warmup=512, drop_frac=0.1,
                                               ph_lambda=0.1),
                       boost_batches=3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only "
                    "on the card")
    return torch.device("cuda")


def _scenario():
    sc = make_scenario("abrupt", events=6144, seed=0)
    return sc.users, sc.items


def _cfg(algo, **over):
    return rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2),
                           micro_batch=256, hyper=HYPERS[algo](
                               u_cap=256, i_cap=64),
                           backend="cuda", device="cuda", **over)


def _no_sync(fn):
    """``fn`` under sync debug mode "error": a synchronizing call raises."""
    def call(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return call


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["disgd_lru", "dics_adaptive"])
def test_no_sync_inside_the_loop(cuda_device, monkeypatch, case):
    users, items = _scenario()
    cfg = (_cfg("disgd", forgetting=forgetting.ForgettingConfig(**FIXED[
        "lru"])) if case == "disgd_lru" else _cfg("dics", drift=ADAPTIVE))
    assert cfg.telemetry
    steps = []
    make = engine._make_batch_step

    def checked_step(cfg, worker_fn):
        step = make(cfg, worker_fn)

        def run(*args):
            steps.append(1)
            return _no_sync(step)(*args)
        return run

    monkeypatch.setattr(engine, "_make_batch_step", checked_step)
    monkeypatch.setattr(engine, "_publish_event",
                        _no_sync(engine._publish_event))
    store = rt.SnapshotStore()
    res = rt.run_stream(users, items, cfg, publish_every=4,
                        on_publish=_no_sync(store.subscriber("async")),
                        publish_sync=False)
    assert store.flush(timeout=30.0)
    assert len(steps) == -(-users.size // 256) + 2          # + drain
    assert res.dropped == 0 and res.forgets >= 1
    assert telemetry_ints(res.telemetry)["events"] == res.events_processed
    if case == "dics_adaptive":
        assert int(res.drift_flags.sum()) >= 1


def _states(res):
    return convert.states_to_numpy(res.final_states)


def _assert_close(a, b, exact_floats=False):
    for name in a:
        if a[name].dtype.kind != "f" or exact_floats:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        else:
            np.testing.assert_allclose(a[name], b[name], rtol=RTOL, atol=ATOL,
                                       err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", sorted(FIXED) + ["adaptive"])
@pytest.mark.parametrize("algo", sorted(HYPERS))
def test_backends_agree_on_the_card(cuda_device, algo, policy):
    users, items = (x[:2048] for x in _scenario())
    over = (dict(drift=ADAPTIVE) if policy == "adaptive" else
            dict(forgetting=forgetting.ForgettingConfig(**FIXED[policy])))
    cfg = _cfg(algo, **over)
    runs = {name: rt.run_stream(users, items, dataclasses.replace(cfg, **kw))
            for name, kw in (("cuda", {}), ("scan", dict(backend="scan")),
                             ("host", dict(backend="host")),
                             ("cpu", dict(device="cpu")))}
    st = {k: _states(r) for k, r in runs.items()}
    tel = {k: telemetry_ints(r.telemetry) for k, r in runs.items()}
    # host and scan: the same eager worker, everything exactly.
    _assert_close(st["host"], st["scan"], exact_floats=True)
    assert tel["host"] == tel["scan"]
    hb, sb = (runs[k].recall.bits() for k in ("host", "scan"))
    np.testing.assert_array_equal(hb[~np.isnan(hb)], sb[~np.isnan(sb)])
    # The card's cuda run and the plain versions on CPU tensors.
    _assert_close(st["cuda"], st["cpu"], exact_floats=algo == "dics")
    assert tel["cuda"] == tel["cpu"]
    np.testing.assert_array_equal(runs["cuda"].recall.bits(),
                                  runs["cpu"].recall.bits())
    for a, b in (("host", "scan"), ("cuda", "cpu")):
        assert runs[a].forgets == runs[b].forgets
        if policy == "adaptive":
            np.testing.assert_array_equal(runs[a].drift_flags,
                                          runs[b].drift_flags)
    if policy != "adaptive":
        # Fixed cadence: the passes never read the recall bits.
        assert runs["cuda"].forgets == runs["scan"].forgets >= 1
        _assert_close(st["cuda"], st["scan"], exact_floats=algo == "dics")
        for t in (tel["cuda"], tel["scan"]):
            t.pop("hits")
        assert tel["cuda"] == tel["scan"]


@pytest.mark.gpu
@pytest.mark.parametrize("policy", sorted(FIXED))
@pytest.mark.parametrize("algo", ["disgd", "dics"])
def test_apply_forgetting_on_the_card_equals_the_cpu(cuda_device, algo,
                                                     policy):
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    res = rt.run_stream(users, items, _cfg(algo))
    flat = _states(res)
    fcfg = forgetting.ForgettingConfig(**FIXED[policy])
    for gate in (None, True, False):
        want = convert.states_from_numpy(flat, device="cpu")
        got = convert.states_from_numpy(flat, device="cuda")
        forgetting.apply_forgetting(want, fcfg, gate=None if gate is None
                                    else torch.tensor(gate))
        forgetting.apply_forgetting(got, fcfg, gate=None if gate is None
                                    else torch.tensor(gate, device="cuda"))
        _assert_close(convert.states_to_numpy(got),
                      convert.states_to_numpy(want), exact_floats=True)
