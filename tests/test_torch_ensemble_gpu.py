"""The ensemble, service and autoscaler runtime on the card.

Every test carries the ``gpu`` marker and needs a CUDA device (decided in
the ``cuda_device`` fixture, never at import). This file imports no jax:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_ensemble_gpu.py

  * an ensemble of DICS, DISGD and BPR-MF on the ``cuda`` backend (K1-K5)
    on the card trains and serves as the same ensemble on CPU tensors (the
    kernels' plain versions, which the CPU tests hold to JAX's ``pallas``),
    at ``tests/test_torch_ensemble.py``'s size: recall bits, weights (rtol
    1e-6), blend and switch ids, states (factors within 1e-4 / 1e-5, the
    kernels' FMA order). The ``scan`` backend is no reference for the
    weights: the ``cuda`` worker scores at bucket start and ``scan`` live,
    so their recall bits differ by design in both packages;
  * a threaded ``run_service`` on the card re-raises a crash of its
    trainer thread, and a clean threaded run drops nothing;
  * the autoscaler's grow leaves every state tensor on the card.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.serve.loadgen import LoadConfig  # noqa: E402
from repro_torch.serve.service import ServiceConfig, run_service  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only "
                    "on the card")
    return torch.device("cuda")


def _stream(n=800):
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:n], items[:n]


def _cfg(algo, device="cuda", **over):
    hyper = rt.get_algorithm(algo).default_hyper()._replace(u_cap=128,
                                                             i_cap=32)
    over.setdefault("micro_batch", 128)
    return rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2), hyper=hyper,
                           backend="cuda", device=device, **over)


def _leaves(states):
    out = []
    for x in states:
        if isinstance(x, tuple):
            out.extend(_leaves(x))
        elif x is not None:
            out.append(x)
    return out


@pytest.mark.gpu
def test_cuda_ensemble_on_the_card_equals_cpu_tensors(cuda_device):
    users, items = _stream()
    algos = ("bpr", "dics", "disgd")
    ens = {d: rt.EnsembleSession([_cfg(a, d) for a in algos])
           for d in ("cuda", "cpu")}
    for seg in np.array_split(np.arange(users.size), 4):
        res = {d: e.ingest(users[seg], items[seg]) for d, e in ens.items()}
        for name in algos:
            a, b = res["cuda"].members[name], res["cpu"].members[name]
            ba, bb = a.recall.bits(), b.recall.bits()
            np.testing.assert_array_equal(np.isnan(ba), np.isnan(bb))
            np.testing.assert_array_equal(ba[~np.isnan(ba)],
                                          bb[~np.isnan(bb)])
            assert a.dropped == b.dropped == 0
    wc = ens["cuda"].weigher_state.weights
    assert wc.device.type == "cuda"
    np.testing.assert_allclose(wc.cpu().numpy(),
                               ens["cpu"].weigher_state.weights.numpy(),
                               rtol=1e-6, atol=0)
    for name in algos:
        got = convert.states_to_numpy(ens["cuda"].members[name].states)
        want = convert.states_to_numpy(ens["cpu"].members[name].states)
        for field, w in want.items():
            if w.dtype.kind == "f":
                np.testing.assert_allclose(got[field], w, rtol=1e-4,
                                           atol=1e-5, err_msg=field)
            else:
                np.testing.assert_array_equal(got[field], w, err_msg=field)
    uids = np.concatenate([np.unique(users)[:64], [10**6]])
    for mode in ("blend", "switch"):
        got = ens["cuda"].recommend(uids, mode=mode)
        want = ens["cpu"].recommend(uids, mode=mode)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.known, want.known)


@pytest.mark.gpu
def test_threaded_service_on_the_card(cuda_device):
    users, items = _stream(4096)
    load = LoadConfig(n_users=int(users.max()) + 1, seed=7, query_batch=8,
                      arrival="closed")
    s = rt.StreamSession(_cfg("disgd"),
                         publish=rt.PublishPolicy(every=2, mode="async"))
    s.ingest(users[:256], items[:256])
    report = run_service(s, users[256:], items[256:], load,
                         ServiceConfig(mode="threaded", query_batches=8))
    assert s.events_processed == users.size
    assert report.summary()["p99_ms"] > 0

    def boom(*a, **k):
        raise RuntimeError("ingest exploded")

    s.ingest = boom
    with pytest.raises(RuntimeError, match="ingest exploded"):
        run_service(s, users, items, load,
                    ServiceConfig(mode="threaded", query_batches=2))


@pytest.mark.gpu
def test_autoscaler_grow_keeps_states_on_the_card(cuda_device):
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(_cfg("disgd", micro_batch=64),
                              grid=rt.GridSpec.rect(1, 1),
                              capacity_factor=0.25, carry_slots=8)
    s = rt.StreamSession(cfg)
    scaler = rt.Autoscaler(s, rt.AutoscalePolicy(max_workers=8, cooldown=0))
    actions = []
    for _ in range(6):
        s.ingest(rng.integers(0, 400, 512).astype(np.int32),
                 rng.integers(0, 160, 512).astype(np.int32))
        actions.append(scaler.step())
        for leaf in _leaves(s.states):
            assert leaf.device.type == "cuda"
            assert leaf.shape[0] == s.grid.n_c
        snap = s.store.acquire()
        assert all(x.device.type == "cuda" for x in _leaves(snap.states))
    assert "grow" in actions and s.grid.n_c > 1
    assert s.recommend(np.arange(8)).ids.shape[0] == 8
