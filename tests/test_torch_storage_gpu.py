"""Storage policies on the card.

Every test carries the ``gpu`` marker and needs a CUDA device (decided in
the ``cuda_device`` fixture, never at import). This file imports no jax:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_storage_gpu.py

  * the codecs on the card equal the CPU codecs bit for bit: packed
    words and their unpacking (widths 1 to 96, and a row as wide as the
    DISGD deployment's 6,784 items), quantized rows and their scales at
    the power-of-two boundaries (uint16 and int8), bf16 rounding, the
    whole-state encode / decode / in-place encode, the packed row gather;
  * a whole compressed stream runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the codecs add no host
    synchronization to the device loop (with forgetting and with the
    adaptive drift policy, async publish boundaries included);
  * K1, K2 and K4 streams (DISGD, BPR-MF, DICS on ``cuda``) under
    ``compressed()`` equal the dense streams: decoded states, recall
    bits, counters and telemetry, exactly; under ``compressed(factors=
    "bf16")`` the integer state equals the card's run of the same policy
    on CPU tensors, the factors within one bf16 ulp;
  * ``grid_topn`` (K3, K5) on compressed states answers as on the dense
    states, ids and score bits.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro_torch.core import convert, engine, forgetting  # noqa: E402
from repro_torch.core import state as state_lib, storage  # noqa: E402
from repro_torch.data.stream import (MOVIELENS_25M, NETFLIX, scaled,  # noqa: E402
                                     synth_stream)
from repro_torch.drift import DetectorConfig, DriftPolicy, make_scenario  # noqa: E402
from repro_torch.obs.telemetry import telemetry_ints  # noqa: E402

HYPERS = {"disgd": rt.DisgdHyper, "dics": rt.DicsHyper, "bpr": rt.BprHyper}
COMPRESSED = rt.StoragePolicy.compressed()
BF16 = rt.StoragePolicy.compressed(factors="bf16")
ADAPTIVE = DriftPolicy(detector=DetectorConfig(warmup=512, drop_frac=0.1,
                                               ph_lambda=0.1),
                       boost_batches=3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only "
                    "on the card")
    return torch.device("cuda")


def _stream(algo, n=2048):
    if algo == "dics":
        u, i, _ = synth_stream(scaled(NETFLIX, 0.0015, n_items=128), seed=0)
    else:
        u, i, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return u[:n], i[:n]


def _cfg(algo, **over):
    return rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2),
                           micro_batch=256, hyper=HYPERS[algo](
                               u_cap=128, i_cap=32),
                           backend="cuda", device="cuda", **over)


def _bits(t):
    t = t.detach().cpu()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16
            else storage.signed(t)).numpy()


def _assert_bits_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 31, 32, 33, 96, 6784])
def test_pack_unpack_on_the_card_equal_the_cpu(cuda_device, width):
    rng = np.random.default_rng(width)
    bits = torch.tensor(rng.random((3, 17, width)) < 0.3)
    words = storage.pack_bits(bits)
    got = storage.pack_bits(bits.cuda())
    _assert_bits_equal(got, words)
    out = torch.zeros_like(storage.signed(got)).view(torch.uint32)
    storage.pack_bits(bits.cuda(), out=out)
    _assert_bits_equal(out, words)
    np.testing.assert_array_equal(
        storage.unpack_bits(got, width).cpu().numpy(), bits.numpy())
    slots = torch.tensor(rng.integers(0, 17, (3, 5)))
    _assert_bits_equal(storage.gather_rated(got, slots.cuda(), COMPRESSED,
                                            width),
                       storage.gather_rated(words, slots, COMPRESSED, width))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,qmax", [("uint16", 65535), ("int8", 127)])
def test_quantize_on_the_card_equals_the_cpu(cuda_device, dtype, qmax):
    rows = []
    for e in range(20):
        base = qmax * 2 ** e
        rows += [base, base + 1, base - 1, base * 1.5, base + 0.5]
    rng = np.random.default_rng(3)
    rows += list(rng.integers(0, 2 ** 22, 500))
    x = torch.tensor(np.asarray(rows, np.float32)[:, None]
                     * np.asarray([[1.0, 0.5, -0.25, 0.0, 0.3]], np.float32))
    q, s = storage.quantize_rows(x, dtype)
    qc, sc = storage.quantize_rows(x.cuda(), dtype)
    _assert_bits_equal(qc, q)
    _assert_bits_equal(sc, s)
    _assert_bits_equal(storage.dequantize_rows(qc, sc),
                       storage.dequantize_rows(q, s))
    v = torch.tensor(rng.normal(size=4096).astype(np.float32))
    _assert_bits_equal(v.cuda().to(torch.bfloat16), v.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", [COMPRESSED, BF16,
                                    rt.StoragePolicy(co="int8"),
                                    rt.StoragePolicy(co="bf16")],
                         ids=["compressed", "bf16", "int8", "co_bf16"])
@pytest.mark.parametrize("algo", ["disgd", "dics"])
def test_state_codecs_on_the_card_equal_the_cpu(cuda_device, algo, policy):
    res = rt.run_stream(*_stream(algo), _cfg(algo))
    flat = convert.states_to_numpy(res.final_states)
    cpu = convert.states_from_numpy(flat, device="cpu")
    enc_c = storage.encode_state(cpu, policy)
    enc_g = storage.encode_state(res.final_states, policy)
    for name, t in convert.flatten_state(enc_c).items():
        _assert_bits_equal(convert.flatten_state(enc_g)[name], t)
    dec_c = storage.decode_state(enc_c, policy)
    dec_g = storage.decode_state(enc_g, policy)
    for name, t in convert.flatten_state(dec_c).items():
        _assert_bits_equal(convert.flatten_state(dec_g)[name], t)
    # In place: a resident copy receives the encoding of its decoded form.
    resident = state_lib.clone_state(enc_g)
    storage.encode_into(resident, storage.decode_state(resident, policy),
                        policy)
    for name, t in convert.flatten_state(enc_g).items():
        _assert_bits_equal(convert.flatten_state(resident)[name], t)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["disgd_lru", "bpr_gradual",
                                  "dics_adaptive"])
@pytest.mark.parametrize("policy", [COMPRESSED, BF16],
                         ids=["compressed", "bf16"])
def test_no_sync_inside_a_compressed_loop(cuda_device, monkeypatch, case,
                                          policy):
    sc = make_scenario("abrupt", events=4096, seed=0)
    algo, kind = case.split("_")
    over = (dict(drift=ADAPTIVE) if kind == "adaptive" else
            dict(forgetting=forgetting.ForgettingConfig(
                policy=kind, trigger_every=400, lru_max_age=150,
                gradual_gamma=0.9)))
    cfg = _cfg(algo, storage=policy, **over)
    steps = []
    make = engine._make_batch_step

    def checked_step(cfg, worker_fn):
        step = make(cfg, worker_fn)

        def run(*args):
            steps.append(1)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    monkeypatch.setattr(engine, "_make_batch_step", checked_step)
    store = rt.SnapshotStore()
    res = rt.run_stream(sc.users, sc.items, cfg, publish_every=4,
                        on_publish=store.subscriber("async"),
                        publish_sync=False)
    assert store.flush(timeout=30.0)
    assert len(steps) == -(-sc.users.size // 256) + 2
    assert res.dropped == 0 and res.forgets >= (kind != "adaptive")
    assert res.final_states.rated.dtype == torch.uint32


def _decoded(res, policy):
    return convert.states_to_numpy(storage.decode_state(res.final_states,
                                                        policy))


@pytest.mark.gpu
@pytest.mark.parametrize("algo", sorted(HYPERS))
def test_compressed_streams_equal_the_dense_streams(cuda_device, algo):
    users, items = _stream(algo)
    dense = rt.run_stream(users, items, _cfg(algo))
    comp = rt.run_stream(users, items, _cfg(algo, storage=COMPRESSED))
    assert comp.final_states.rated.dtype == torch.uint32
    want = convert.states_to_numpy(dense.final_states)
    got = _decoded(comp, COMPRESSED)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    np.testing.assert_array_equal(comp.recall.bits(), dense.recall.bits())
    assert (comp.events_processed, comp.dropped) == (dense.events_processed,
                                                     dense.dropped)
    assert telemetry_ints(comp.telemetry) == telemetry_ints(dense.telemetry)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", sorted(HYPERS))
def test_bf16_streams_on_the_card_follow_the_cpu(cuda_device, algo):
    users, items = _stream(algo)
    cfg = _cfg(algo, storage=BF16)
    card = rt.run_stream(users, items, cfg)
    cpu = rt.run_stream(users, items, dataclasses.replace(cfg, device="cpu"))
    got, want = _decoded(card, BF16), _decoded(cpu, BF16)
    for name, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[name], w, rtol=2 ** -8, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["disgd", "dics"])
def test_grid_topn_on_compressed_states(cuda_device, algo):
    users, items = _stream(algo)
    cfg = _cfg(algo)
    dense = rt.run_stream(users, items, cfg).final_states
    comp = storage.encode_state(dense, COMPRESSED)
    hyper = cfg.resolved_hyper()
    q = torch.tensor(np.unique(users)[:64], dtype=torch.int32, device="cuda")
    kw = dict(algorithm=algo, grid=cfg.grid, top_n=hyper.top_n,
              u_cap=hyper.u_cap, qcap=64)
    want = rt.grid_topn(dense, q, **kw)
    got = rt.grid_topn(comp, q, storage=COMPRESSED, **kw)
    for a, b in zip(got, want):
        _assert_bits_equal(a, b)
