"""Storage policies of the PyTorch port against the JAX package.

  * ``StoragePolicy``: validation messages, ``is_default``,
    ``compressed()``, descriptors, and ``StoragePolicyError``'s message,
    equal to JAX's;
  * the codecs, bit for bit: ``pack_bits`` / ``unpack_bits`` at widths 0,
    1, 31, 32, 33 and 96; ``quantize_rows`` / ``dequantize_rows`` for
    uint16 and int8 on integer rows, rows beyond range, row maxima at
    ``qmax * 2^e`` and a count (and half a count) either side of it
    (XLA's exponents and scales, not the ideal ones), and zero-size
    tables; bf16 rounding;
  * ``encode_state`` / ``decode_state`` of trained DISGD and DICS states
    under every policy: the encoded tables (words, quantized values and
    scales, bf16 bits) equal JAX's, and so does the decoded form;
    ``state_nbytes`` names JAX's dtypes and counts JAX's bytes;
  * ``run_stream`` under ``compressed()`` and ``compressed(factors=
    "bf16")`` for DISGD, BPR-MF and DICS on every backend (``cuda`` on CPU
    tensors against JAX's ``pallas``, ``scan``, ``host``), on the first
    1,024 events of ``synth_stream(scaled(MOVIELENS_25M, 0.002))``
    (DISGD, BPR) or ``synth_stream(scaled(NETFLIX, 0.0015, n_items=128))``
    (DICS) at ``GridSpec(2)``, micro-batch 256, u_cap 128, i_cap 32 (slots
    collide): recall bits, counters, occupancy, telemetry and the
    resident states exactly, bf16 factor bits included; ``compressed()``
    also equals the port's own default-policy run, decoded;
  * serving per policy: ``grid_topn(storage=)`` on the resident states
    equals JAX's (K3 and K5's plain versions on CPU tensors), and the
    default policy's answers;
  * the default policy runs no codec (``state_codecs`` identities);
  * ``gather_rated`` and the telemetry list length under ``packed``
    equal the dense ones.

Forgetting and drift control per policy: ``tests/test_torch_storage_loops.py``.
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
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import storage as jstorage  # noqa: E402
from repro.core.dics import DicsHyper as JDics  # noqa: E402
from repro.core.disgd import DisgdHyper as JDisgd  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro.obs import telemetry as jtel  # noqa: E402
from repro.serve import plane as jplane  # noqa: E402
from repro_torch.core import convert, storage  # noqa: E402
from repro_torch.data.stream import (MOVIELENS_25M, NETFLIX, scaled,  # noqa: E402
                                     synth_stream)
from repro_torch.obs import telemetry  # noqa: E402
from repro_torch.obs.telemetry import telemetry_ints  # noqa: E402

# Factor vectors against JAX: test_torch_pipeline.py's tolerance (f32),
# one bf16 ulp (bf16); everything else exactly.
RTOL, ATOL = 1e-5, 1e-5
CAPS = dict(u_cap=128, i_cap=32)
HYPERS = {"disgd": (rt.DisgdHyper, JDisgd), "dics": (rt.DicsHyper, JDics),
          "bpr": (rt.BprHyper, jbpr.BprHyper)}
ALGOS = sorted(HYPERS)
BACKENDS = [("scan", "scan"), ("cuda", "pallas"), ("host", "host")]
N_EVENTS = 1024
# Every policy by its descriptor; the presets run the streams.
POLICIES = {"default": {}, "compressed": dict(co="uint16", rated="packed"),
            "bf16": dict(factors="bf16", co="uint16", rated="packed"),
            "int8": dict(co="int8"), "co_bf16": dict(co="bf16"),
            "packed": dict(rated="packed")}
PRESETS = ["compressed", "bf16"]


def _policies(name):
    return (rt.StoragePolicy(**POLICIES[name]),
            jstorage.StoragePolicy(**POLICIES[name]))


@functools.lru_cache(maxsize=None)
def _stream(algo):
    if algo == "dics":
        users, items, _ = synth_stream(scaled(NETFLIX, 0.0015, n_items=128),
                                       seed=0)
    else:
        users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:N_EVENTS], items[:N_EVENTS]


def _cfgs(algo, backend_t, backend_j, policy="default"):
    th, jh = HYPERS[algo]
    tp, jp = _policies(policy)
    t = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2), micro_batch=256,
                        backend=backend_t, hyper=th(**CAPS), device="cpu",
                        storage=tp)
    j = jpipe.StreamConfig(algorithm=algo, grid=JGrid(2), micro_batch=256,
                           backend=backend_j, hyper=jh(**CAPS), storage=jp)
    return t, j


@functools.lru_cache(maxsize=None)
def _jax_run(algo, backend_j, policy):
    """One JAX run per (algorithm, backend, policy), shared by the tests."""
    backend_t = {"pallas": "cuda"}.get(backend_j, backend_j)
    return jpipe.run_stream(*_stream(algo),
                            _cfgs(algo, backend_t, backend_j, policy)[1])


def _bits(x):
    """A numpy view whose equality is bit equality (bf16 as uint16)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.view(torch.uint16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_same_tables(got, want, factor_rtol=None):
    """Every table of two states (either package's) equal: dtype names,
    shapes and bits; with ``factor_rtol``, the factor vectors within it
    (``RTOL`` for f32, one bf16 ulp for bf16)."""
    g = convert.flatten_state(got)
    w = convert.flatten_state(want)
    assert sorted(g) == sorted(w)
    for name in w:
        a, b = _bits(g[name]), _bits(w[name])
        dt, dw = (str(x[name].dtype).removeprefix("torch.") for x in (g, w))
        assert dt == dw, name
        assert a.shape == b.shape, name
        if factor_rtol is not None and name in ("user_vecs", "item_vecs"):
            rtol = 2 ** -8 if dt == "bfloat16" else factor_rtol
            np.testing.assert_allclose(_f32(g[name]), _f32(w[name]),
                                       rtol=rtol, atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# -- StoragePolicy -------------------------------------------------------------


def test_policy_matches_jax():
    for name in POLICIES:
        tp, jp = _policies(name)
        assert tp.describe() == jp.describe()
        assert tp.is_default == jp.is_default
        assert repr(tp) == repr(jp) and hash(tp) == hash(
            rt.StoragePolicy(**POLICIES[name]))
        assert rt.StoragePolicy.from_descriptor(jp.describe()) == tp
    for fac in ("f32", "bf16"):
        assert (rt.StoragePolicy.compressed(fac).describe()
                == jstorage.StoragePolicy.compressed(fac).describe())
    assert rt.StoragePolicy.from_descriptor(None) == rt.StoragePolicy()
    assert rt.StreamConfig().storage == rt.StoragePolicy()


@pytest.mark.parametrize("bad", [dict(factors="f16"), dict(co="int4"),
                                 dict(rated="sparse")])
def test_policy_validation_messages_match_jax(bad):
    with pytest.raises(ValueError) as t:
        rt.StoragePolicy(**bad)
    with pytest.raises(ValueError) as j:
        jstorage.StoragePolicy(**bad)
    assert str(t.value) == str(j.value)


def test_storage_policy_error_matches_jax():
    t = rt.StoragePolicyError(*(_policies(n)[0] for n in ("bf16", "default")))
    j = jstorage.StoragePolicyError(*(_policies(n)[1]
                                      for n in ("bf16", "default")))
    assert str(t) == str(j)
    assert isinstance(t, ValueError)
    assert t.checkpoint_policy == _policies("bf16")[0]


# -- codecs ---------------------------------------------------------------------


@pytest.mark.parametrize("width", [0, 1, 31, 32, 33, 96])
def test_pack_unpack_bits_match_jax(width):
    rng = np.random.default_rng(width)
    bits = rng.random((3, 5, width)) < 0.3
    want = np.asarray(jstorage.pack_bits(jnp.asarray(bits)))
    got = storage.pack_bits(torch.tensor(bits))
    assert got.dtype == torch.uint32
    assert got.shape == want.shape == (3, 5, storage.packed_width(width))
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.zeros(got.shape, dtype=torch.int32).view(torch.uint32)
    assert storage.pack_bits(torch.tensor(bits), out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    back = storage.unpack_bits(got, width)
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jstorage.unpack_bits(jnp.asarray(want),
                                                      width)))


def _boundary_rows(qmax):
    """Row maxima at qmax * 2^e and a count / half a count around it."""
    rows = []
    for e in range(20):
        base = qmax * 2 ** e
        rows += [base, base + 1, base - 1, base + 0.5, base * 1.5]
    rng = np.random.default_rng(qmax)
    rows += list(rng.integers(0, 2 ** 22, 300))
    return (np.asarray(rows, np.float32)[:, None]
            * np.asarray([[1.0, 0.5, -0.25, 0.0, 0.3]], np.float32))


@pytest.mark.parametrize("case", ["integers", "beyond", "boundaries",
                                  "empty", "zero_rows"])
@pytest.mark.parametrize("dtype,qmax", [("uint16", 65535), ("int8", 127)])
def test_quantize_rows_matches_jax(dtype, qmax, case):
    rng = np.random.default_rng(2)
    x = {"integers": lambda: rng.integers(0, qmax + 1, (6, 17)),
         "beyond": lambda: np.asarray([[0.0, 70000.0, 131000.0],
                                       [1.0, -300.0, 255.5]]),
         "boundaries": lambda: _boundary_rows(qmax),
         "empty": lambda: np.zeros((4, 0, 0)),
         "zero_rows": lambda: np.zeros((2, 3, 4))}[case]().astype(np.float32)
    jq, js = jstorage.quantize_rows(jnp.asarray(x), dtype)
    q, s = storage.quantize_rows(torch.tensor(x), dtype)
    assert str(q.dtype).removeprefix("torch.") == dtype
    assert q.shape == jq.shape and s.shape == js.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        storage.dequantize_rows(q, s).numpy(),
        np.asarray(jstorage.dequantize_rows(jq, js)))
    if case == "integers":          # exact within range
        np.testing.assert_array_equal(storage.dequantize_rows(q, s).numpy(),
                                      x)


def test_bf16_rounding_matches_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(
        -6, 6, 4096), [0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9]]).astype(
            np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    got = torch.tensor(x).to(torch.bfloat16).view(torch.uint16).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        storage.factor_f32(torch.tensor(got).view(torch.bfloat16)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("algo", ["disgd", "dics"])
def test_encode_decode_state_match_jax(algo, policy):
    jr = _jax_run(algo, "scan", "default")
    tp, jp = _policies(policy)
    j_enc = jax.tree.map(np.asarray, jstorage.encode_state(
        jr.final_states, jp))
    states = convert.states_from_numpy(
        convert.flatten_state(jax.tree.map(np.asarray, jr.final_states)),
        device="cpu")
    enc = storage.encode_state(states, tp)
    _assert_same_tables(enc, j_enc)
    dec = storage.decode_state(enc, tp)
    _assert_same_tables(dec, jax.tree.map(np.asarray, jstorage.decode_state(
        jstorage.encode_state(jr.final_states, jp), jp)))
    # Through numpy and back (states_to_numpy / states_from_numpy).
    _assert_same_tables(convert.states_from_numpy(
        convert.states_to_numpy(enc), device="cpu"), j_enc)
    assert storage.state_nbytes(enc) == jstorage.state_nbytes(j_enc)
    assert storage.total_nbytes(enc) == jstorage.total_nbytes(j_enc)
    # The in-place encoder writes the same bytes into resident tables.
    resident = storage.encode_state(
        convert.states_from_numpy(convert.states_to_numpy(states),
                                  device="cpu"), tp)
    storage.encode_into(resident, dec, tp)
    _assert_same_tables(resident, j_enc)


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("algo", ALGOS)
def test_init_states_match_jax(algo, policy):
    t_cfg, j_cfg = _cfgs(algo, "scan", "scan", policy)
    got = rt.core.pipeline.init_states(t_cfg)
    want = jax.tree.map(np.asarray, jpipe.init_states(j_cfg))
    _assert_same_tables(got, want)
    algo_t = rt.get_algorithm(algo)
    tmpl = algo_t.state_template(t_cfg.resolved_hyper(), t_cfg.storage)
    for name, t in convert.flatten_state(tmpl).items():
        w = convert.flatten_state(want)[name]
        assert t.device.type == "meta"
        assert (tuple(t.shape), t.dtype) == (w.shape[1:], getattr(
            convert.flatten_state(got)[name], "dtype")), name


def test_default_policy_runs_no_codec():
    dec, enc = storage.state_codecs(rt.StoragePolicy())
    s = object()
    assert dec(s) is s and enc(s) is s
    st = rt.core.pipeline.init_states(_cfgs("disgd", "scan", "scan")[0])
    assert storage.decode_state(st, rt.StoragePolicy()) is st
    assert storage.in_compute_form(st, None, lambda x: x) is st


# -- streams --------------------------------------------------------------------


def assert_stream_matches(tr, jr):
    """A port run under a policy against the JAX run under it: everything
    exactly, the resident (encoded) tables bit for bit but the factor
    vectors (within RTOL, or one bf16 ulp)."""
    assert (tr.events_processed, tr.dropped, tr.forgets) == (
        jr.events_processed, jr.dropped, jr.forgets)
    np.testing.assert_array_equal(tr.recall.bits(), jr.recall.bits())
    np.testing.assert_array_equal(np.stack(tr.load_history),
                                  np.stack(jr.load_history))
    for a, b in zip(tr.user_occupancy + tr.item_occupancy,
                    jr.user_occupancy + jr.item_occupancy):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], np.asarray(b[1]))
    _assert_same_tables(tr.final_states,
                        jax.tree.map(np.asarray, jr.final_states),
                        factor_rtol=RTOL)
    assert telemetry_ints(tr.telemetry) == telemetry_ints(jr.telemetry)


@pytest.mark.parametrize("backends", BACKENDS, ids=[b[0] for b in BACKENDS])
@pytest.mark.parametrize("policy", PRESETS)
@pytest.mark.parametrize("algo", ALGOS)
def test_run_stream_under_a_policy_matches_jax(algo, policy, backends):
    t_cfg, _ = _cfgs(algo, *backends, policy)
    tr = rt.run_stream(*_stream(algo), t_cfg)
    assert_stream_matches(tr, _jax_run(algo, backends[1], policy))
    assert tr.final_states.rated.dtype == torch.uint32
    if policy == "compressed":
        # Lossless at this scale: the default policy's run, decoded.
        base = rt.run_stream(*_stream(algo), dataclasses.replace(
            t_cfg, storage=rt.StoragePolicy()))
        np.testing.assert_array_equal(tr.recall.bits(), base.recall.bits())
        _assert_same_tables(storage.decode_state(tr.final_states,
                                                 t_cfg.storage),
                            base.final_states)


# -- serving --------------------------------------------------------------------


@pytest.mark.parametrize("policy", PRESETS)
@pytest.mark.parametrize("algo", ALGOS)
def test_grid_topn_under_a_policy_matches_jax(algo, policy):
    jr = _jax_run(algo, "scan", policy)
    tp, jp = _policies(policy)
    t_cfg, _ = _cfgs(algo, "scan", "scan", policy)
    states = convert.states_from_numpy(
        convert.flatten_state(jax.tree.map(np.asarray, jr.final_states)),
        device="cpu")
    hyper = t_cfg.resolved_hyper()
    q = np.unique(_stream(algo)[0])[:48].astype(np.int32)
    kw = dict(algorithm=algo, top_n=hyper.top_n, u_cap=hyper.u_cap, qcap=48)
    got = rt.grid_topn(states, torch.tensor(q), grid=t_cfg.grid,
                       use_kernel=True, storage=tp, **kw)
    want = jplane.grid_topn(jr.final_states, jnp.asarray(q),
                            grid=JGrid(2), storage=jp, **kw)
    for j, (a, b) in enumerate(zip(got, want)):
        if j == 1 and algo != "dics":
            # einsum and bmm add the k products in other orders.
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if policy == "compressed":
        dense = storage.decode_state(states, tp)
        for a, b in zip(got, rt.grid_topn(dense, torch.tensor(q),
                                          grid=t_cfg.grid, **kw)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_session_serves_a_compressed_state_as_the_dense_one():
    users, items = _stream("disgd")
    answers = []
    for policy in ("default", "compressed"):
        s = rt.StreamSession(_cfgs("disgd", "cuda", "pallas", policy)[0])
        s.ingest(users, items)
        r = s.recommend(users[:16], n=5)
        answers.append((r.ids, r.scores))
        assert (s.frontend.cfg.storage is None) == (policy == "default")
    np.testing.assert_array_equal(answers[0][0], answers[1][0])
    np.testing.assert_array_equal(answers[0][1], answers[1][1])


# -- gather_rated and the telemetry gather ---------------------------------------


def test_gather_rated_and_list_length_under_packed():
    jr = _jax_run("disgd", "scan", "default")
    flat = convert.flatten_state(jax.tree.map(np.asarray, jr.final_states))
    dense = convert.states_from_numpy(flat, device="cpu")
    tp, jp = _policies("packed")
    packed = storage.encode_state(dense, tp)
    rng = np.random.default_rng(7)
    n_c = dense.rated.shape[0]
    slots = torch.tensor(rng.integers(0, CAPS["u_cap"], (n_c, 9)))
    np.testing.assert_array_equal(
        storage.gather_rated(packed.rated, slots, tp, CAPS["i_cap"]).numpy(),
        storage.gather_rated(dense.rated, slots).numpy())
    users = _stream("disgd")[0]
    ev_u = torch.tensor(np.where(rng.random((n_c, 64)) < 0.8, rng.choice(
        users, (n_c, 64)), -1).astype(np.int32))
    got = telemetry.effective_list_len(packed, ev_u, top_n=10, g=2,
                                       storage=tp)
    assert int(got) == int(telemetry.effective_list_len(dense, ev_u,
                                                        top_n=10, g=2))
    want = jtel.effective_list_len(
        jstorage.encode_state(jr.final_states, jp),
        jnp.asarray(ev_u.numpy()), top_n=10, g=2, storage=jp)
    assert int(got) == int(want)
