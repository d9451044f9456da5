"""BPR-MF of the PyTorch port against the JAX package.

The sampler's draws (``prng.split`` / ``prng.randint`` and the batched
negative slots), the two worker steps bucket by bucket, whole streams on
the ``scan``, ``cuda`` (plain kernel versions on CPU tensors) and
``host`` backends, and grid serving, on the same seeded numpy inputs as
``repro.algos.bpr``. Slots collide (ids span several times the caps), so
tenants are evicted and negatives land on empty, evicted and rated
slots. Integers (state, negative slots, counters, recall bits) exactly;
factor vectors within RTOL 1e-5 / ATOL 1e-6 (summation order, init
vectors within a few f32 ulp of XLA's).
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.algos import bpr as jbpr  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro.serve import plane as jplane  # noqa: E402
from repro_torch.algos import bpr  # noqa: E402
from repro_torch.core import algorithm, convert, prng, state  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve.plane import query_capacity  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
HYPER = dict(k=6, u_cap=16, i_cap=8, n_i=2, g=2, top_n=3)
CAPS = dict(u_cap=128, i_cap=32)
SPANS = [1, 7, 6_784, 65_536, 65_537, 100_003, 2**31 - 1]


def _assert_states_equal(got, want, what=""):
    for name, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(got[name], w,
                                          err_msg=f"{what}: {name}")


def _flat(j_states):
    return convert.flatten_state(jax.tree.map(np.asarray, j_states))


# -- the sampler ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 12_345])
def test_split_matches_jax(seed):
    want = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), 3)))
    np.testing.assert_array_equal(prng.split(prng.key(seed), 3).numpy(), want)
    # Batched keys split each key.
    keys = prng.fold_in(prng.key(seed), torch.arange(4))
    got = prng.split(keys)
    for r in range(4):
        jk = jax.random.fold_in(jax.random.key(seed), r)
        np.testing.assert_array_equal(
            got[r].numpy(), np.asarray(jax.random.key_data(
                jax.random.split(jk))))


@pytest.mark.parametrize("span", SPANS)
def test_randint_matches_jax_bit_for_bit(span):
    """100 keys a span. Above 2**16 the multiplier's uint32 square wraps
    to 0 and every later product wraps too: without the wrap the draws at
    100,003 and 2**31 - 1 differ from JAX's."""
    data = np.random.default_rng(span % 1000).integers(0, 2**31, 100)
    draw = jax.jit(jax.vmap(lambda d: jax.random.randint(
        jax.random.fold_in(jax.random.key(3), d.astype(jnp.uint32)), (), 0,
        span)))
    want = np.asarray(draw(jnp.asarray(data, jnp.int32)))
    keys = prng.fold_in(prng.key(3), torch.tensor(data))
    got = prng.randint(keys, 0, span)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < span
    # A non-zero low end shifts the same draws.
    np.testing.assert_array_equal(prng.randint(keys, 5, 5 + span).numpy(),
                                  want + 5)


def test_fold_in_takes_one_key_or_a_key_per_entry():
    data = torch.tensor([[0, 1, -1], [7, 2**31 - 1, 3]])
    one = prng.fold_in(prng.key(1), data)
    per = prng.fold_in(prng.key(1).expand(2, 3, 2), data)
    np.testing.assert_array_equal(one.numpy(), per.numpy())
    twice = prng.fold_in(one, data)
    for idx in np.ndindex(2, 3):
        jk = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(1), np.uint32(int(data[idx]) & 0xFFFFFFFF)),
            np.uint32(int(data[idx]) & 0xFFFFFFFF))
        np.testing.assert_array_equal(twice[idx].numpy(),
                                      np.asarray(jax.random.key_data(jk)))


@pytest.mark.parametrize("i_cap", [8, 6_784])
def test_negative_slots_match_jax_sampler(i_cap):
    """The batched replay (bucket-start clock + exclusive cumsum of the
    valid events, padding drawn as u_id 0xFFFFFFFF) against the vmapped
    sampler of ``repro/algos/bpr.py:201``, exactly."""
    rng = np.random.default_rng(i_cap)
    ev_u = rng.integers(0, 10**6, (4, 64)).astype(np.int32)
    ev_u[rng.random(ev_u.shape) < 0.25] = -1
    clock0 = rng.integers(0, 10**5, 4).astype(np.int32)
    key = jax.random.key(5)

    def sample_neg(clock, u_id):      # repro/algos/bpr.py:201
        nkey = jax.random.fold_in(
            jax.random.fold_in(key, clock.astype(jnp.uint32)),
            u_id.astype(jnp.uint32))
        return jax.random.randint(nkey, (), 0, i_cap)

    vi = (ev_u >= 0).astype(np.int32)
    clocks = clock0[:, None] + np.cumsum(vi, 1) - vi
    want = np.asarray(jax.vmap(jax.vmap(sample_neg))(jnp.asarray(clocks),
                                                     jnp.asarray(ev_u)))
    t_clocks = bpr.event_clocks(torch.tensor(clock0), torch.tensor(ev_u >= 0))
    np.testing.assert_array_equal(t_clocks.numpy(), clocks)
    got = bpr.negative_slots(prng.key(5), t_clocks, torch.tensor(ev_u), i_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- worker steps -----------------------------------------------------------


def _buckets(seed, n_w=4, cap=24, n_buckets=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_buckets):
        ev_u = rng.integers(0, 120, (n_w, cap)).astype(np.int32)
        ev_i = rng.integers(0, 40, (n_w, cap)).astype(np.int32)
        pad = rng.random((n_w, cap)) < 0.15
        ev_u[pad] = -1
        ev_i[pad] = -1
        out.append((ev_u, ev_i))
    return out


@pytest.mark.parametrize("fast", [False, True], ids=["eager", "cuda_worker"])
@pytest.mark.parametrize("seed", [0, 1])
def test_worker_matches_jax_bucket_by_bucket(seed, fast):
    n_w = 4
    j_hyper = jbpr.BprHyper(**HYPER)
    t_hyper = bpr.BprHyper(**HYPER)
    j_key, t_key = jax.random.key(seed), prng.key(seed)
    if fast:
        j_step = jax.jit(jax.vmap(jbpr.make_pallas_worker(j_hyper, j_key)))
        t_step = bpr.make_cuda_worker(t_hyper, t_key)
    else:
        j_step = jax.jit(jax.vmap(
            lambda s, ev: jbpr.bpr_worker_step(s, ev, j_hyper, j_key)))

        def t_step(s, ev):
            return bpr.bpr_worker_step(s, ev, t_hyper, t_key)

    one = jstate.init_disgd_state(HYPER["u_cap"], HYPER["i_cap"], HYPER["k"])
    j_state = jax.tree.map(lambda x: jnp.broadcast_to(x, (n_w,) + x.shape),
                           one)
    t_state = state.init_disgd_state(HYPER["u_cap"], HYPER["i_cap"],
                                     HYPER["k"], batch=(n_w,), device="cpu")
    before = ops.launch_counts()["factor_update"]
    moved = 0
    for b, (ev_u, ev_i) in enumerate(_buckets(seed, n_w)):
        iv_before = t_state.item_vecs.clone()
        j_state, j_hits, j_eval = j_step(
            j_state, (jnp.asarray(ev_u), jnp.asarray(ev_i)))
        t_state, t_hits, t_eval = t_step(
            t_state, (torch.tensor(ev_u), torch.tensor(ev_i)))
        _assert_states_equal(convert.states_to_numpy(t_state),
                             _flat(j_state), f"bucket {b}")
        np.testing.assert_array_equal(t_eval.numpy(), np.asarray(j_eval))
        np.testing.assert_array_equal(t_hits.numpy(), np.asarray(j_hits),
                                      err_msg=f"hits, bucket {b}")
        # Some negative steps ran: an item row changed that no event of
        # the bucket named.
        named = np.zeros((n_w, HYPER["i_cap"]), bool)
        for w in range(n_w):
            named[w, (ev_i[w][ev_u[w] >= 0] // HYPER["n_i"])
                  % HYPER["i_cap"]] = True
        changed = (t_state.item_vecs != iv_before).any(-1).numpy()
        moved += int((changed & ~named).sum())
    assert moved > 0
    # On CPU tensors the kernel worker runs the plain versions.
    assert ops.launch_counts()["factor_update"] == before


# -- streams ----------------------------------------------------------------


@pytest.fixture(scope="module")
def stream():
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users, items


def _cfgs(backend_t, backend_j, **over):
    t = rt.StreamConfig(algorithm="bpr", grid=rt.GridSpec(2), micro_batch=256,
                        backend=backend_t, hyper=rt.BprHyper(**CAPS),
                        device="cpu", **over)
    j = jpipe.StreamConfig(algorithm="bpr", grid=JGrid(2), micro_batch=256,
                           backend=backend_j, hyper=jbpr.BprHyper(**CAPS),
                           telemetry=False, **over)
    return t, j


def _assert_results_match(tr, jr, n):
    assert tr.events_processed == jr.events_processed
    assert tr.dropped == jr.dropped
    assert tr.events_processed + tr.dropped == n
    _assert_states_equal(convert.states_to_numpy(tr.final_states),
                         _flat(jr.final_states))
    np.testing.assert_array_equal(np.stack(tr.load_history),
                                  np.stack(jr.load_history))
    np.testing.assert_array_equal(tr.recall.bits(), jr.recall.bits())
    for a, b in zip(tr.user_occupancy + tr.item_occupancy,
                    jr.user_occupancy + jr.item_occupancy):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], np.asarray(b[1]))
    assert len(tr.user_occupancy) == len(jr.user_occupancy)


@pytest.mark.parametrize("backends", [("scan", "scan"), ("cuda", "pallas"),
                                      ("host", "host")],
                         ids=["scan", "cuda", "host"])
def test_run_stream_matches_jax(stream, backends):
    users, items = stream
    t_cfg, j_cfg = _cfgs(*backends)
    tr = rt.run_stream(users, items, t_cfg)
    jr = jpipe.run_stream(users, items, j_cfg)
    _assert_results_match(tr, jr, users.size)
    assert tr.recall.mean() > 0


def test_host_overflow_requeue_matches_jax(stream):
    """Buckets at half the fair share: the host re-queue carries events
    from batch to batch and the drain flushes them, as in JAX."""
    users, items = (x[:1200] for x in stream)
    t_cfg, j_cfg = _cfgs("host", "host", capacity_factor=0.5)
    tr = rt.run_stream(users, items, t_cfg)
    jr = jpipe.run_stream(users, items, j_cfg)
    assert len(tr.load_history) > -(-users.size // 256)   # drain batches
    _assert_results_match(tr, jr, users.size)


def test_bpr_is_registered_and_exported():
    assert "bpr" in algorithm.registered()
    assert isinstance(algorithm.get_algorithm("bpr"), bpr.BprAlgorithm)
    assert rt.BprHyper is bpr.BprHyper
    cfg = rt.StreamConfig(algorithm="bpr")
    assert isinstance(cfg.resolved_hyper(), rt.BprHyper)
    with pytest.raises(KeyError, match="registered"):
        algorithm.get_algorithm("als")


# -- serving ----------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_grid_topn_matches_jax(stream, use_kernel):
    users, items = stream
    j_cfg = _cfgs("cuda", "pallas")[1]
    j_states = jpipe.run_stream(users, items, j_cfg).final_states
    t_states = convert.states_from_numpy(_flat(j_states), device="cpu")
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.choice(np.unique(users), 90, replace=False),
                        [-1, 10**6]]).astype(np.int32)
    kw = dict(algorithm="bpr", top_n=10, u_cap=CAPS["u_cap"],
              qcap=query_capacity(q.size, 2), use_kernel=use_kernel)
    want = jplane.grid_topn(j_states, jnp.asarray(q), grid=JGrid(2), **kw)
    got = rt.grid_topn(t_states, torch.tensor(q), grid=rt.GridSpec(2), **kw)
    for g, w, name in zip(got, want, ("ids", "scores", "known", "served")):
        g, w = g.numpy(), np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3].sum() == 91
