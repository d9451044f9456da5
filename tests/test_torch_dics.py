"""DICS kernels' plain versions and worker steps of the PyTorch port
against the JAX package.

  * ``ref.dics_apply`` (what ``ops.dics_update`` runs on CPU tensors)
    against the JAX kernel body in interpret mode and against JAX's
    ``ref.dics_apply``, with padding events whose aliased last slots are
    live;
  * ``ref.dics_topn`` against the JAX kernel in interpret mode and
    against ``dics_partial_topn(use_kernel=False)``, with tied masses,
    unknown users and padding queries;
  * the eager worker (``dics_worker_step``) and the kernel worker
    (``make_cuda_worker``) bucket after bucket against JAX's
    ``dics_worker_step`` (vmapped) and ``make_pallas_worker``.

Tolerance: none. ``co`` and ``item_cnt`` hold integer counts, and the
scores follow the two numerics rules of ``repro_torch.kernels.ref``
(f64 square root rounded once, sequential descending sum), so every
array, scores included, must be equal.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import dics as jdics  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import convert, dics, state  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.test_torch_kernels_gpu import (  # noqa: E402
    DICS_EV_NAMES, TABLE_NAMES, _assert_state_equal, _dics_events,
    _dics_state, _dics_topn_inputs, _torch_dics_apply)

HYPER = dict(u_cap=16, i_cap=8, n_i=2, g=2, top_n=3, k_nn=4)


def _jax_dics_apply(st, ev, w, *, interpret):
    tabs = tuple(jnp.asarray(st[n][w]) for n in TABLE_NAMES)
    events = tuple(jnp.asarray(ev[n][w]) for n in DICS_EV_NAMES)
    args = (jnp.asarray(st["co"][w]), jnp.asarray(st["item_cnt"][w]),
            jnp.asarray(st["rated"][w]), tabs, events)
    if interpret is None:
        co, cnt, rated, out_tabs = jref.dics_apply(*args)
    else:
        co, cnt, rated, out_tabs = jops.dics_update(*args, interpret=True)
    return dict(zip(TABLE_NAMES, map(np.asarray, out_tabs)),
                co=np.asarray(co), item_cnt=np.asarray(cnt),
                rated=np.asarray(rated))


@pytest.mark.parametrize("oracle", ["kernel_interpret", "jnp_ref"])
def test_dics_apply_matches_jax(oracle):
    rng = np.random.default_rng(31)
    n_w, u_cap, i_cap, n_ev = 2, 64, 32, 24
    st = _dics_state(rng, n_w, u_cap, i_cap)
    ev = _dics_events(rng, n_w, n_ev, u_cap, i_cap)
    # Padding events alias the last slots, which are live: they clear.
    pad = ev["ev_u"] < 0
    assert pad.any(axis=1).all()
    assert (ev["u_slots"][pad] == u_cap - 1).all()
    assert (st["user_ids"][:, -1] >= 0).all()
    assert (st["item_ids"][:, -1] >= 0).all()

    before = ops.launch_counts()["dics_update"]
    got = _torch_dics_apply(st, ev, "cpu", use_ops=True)
    assert ops.launch_counts()["dics_update"] == before  # CPU: plain version
    for w in range(n_w):
        want = _jax_dics_apply(st, ev, w, interpret=(
            True if oracle == "kernel_interpret" else None))
        _assert_state_equal({n: v[w] for n, v in got.items()}, want,
                            rtol=0, atol=0)
        # The clears fired: the aliased item column of co is now zero
        # unless a later valid event re-filled it.
        assert not np.array_equal(want["co"], st["co"][w])


def test_dics_apply_changes_nothing_when_not_live():
    """A bucket of padding only: its aliased clears run in a live step
    and not in a step the JAX engine skips (``live`` False). Not live,
    the call changes nothing whatever its events."""
    rng = np.random.default_rng(37)
    st = _dics_state(rng, 2, 64, 32)
    ev = {"ev_u": np.full((2, 5), -1, np.int32),
          "ev_i": np.full((2, 5), -1, np.int32),
          "u_slots": np.full((2, 5), 63, np.int32),
          "i_slots": np.full((2, 5), 31, np.int32)}
    got = _torch_dics_apply(st, ev, "cpu", use_ops=True, live=False)
    _assert_state_equal(got, st, rtol=0, atol=0)
    got = _torch_dics_apply(st, ev, "cpu", use_ops=True, live=True)
    assert not got["rated"][:, 63].any() and not got["co"][:, 31].any()
    assert st["rated"][:, 63].any() and st["co"][:, 31].any()
    mixed = _dics_events(rng, 2, 24, 64, 32)
    got = _torch_dics_apply(st, mixed, "cpu", use_ops=True, live=False)
    _assert_state_equal(got, st, rtol=0, atol=0)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("seed", range(2))
def test_dics_topn_matches_jax(seed, ties):
    rng = np.random.default_rng(40 + seed)
    n_w, b, i, top_n, k_nn = 2, 9, 32, 7, 5
    co, cnt, hist, known, ids = _dics_topn_inputs(rng, n_w, b, i, ties=ties)
    got_ids, got_sc = ops.dics_topn(
        *(torch.tensor(x) for x in (co, cnt, hist, known, ids)),
        top_n=top_n, k_nn=k_nn)
    for w in range(n_w):
        want_ids, want_sc = jops.dics_topn(
            jnp.asarray(co[w]), jnp.asarray(cnt[w]), jnp.asarray(hist[w]),
            jnp.asarray(known[w]), jnp.asarray(ids[w]), top_n=top_n,
            k_nn=k_nn, interpret=True)
        np.testing.assert_array_equal(got_ids[w].numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_sc[w].numpy(), np.asarray(want_sc))
    if ties:   # equal masses among the listed candidates: ids decide
        sc = got_sc.numpy()
        assert ((sc[..., 1:] == sc[..., :-1]) & np.isfinite(sc[..., 1:])).any()


def test_dics_partial_topn_matches_jax_leaf():
    """The leaf on a worker state: queries known, unknown and padding."""
    rng = np.random.default_rng(47)
    n_w, u_cap, i_cap = 2, 64, 32
    st = _dics_state(rng, n_w, u_cap, i_cap)
    users = np.concatenate([st["user_ids"][:, :10],
                            np.full((n_w, 2), 10**6), np.full((n_w, 2), -1)],
                           axis=1).astype(np.int32)
    t_state = convert.states_from_numpy(st, device="cpu")
    for use_kernel in (True, False):
        got = dics.dics_partial_topn(t_state, torch.tensor(users), top_n=6,
                                     k_nn=4, u_cap=u_cap,
                                     use_kernel=use_kernel)
        for w in range(n_w):
            j_state = jstate.DicsState(
                jstate.Tables(*(jnp.asarray(st[f][w])
                                for f in jstate.Tables._fields)),
                jnp.asarray(st["co"][w]), jnp.asarray(st["item_cnt"][w]),
                jnp.asarray(st["rated"][w]))
            want = jdics.dics_partial_topn(j_state, jnp.asarray(users[w]),
                                           top_n=6, k_nn=4, u_cap=u_cap,
                                           use_kernel=False)
            for g_, w_ in zip(got, want):
                np.testing.assert_array_equal(g_[w].numpy(), np.asarray(w_))


def _buckets(seed, n_w=4, cap=32, n_buckets=6):
    """Few users and items, so histories grow and recommendations hit;
    still more ids per worker than slots, so tenants are evicted."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_buckets):
        ev_u = rng.integers(0, 36, (n_w, cap)).astype(np.int32)
        ev_i = rng.integers(0, 20, (n_w, cap)).astype(np.int32)
        pad = rng.random((n_w, cap)) < 0.15
        ev_u[pad] = -1
        ev_i[pad] = -1
        out.append((ev_u, ev_i))
    return out


def _jax_states(n_w):
    one = jstate.init_dics_state(HYPER["u_cap"], HYPER["i_cap"])
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n_w,) + x.shape), one)


@pytest.mark.parametrize("fast", [False, True], ids=["eager", "cuda_worker"])
@pytest.mark.parametrize("seed", [0, 1])
def test_worker_matches_jax_bucket_by_bucket(seed, fast):
    n_w = 4
    j_hyper = jdics.DicsHyper(**HYPER)
    t_hyper = dics.DicsHyper(**HYPER)
    if fast:
        j_step = jax.jit(jax.vmap(jdics.make_pallas_worker(j_hyper)))
        t_step = dics.make_cuda_worker(t_hyper)
    else:
        j_step = jax.jit(jax.vmap(
            lambda s, ev: jdics.dics_worker_step(s, ev, j_hyper)))

        def t_step(s, ev):
            return dics.dics_worker_step(s, ev, t_hyper)

    j_state = _jax_states(n_w)
    t_state = state.init_dics_state(HYPER["u_cap"], HYPER["i_cap"],
                                    batch=(n_w,), device="cpu")
    n_hits = 0
    for b, (ev_u, ev_i) in enumerate(_buckets(seed, n_w)):
        j_state, j_hits, j_eval = j_step(
            j_state, (jnp.asarray(ev_u), jnp.asarray(ev_i)))
        t_state, t_hits, t_eval = t_step(
            t_state, (torch.tensor(ev_u), torch.tensor(ev_i)))
        want = convert.flatten_state(jax.tree.map(np.asarray, j_state))
        _assert_state_equal(convert.states_to_numpy(t_state), want,
                            rtol=0, atol=0)
        np.testing.assert_array_equal(t_eval.numpy(), np.asarray(j_eval))
        np.testing.assert_array_equal(t_hits.numpy(), np.asarray(j_hits),
                                      err_msg=f"hits, bucket {b}")
        n_hits += int(t_hits.sum())
    assert n_hits > 0
    # Collisions really happened: more distinct ids than slots.
    assert np.unique(_buckets(seed, n_w)[0][0]).size > HYPER["u_cap"]
