"""Foundations of the PyTorch port against the JAX package, exactly.

Routing and bucketing, slot mapping and occupancy, the threefry PRNG and
the replica-consistent init vectors, and the numpy copies of the stream
generator and the recall accumulator. Inputs are seeded numpy arrays
handed to both packages.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import routing as jrouting  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.disgd import init_vector as j_init_vector  # noqa: E402
from repro.core.evaluator import RecallAccumulator as JAcc  # noqa: E402
from repro.data import stream as jstream  # noqa: E402
from repro_torch.core import prng, routing, state  # noqa: E402
from repro_torch.core.disgd import init_vector  # noqa: E402
from repro_torch.core.evaluator import RecallAccumulator  # noqa: E402
from repro_torch.data import stream  # noqa: E402


@pytest.mark.parametrize("n_i,w", [(1, 0), (2, 0), (3, 1), (4, 0), (2, -1)])
def test_route_key_matches_jax(n_i, w):
    rng = np.random.default_rng(n_i * 10 + w)
    u = rng.integers(0, 10_000, 500)
    i = rng.integers(0, 3_000, 500)
    want = np.asarray(jrouting.route_key(u, i, jrouting.GridSpec(n_i, w)))
    got = routing.route_key(torch.tensor(u), torch.tensor(i),
                            routing.GridSpec(n_i, w)).numpy()
    np.testing.assert_array_equal(got, want)
    grid = routing.GridSpec(n_i, w)
    assert (grid.g, grid.n_c) == (jrouting.GridSpec(n_i, w).g,
                                  jrouting.GridSpec(n_i, w).n_c)


@pytest.mark.parametrize("n_workers,capacity,b,seed",
                         [(4, 8, 64, 0), (16, 3, 200, 1), (3, 40, 50, 2),
                          (9, 1, 30, 3)])
def test_bucket_dispatch_matches_jax(n_workers, capacity, b, seed):
    """Overflow (capacity below the fair share), invalid keys (== n_workers)
    and empty workers; buckets, kept and load exactly equal."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_workers + 1, b).astype(np.int32)
    want = jrouting.bucket_dispatch(jnp.asarray(keys), n_workers, capacity)
    got = routing.bucket_dispatch(torch.tensor(keys), n_workers, capacity)
    for g, w_, name in zip(got, want, ("buckets", "kept", "load")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=name)


def test_slots_and_occupancy_match_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 100_000, 1000).astype(np.int32)
    for n_splits, cap in ((1, 16), (4, 38_912), (3, 7)):
        np.testing.assert_array_equal(
            state.slot_of(torch.tensor(ids), n_splits, cap).numpy(),
            np.asarray(jstate.slot_of(jnp.asarray(ids), n_splits, cap)))
    grid = routing.GridSpec(3, 1)
    np.testing.assert_array_equal(
        state.user_slot(torch.tensor(ids), grid, 50).numpy(),
        np.asarray(jstate.user_slot(jnp.asarray(ids),
                                    jrouting.GridSpec(3, 1), 50)))
    np.testing.assert_array_equal(
        state.item_slot(torch.tensor(ids), grid, 50).numpy(),
        np.asarray(jstate.item_slot(jnp.asarray(ids),
                                    jrouting.GridSpec(3, 1), 50)))

    st = state.init_disgd_state(24, 12, 4, batch=(3,), device="cpu")
    jst = jstate.init_disgd_state(24, 12, 4)
    for a, b in zip(jax.tree.leaves(jst), (st.tables + (st.user_vecs,
                                                        st.item_vecs,
                                                        st.rated))):
        assert tuple(b.shape) == (3,) + tuple(a.shape)
        np.testing.assert_array_equal(b[1].numpy(), np.asarray(a))
    uid = np.where(rng.random((3, 24)) < 0.5, 7, -1).astype(np.int32)
    iid = np.where(rng.random((3, 12)) < 0.5, 7, -1).astype(np.int32)
    got = state.occupancy(st.tables._replace(user_ids=torch.tensor(uid),
                                             item_ids=torch.tensor(iid)))
    for w in range(3):
        want = jstate.occupancy(jst.tables._replace(
            user_ids=jnp.asarray(uid[w]), item_ids=jnp.asarray(iid[w])))
        assert (int(got[0][w]), int(got[1][w])) == tuple(map(int, want))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_fold_in_bits_match_jax_exactly(seed):
    data = np.concatenate([np.arange(-3, 200), [2**31 - 1, 123_456_789]])
    key = jax.random.key(seed)
    want = np.asarray(jax.vmap(lambda d: jax.random.bits(
        jax.random.fold_in(key, d.astype(jnp.uint32)), (12,)))(
            jnp.asarray(data, jnp.int32)))
    got = prng.bits(prng.fold_in(prng.key(seed), torch.tensor(data)), 12)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        prng.key(seed).numpy(), np.asarray(jax.random.key_data(key)))


def test_init_vector_matches_jax():
    """Normal draws through the Giles erfinv polynomial: within a few f32
    ulp of XLA's (which may fuse the polynomial into FMAs), atol 1e-6."""
    ids = np.arange(-1, 4095).astype(np.int32)
    key = jax.random.key(0)
    want = np.asarray(jax.vmap(
        lambda i: j_init_vector(key, i, 10, 0.1))(jnp.asarray(ids)))
    got = init_vector(prng.key(0), torch.tensor(ids), 10, 0.1).numpy()
    assert got.shape == (4096, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("profile", ["movielens", "netflix_drift"])
def test_stream_copy_matches_jax(profile):
    if profile == "movielens":
        mine = stream.scaled(stream.MOVIELENS_25M, 0.002)
        theirs = jstream.scaled(jstream.MOVIELENS_25M, 0.002)
    else:
        mine = stream.scaled(stream.NETFLIX, 0.001, drift_points=(0.5,))
        theirs = jstream.scaled(jstream.NETFLIX, 0.001, drift_points=(0.5,))
    assert dataclasses_equal(mine, theirs)
    for a, b in zip(stream.synth_stream(mine, seed=3),
                    jstream.synth_stream(theirs, seed=3)):
        np.testing.assert_array_equal(a, b)


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_recall_accumulator_matches_jax():
    rng = np.random.default_rng(8)
    mine, theirs = RecallAccumulator(), JAcc()
    for _ in range(3):
        buckets = np.where(rng.random((4, 6)) < 0.7,
                           rng.permutation(30)[:24].reshape(4, 6), -1)
        hits = rng.random((4, 6)) < 0.4
        ev = rng.random((4, 6)) < 0.9
        mine.add_batch(buckets, hits, ev, 30)
        theirs.add_batch(buckets, hits, ev, 30)
    raw = np.where(rng.random(50) < 0.5, np.nan, rng.random(50) < 0.3)
    mine.add_raw(raw)
    theirs.add_raw(raw)
    np.testing.assert_array_equal(mine.bits(), theirs.bits())
    np.testing.assert_allclose(mine.curve(window=7), theirs.curve(window=7))
    assert mine.mean() == theirs.mean()
