"""Grid serving of the PyTorch port against the JAX package.

``grid_topn`` (kernel leaf and plain leaf) and ``recommend_topn`` on the
same states in both packages — a trained grid and randomized
slot-consistent grids — with ids, known and served flags exactly equal
and scores within 1e-6; and the two invariants pinned for the JAX plane
in ``tests/test_serve_grid.py``: the merge equals the single worker at
``n_i = 1``, and permuting the item splits changes nothing.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.core import serve as jserve  # noqa: E402
from repro.core.disgd import DisgdHyper as JHyper  # noqa: E402
from repro.core.pipeline import StreamConfig as JConfig, run_stream as jrun  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro.serve import plane as jplane  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.serve.plane import query_capacity  # noqa: E402
from tests.test_serve_grid import _queries, _random_grid_disgd  # noqa: E402

ATOL = 1e-6


def _to_torch(j_states):
    flat = convert.flatten_state(jax.tree.map(np.asarray, j_states))
    return convert.states_from_numpy(flat, device="cpu")


def _assert_same(got, want):
    for g, w, name in zip(got, want, ("ids", "scores", "known", "served")):
        g, w = g.numpy(), np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def trained():
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    res = jrun(users, items, JConfig(grid=JGrid(2), micro_batch=256,
                                     backend="pallas",
                                     hyper=JHyper(u_cap=128, i_cap=32),
                                     telemetry=False))
    return res.final_states, users


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_grid_topn_matches_jax_on_trained_state(trained, use_kernel):
    j_states, users = trained
    rng = np.random.default_rng(2)
    q = np.concatenate([rng.choice(np.unique(users), 90, replace=False),
                        [-1, 10**6, -1]]).astype(np.int32)
    qcap = query_capacity(q.size, 2)
    kw = dict(algorithm="disgd", top_n=10, u_cap=128, qcap=qcap,
              use_kernel=use_kernel)
    want = jplane.grid_topn(j_states, jnp.asarray(q), grid=JGrid(2), **kw)
    got = rt.grid_topn(_to_torch(j_states), torch.tensor(q),
                       grid=rt.GridSpec(2), **kw)
    _assert_same(got, want)
    assert got[3].sum() == 91      # all but padding served


def test_grid_topn_column_overflow_matches_jax(trained):
    """qcap below the column load: the overflow is reported un-served."""
    j_states, users = trained
    q = np.unique(users)[:60].astype(np.int32)
    kw = dict(algorithm="disgd", top_n=5, u_cap=128, qcap=8)
    want = jplane.grid_topn(j_states, jnp.asarray(q), grid=JGrid(2), **kw)
    got = rt.grid_topn(_to_torch(j_states), torch.tensor(q),
                       grid=rt.GridSpec(2), **kw)
    _assert_same(got, want)
    assert not got[3].all()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (3, 3), (2, 3)])
def test_grid_topn_matches_jax_on_random_grids(seed, shape):
    n_i, g = shape
    j_states = _random_grid_disgd(seed, n_i, g)
    q = _queries(j_states, n_i, g, np.random.default_rng(seed))
    kw = dict(algorithm="disgd", top_n=10, u_cap=24, qcap=int(q.shape[0]))
    want = jplane.grid_topn(j_states, q, grid=JGrid.rect(n_i, g), **kw)
    got = rt.grid_topn(_to_torch(j_states), torch.tensor(np.asarray(q)),
                       grid=rt.GridSpec.rect(n_i, g), **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_merge_equals_single_worker_at_ni1(seed):
    u_cap = 24
    states = _to_torch(_random_grid_disgd(seed, 1, 1, u_cap=u_cap, i_cap=16))
    q = torch.tensor(np.asarray(_queries(
        _random_grid_disgd(seed, 1, 1, u_cap=u_cap, i_cap=16), 1, 1,
        np.random.default_rng(seed))))
    ids_g, sc_g, _, served = rt.grid_topn(
        states, q, algorithm="disgd", grid=rt.GridSpec.rect(1, 1), top_n=10,
        u_cap=u_cap, qcap=q.shape[0])
    one = jax.tree.map(lambda x: x[0], states)
    ids_s, sc_s = rt.recommend_topn(one, q, top_n=10, g=1, u_cap=u_cap)
    assert torch.equal(ids_g, ids_s) and torch.equal(sc_g, sc_s)
    assert bool(served.all())


@pytest.mark.parametrize("seed,n_i", [(s, n) for s in range(3) for n in (2, 3)])
def test_merge_invariant_under_split_permutation(seed, n_i):
    g = n_i
    j_states = _random_grid_disgd(seed, n_i, g)
    q = torch.tensor(np.asarray(_queries(j_states, n_i, g,
                                         np.random.default_rng(seed))))
    states = _to_torch(j_states)
    kw = dict(algorithm="disgd", grid=rt.GridSpec.rect(n_i, g), top_n=10,
              u_cap=24, qcap=q.shape[0])
    a = rt.grid_topn(states, q, **kw)
    perm = torch.tensor(np.random.default_rng(seed + 1).permutation(n_i))
    permuted = jax.tree.map(
        lambda x: x.reshape((n_i, g) + x.shape[1:])[perm].reshape(x.shape),
        states)
    b = rt.grid_topn(permuted, q, **kw)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


def test_recommend_topn_matches_jax(trained):
    j_states, users = trained
    one = jax.tree.map(lambda x: x[1], j_states)
    q = np.unique(users)[:40].astype(np.int32)
    want = jserve.recommend_topn(one, jnp.asarray(q), top_n=8, g=2, u_cap=128)
    states = _to_torch(j_states)
    got = rt.recommend_topn(jax.tree.map(lambda x: x[1], states),
                            torch.tensor(q), top_n=8, g=2, u_cap=128)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL)
