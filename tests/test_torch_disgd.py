"""DISGD worker steps of the PyTorch port against the JAX package.

The eager reference worker (``disgd_worker_step``) and the kernel worker
(``make_cuda_worker``, on CPU tensors its plain kernel versions) run the
same seeded buckets as their JAX counterparts (``disgd_worker_step``
vmapped over workers, and ``make_pallas_worker``), bucket after bucket
from an empty state, with capacities far below the id space so slots
collide and tenants are evicted. Integer state and recall bits must be
equal; factor vectors within 1e-5 (different summation order, and
init vectors from the erfinv polynomial within a few f32 ulp of XLA's).
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import disgd as jdisgd  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro_torch.core import convert, disgd, prng, state  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
HYPER = dict(k=6, u_cap=16, i_cap=8, n_i=2, g=2, top_n=3)


def _buckets(seed, n_w=4, cap=24, n_buckets=3):
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


def _jax_states(n_w):
    one = jstate.init_disgd_state(HYPER["u_cap"], HYPER["i_cap"], HYPER["k"])
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (n_w,) + x.shape), one)


def _compare(t_state, j_state, what):
    got = convert.states_to_numpy(t_state)
    want = convert.flatten_state(jax.tree.map(np.asarray, j_state))
    for name, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(got[name], w,
                                          err_msg=f"{what}: {name}")


@pytest.mark.parametrize("fast", [False, True], ids=["eager", "cuda_worker"])
@pytest.mark.parametrize("seed", [0, 1])
def test_worker_matches_jax_bucket_by_bucket(seed, fast):
    n_w = 4
    j_hyper = jdisgd.DisgdHyper(**HYPER)
    t_hyper = disgd.DisgdHyper(**HYPER)
    j_key = jax.random.key(seed)
    t_key = prng.key(seed)
    if fast:
        j_step = jax.jit(jax.vmap(jdisgd.make_pallas_worker(j_hyper, j_key)))
        t_step = disgd.make_cuda_worker(t_hyper, t_key)
    else:
        j_step = jax.jit(jax.vmap(
            lambda s, ev: jdisgd.disgd_worker_step(s, ev, j_hyper, j_key)))

        def t_step(s, ev):
            return disgd.disgd_worker_step(s, ev, t_hyper, t_key)

    j_state = _jax_states(n_w)
    t_state = state.init_disgd_state(HYPER["u_cap"], HYPER["i_cap"],
                                     HYPER["k"], batch=(n_w,), device="cpu")
    for b, (ev_u, ev_i) in enumerate(_buckets(seed, n_w)):
        j_state, j_hits, j_eval = j_step(
            j_state, (jnp.asarray(ev_u), jnp.asarray(ev_i)))
        t_state, t_hits, t_eval = t_step(
            t_state, (torch.tensor(ev_u), torch.tensor(ev_i)))
        _compare(t_state, j_state, f"bucket {b}")
        np.testing.assert_array_equal(t_eval.numpy(), np.asarray(j_eval))
        np.testing.assert_array_equal(t_hits.numpy(), np.asarray(j_hits),
                                      err_msg=f"hits, bucket {b}")
    # Collisions really happened: more distinct ids than slots.
    assert np.unique(_buckets(seed, n_w)[0][0]).size > HYPER["u_cap"]


def test_bucket_start_hits_ties_go_to_the_lower_slot():
    """Equal scores rank by slot, as lax.top_k does; -inf never hits."""
    scores = torch.tensor([[[1.0, 2.0, 2.0, 2.0, float("-inf")]] * 4])
    i_slots = torch.tensor([[1, 3, 0, 4]], dtype=torch.int32)
    known = torch.ones((1, 4), dtype=torch.bool)
    hits = disgd.bucket_start_hits(scores, i_slots, known, top_n=2)
    # slot 1 (2.0) ranks 0, slot 3 (2.0) ranks 2, slot 0 (1.0) ranks 3.
    assert hits.tolist() == [[True, False, False, False]]
    want = jax.lax.top_k(jnp.asarray(scores[0, 0].numpy()), 2)[1]
    assert sorted(np.asarray(want).tolist()) == [1, 2]
