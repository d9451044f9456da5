"""Plain kernel versions of the PyTorch port against the JAX kernels.

Each plain version in ``repro_torch.kernels.ref`` (what the ``ops``
wrappers run on CPU tensors) against the JAX kernel body in interpret
mode (``repro.kernels.ops.*(..., interpret=True)``), on the same seeded
numpy inputs. The CUDA kernels against these plain versions, on the
card, are in ``test_torch_kernels_gpu.py``.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.test_torch_kernels_gpu import (  # noqa: E402
    ATOL, RTOL, TABLE_NAMES, _EV_NAMES, _assert_state_equal, _events,
    _score_inputs, _torch_factor_apply, _worker_state)


# -- CPU parity against the JAX kernels (interpret mode) ------------------


@pytest.mark.parametrize("pairwise", [False, True], ids=["isgd", "bpr"])
def test_factor_apply_matches_jax_kernel(pairwise):
    rng = np.random.default_rng(3 + pairwise)
    n_w, u_cap, i_cap, k, n_ev = 2, 16, 8, 6, 24
    st = _worker_state(rng, n_w, u_cap, i_cap, k)
    ev = _events(rng, n_w, n_ev, u_cap, i_cap, k, pairwise)
    before = ops.launch_counts()["factor_update"]
    got = _torch_factor_apply(st, ev, "cpu", eta=0.05, lam=0.01, use_ops=True)
    assert ops.launch_counts()["factor_update"] == before  # CPU: plain version

    for w in range(n_w):
        tabs = tuple(jnp.asarray(st[n][w]) for n in TABLE_NAMES)
        events = tuple(None if ev[n] is None else jnp.asarray(ev[n][w])
                       for n in _EV_NAMES)
        uv, iv, rated, out_tabs = jops.factor_update(
            jnp.asarray(st["user_vecs"][w]), jnp.asarray(st["item_vecs"][w]),
            jnp.asarray(st["rated"][w]), tabs, events, eta=0.05, lam=0.01,
            interpret=True)
        want = dict(zip(TABLE_NAMES, map(np.asarray, out_tabs)),
                    user_vecs=np.asarray(uv), item_vecs=np.asarray(iv),
                    rated=np.asarray(rated))
        _assert_state_equal({n: v[w] for n, v in got.items()}, want)


def test_masked_scores_matches_jax_kernel():
    rng = np.random.default_rng(5)
    u, it, mask, _ = _score_inputs(rng, 2, 9, 37, 8)
    got = ops.masked_scores(torch.tensor(u), torch.tensor(it),
                            torch.tensor(mask)).numpy()
    for w in range(2):
        want = np.asarray(jops.masked_scores(
            jnp.asarray(u[w]), jnp.asarray(it[w]), jnp.asarray(mask[w]),
            interpret=True))
        np.testing.assert_array_equal(np.isneginf(got[w]), np.isneginf(want))
        np.testing.assert_allclose(got[w], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("seed", range(3))
def test_fused_topn_matches_jax_kernel(seed, ties):
    """Ties, duplicate ids, empty (-1) slots and a fully masked row: the
    list order is (score desc, id asc) with -inf entries keeping ids."""
    rng = np.random.default_rng(seed)
    u, it, mask, ids = _score_inputs(rng, 2, 9, 37, 8, ties=ties)
    got_ids, got_sc = ops.fused_topn(torch.tensor(u), torch.tensor(it),
                                     torch.tensor(mask), torch.tensor(ids),
                                     top_n=7)
    for w in range(2):
        want_ids, want_sc = jops.fused_topn(
            jnp.asarray(u[w]), jnp.asarray(it[w]), jnp.asarray(mask[w]),
            jnp.asarray(ids[w]), top_n=7, interpret=True)
        np.testing.assert_array_equal(got_ids[w].numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(got_sc[w].numpy(), np.asarray(want_sc),
                                   rtol=RTOL, atol=ATOL)


def test_topn_merge_matches_jax():
    rng = np.random.default_rng(9)
    sc = rng.integers(-3, 3, (5, 3, 4)).astype(np.float32)
    sc[sc == -3] = -np.inf
    ids = rng.integers(-1, 20, (5, 3, 4)).astype(np.int32)
    want_ids, want_sc = jops.topn_merge(jnp.asarray(ids), jnp.asarray(sc), 6)
    got_ids, got_sc = ops.topn_merge(torch.tensor(ids), torch.tensor(sc), 6)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_sc.numpy(), np.asarray(want_sc))


def test_wrappers_refuse_mixed_devices_and_bad_shapes():
    u = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError):
        ops.masked_scores(u, torch.zeros(1, 4, 3, device="meta"),
                          torch.zeros(1, 2, 4, dtype=torch.bool))
