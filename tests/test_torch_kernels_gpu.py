"""The CUDA kernels of the PyTorch port against their plain versions.

Every test carries the ``gpu`` marker and needs a CUDA device (decided in
the ``cuda_device`` fixture, never at import): each kernel runs on the
same CUDA tensors as its plain version in ``repro_torch.kernels.ref``, at
small shapes and at the main path's shapes. This file imports no jax, so
it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

The seeded input helpers here are shared with ``test_torch_kernels.py``.
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

# Float tolerances: the two sides sum the k products in different
# orders (and XLA / nvcc may contract into FMAs), a few f32 ulp.
RTOL, ATOL = 1e-5, 1e-6
TABLE_NAMES = ("user_ids", "item_ids", "user_freq", "item_freq", "user_ts",
               "item_ts", "clock")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only "
                    "on the card")
    return torch.device("cuda")


def _worker_state(rng, n_w, u_cap, i_cap, k):
    """Slot-consistent random worker states (numpy), some slots empty."""
    uid = np.where(rng.random((n_w, u_cap)) < 0.6,
                   np.arange(u_cap) + u_cap * rng.integers(0, 2, (n_w, u_cap)),
                   -1).astype(np.int32)
    iid = np.where(rng.random((n_w, i_cap)) < 0.6,
                   np.arange(i_cap) + i_cap * rng.integers(0, 2, (n_w, i_cap)),
                   -1).astype(np.int32)
    return {
        "user_ids": uid, "item_ids": iid,
        "user_freq": rng.integers(0, 5, (n_w, u_cap)).astype(np.int32),
        "item_freq": rng.integers(0, 5, (n_w, i_cap)).astype(np.int32),
        "user_ts": rng.integers(0, 50, (n_w, u_cap)).astype(np.int32),
        "item_ts": rng.integers(0, 50, (n_w, i_cap)).astype(np.int32),
        "clock": rng.integers(50, 60, n_w).astype(np.int32),
        "user_vecs": (rng.normal(size=(n_w, u_cap, k)) * 0.3).astype(np.float32),
        "item_vecs": (rng.normal(size=(n_w, i_cap, k)) * 0.3).astype(np.float32),
        "rated": rng.random((n_w, u_cap, i_cap)) < 0.3,
    }


def _events(rng, n_w, n_ev, u_cap, i_cap, k, pairwise):
    """Events with slot collisions (ids span twice the caps) and padding."""
    ev_u = rng.integers(0, 2 * u_cap, (n_w, n_ev)).astype(np.int32)
    ev_i = rng.integers(0, 2 * i_cap, (n_w, n_ev)).astype(np.int32)
    pad = rng.random((n_w, n_ev)) < 0.2
    ev_u[pad] = -1
    ev_i[pad] = -1
    return {
        "ev_u": ev_u, "ev_i": ev_i,
        "u_slots": (ev_u % u_cap).astype(np.int32),
        "i_slots": (ev_i % i_cap).astype(np.int32),
        "j_slots": (rng.integers(0, i_cap, (n_w, n_ev)).astype(np.int32)
                    if pairwise else None),
        "init_u": (rng.normal(size=(n_w, n_ev, k)) * 0.1).astype(np.float32),
        "init_i": (rng.normal(size=(n_w, n_ev, k)) * 0.1).astype(np.float32),
    }


_EV_NAMES = ("ev_u", "ev_i", "u_slots", "i_slots", "j_slots", "init_u",
             "init_i")


def _torch_factor_apply(st, ev, device, *, eta, lam, use_ops):
    t = {n: torch.tensor(v, device=device) for n, v in st.items()}
    e = tuple(None if ev[n] is None else torch.tensor(ev[n], device=device)
              for n in _EV_NAMES)
    tabs = tuple(t[n] for n in TABLE_NAMES)
    fn = ops.factor_update if use_ops else ref.factor_apply
    fn(t["user_vecs"], t["item_vecs"], t["rated"], tabs, e, eta=eta, lam=lam)
    return {n: v.cpu().numpy() for n, v in t.items()}


def _assert_state_equal(got, want, rtol=RTOL, atol=ATOL):
    for name, w in want.items():
        g = got[name]
        if np.asarray(w).dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _score_inputs(rng, n_w, b, i, k, ties=False):
    if ties:   # small-integer factors: exact dot products, many ties
        u = rng.integers(-2, 3, (n_w, b, k)).astype(np.float32)
        it = rng.integers(-2, 3, (n_w, i, k)).astype(np.float32)
        ids = rng.choice([-1, 2, 3, 5, 5, 8, 13, 21], size=(n_w, i))
    else:
        u = rng.normal(size=(n_w, b, k)).astype(np.float32)
        it = rng.normal(size=(n_w, i, k)).astype(np.float32)
        ids = np.where(rng.random((n_w, i)) < 0.8,
                       rng.permutation(10 * i)[:i], -1)
    mask = rng.random((n_w, b, i)) < 0.7
    mask[:, 0, :] = False                       # one fully masked row
    return u, it, mask, ids.astype(np.int32)




@pytest.mark.gpu
@pytest.mark.parametrize("pairwise", [False, True], ids=["isgd", "bpr"])
@pytest.mark.parametrize("shape", [(2, 16, 8, 6, 24), (4, 300, 70, 10, 64)],
                         ids=["tiny", "small"])
def test_factor_update_kernel_matches_plain(cuda_device, pairwise, shape):
    n_w, u_cap, i_cap, k, n_ev = shape
    rng = np.random.default_rng(11)
    st = _worker_state(rng, n_w, u_cap, i_cap, k)
    ev = _events(rng, n_w, n_ev, u_cap, i_cap, k, pairwise)
    before = ops.launch_counts()["factor_update"]
    got = _torch_factor_apply(st, ev, cuda_device, eta=0.05, lam=0.01,
                              use_ops=True)
    assert ops.launch_counts()["factor_update"] == before + 1
    want = _torch_factor_apply(st, ev, cuda_device, eta=0.05, lam=0.01,
                               use_ops=False)
    _assert_state_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 9, 37, 8), (16, 256, 6784, 10)],
                         ids=["tiny", "main_path"])
def test_masked_scores_kernel_matches_plain(cuda_device, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(13)
    u, it, mask, _ = _score_inputs(rng, *shape)
    args = [torch.tensor(x, device=cuda_device) for x in (u, it, mask)]
    got = ops.masked_scores(*args).cpu().numpy()
    want = ref.masked_scores(*args).cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("shape", [(2, 9, 37, 8), (16, 512, 6784, 10)],
                         ids=["tiny", "main_path"])
def test_fused_topn_kernel_matches_plain(cuda_device, shape, ties):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(17)
    u, it, mask, ids = _score_inputs(rng, *shape, ties=ties)
    args = [torch.tensor(x, device=cuda_device) for x in (u, it, mask, ids)]
    got_ids, got_sc = (x.cpu().numpy() for x in ops.fused_topn(*args, top_n=10))
    want_ids, want_sc = (x.cpu().numpy()
                         for x in ref.fused_topn(*args, top_n=10))
    np.testing.assert_allclose(got_sc, want_sc, rtol=RTOL, atol=ATOL)
    if ties:   # integer factors: scores exact, so ids must match exactly
        np.testing.assert_array_equal(got_ids, want_ids)
    else:      # ids equal wherever neighbouring scores are clearly apart
        gap = np.abs(np.diff(want_sc, axis=-1))
        sep = np.ones_like(want_sc, dtype=bool)
        near = ~((gap > 1e-4) | np.isnan(gap))
        sep[..., 1:] &= ~near
        sep[..., :-1] &= ~near
        np.testing.assert_array_equal(got_ids[sep], want_ids[sep])


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "scan"])
def test_stream_loop_never_waits_for_the_card(cuda_device, backend):
    """Each step of the device loop only enqueues work: under CUDA's
    sync debug mode "error", a host synchronisation (``.item()``, a
    copy from pageable host memory, ``nonzero``) raises."""
    import repro_torch as rt
    from repro_torch.core import engine
    from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream
    from repro_torch.kernels import build

    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    cfg = rt.StreamConfig(grid=rt.GridSpec(2), micro_batch=256,
                          hyper=rt.DisgdHyper(u_cap=128, i_cap=32),
                          backend=backend, device="cuda")
    n = 4 * cfg.micro_batch
    xs_u = torch.tensor(users[:n].reshape(4, -1), dtype=torch.int32,
                        device=cuda_device)
    xs_i = torch.tensor(items[:n].reshape(4, -1), dtype=torch.int32,
                        device=cuda_device)
    build.build_all()
    step = engine._make_batch_step(cfg, engine.make_worker_fn(cfg, backend))
    carry = engine.init_scan_carry(cfg)
    carry, _ = step(carry, xs_u[0], xs_i[0])   # first launches initialise
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s in range(1, 4):
            carry, _ = step(carry, xs_u[s], xs_i[s])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    processed, requeued, dropped = (int(carry[3]), int((carry[1] >= 0).sum()),
                                    int(carry[4]))
    assert processed + requeued + dropped == n
