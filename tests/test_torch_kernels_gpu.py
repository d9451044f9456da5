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


def _events(rng, n_w, n_ev, u_cap, i_cap, k, pairwise, padding="random"):
    """Events with slot collisions (ids span twice the caps) and padding:
    ``"random"`` 20% interleaved, ``"tail"`` the last 40% (as the engine
    lays a bucket out), ``"all"`` every event."""
    ev_u = rng.integers(0, 2 * u_cap, (n_w, n_ev)).astype(np.int32)
    ev_i = rng.integers(0, 2 * i_cap, (n_w, n_ev)).astype(np.int32)
    pad = {"random": rng.random((n_w, n_ev)) < 0.2,
           "tail": np.arange(n_ev) >= n_ev * 3 // 5,
           "all": np.ones((n_w, n_ev), bool)}[padding]
    pad = np.broadcast_to(pad, (n_w, n_ev))
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


def _negatives(rng, st, ev, kind):
    """Re-draws the pairwise cases' negative slots (in place): ``"random"``
    keeps ``_events``' uniform slots; ``"mixed"`` takes half of them from
    the bucket's own item slots (collisions make many of those evicted
    columns, or slots rated earlier in the bucket) and a tenth from the
    event's own item slot; ``"alias"`` sets every other one to the
    event's own item slot; ``"empty"`` leaves the slots and empties 80%
    of the item tenants. Returns ``(st, ev)``."""
    if kind == "random" or ev["j_slots"] is None:
        return st, ev
    js, is_ = ev["j_slots"], ev["i_slots"]
    n_w, n_ev = js.shape
    if kind == "mixed":
        pick = rng.random((n_w, n_ev))
        other = np.take_along_axis(is_, rng.integers(0, n_ev, (n_w, n_ev)), 1)
        js[:] = np.where(pick < 0.5, other, np.where(pick < 0.6, is_, js))
    elif kind == "alias":
        js[:, ::2] = is_[:, ::2]
    elif kind == "empty":
        st["item_ids"][rng.random(st["item_ids"].shape) < 0.8] = -1
    else:
        raise ValueError(kind)
    return st, ev


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


DICS_EV_NAMES = ("ev_u", "ev_i", "u_slots", "i_slots")


def _dics_state(rng, n_w, u_cap, i_cap):
    """Slot-consistent DICS worker states (numpy) with integer counts; the
    last user and item slots are live, so padding events (id -1, which
    alias slot ``cap - 1``) clear them."""
    st = _worker_state(rng, n_w, u_cap, i_cap, 1)
    del st["user_vecs"], st["item_vecs"]
    st["user_ids"][:, -1] = 2 * u_cap - 1
    st["item_ids"][:, -1] = 2 * i_cap - 1
    co = rng.integers(0, 5, (n_w, i_cap, i_cap))
    st["co"] = (co + co.transpose(0, 2, 1)).astype(np.float32)
    st["item_cnt"] = rng.integers(0, 9, (n_w, i_cap)).astype(np.float32)
    return st


def _dics_events(rng, n_w, n_ev, u_cap, i_cap, padding="random"):
    ev = _events(rng, n_w, n_ev, u_cap, i_cap, 1, False, padding)
    return {n: ev[n] for n in DICS_EV_NAMES}


def _torch_dics_apply(st, ev, device, *, use_ops, live=None):
    t = {n: torch.tensor(v, device=device) for n, v in st.items()}
    e = tuple(torch.tensor(ev[n], device=device) for n in DICS_EV_NAMES)
    tabs = tuple(t[n] for n in TABLE_NAMES)
    if live is not None:
        live = torch.tensor(live, device=device)
    if use_ops:
        ops.dics_update(t["co"], t["item_cnt"], t["rated"], tabs, e,
                        live=live)
    else:
        ref.dics_apply(t["co"], t["item_cnt"], t["rated"], tabs, e,
                       live=live)
    return {n: v.cpu().numpy() for n, v in t.items()}


def _dics_topn_inputs(rng, n_w, b, i, ties=False):
    """co / item_cnt / hist / known / item_ids for the DICS serve leaf.
    ``ties``: counts from a few small values, so many masses are equal
    and the id order decides."""
    hi = 3 if ties else 40
    co = rng.integers(0, hi, (n_w, i, i))
    co = (co + co.transpose(0, 2, 1)).astype(np.float32)
    cnt = (rng.choice([0, 2, 4], (n_w, i)) if ties
           else rng.integers(0, 60, (n_w, i))).astype(np.float32)
    ids = np.where(rng.random((n_w, i)) < 0.85,
                   rng.permutation(10 * i)[:i], -1).astype(np.int32)
    known = rng.random((n_w, b)) < 0.8
    known[:, 0] = False                         # an unknown user
    hist = (rng.random((n_w, b, i)) < 0.15) & known[..., None]
    hist[:, 1 % b, :] = False                   # a known user, no history
    return co, cnt, hist, known, ids


def _isgd_inputs(rng, u_cap, i_cap, k, n_ev):
    """Tables, slots drawn with repeats (a chain through the same rows)
    and ~15% invalid events, as ``tests/test_kernels.py``'s sweep."""
    return {
        "user_tab": (rng.normal(size=(u_cap, k)) * 0.1).astype(np.float32),
        "item_tab": (rng.normal(size=(i_cap, k)) * 0.1).astype(np.float32),
        "u_slots": rng.integers(0, u_cap, n_ev).astype(np.int32),
        "i_slots": rng.integers(0, i_cap, n_ev).astype(np.int32),
        "valid": rng.random(n_ev) > 0.15,
    }


ISGD_NAMES = ("user_tab", "item_tab", "u_slots", "i_slots", "valid")

# swa_attention tolerances against the plain version, the JAX kernel
# tests' own (tests/test_kernels.py:78 and :90): f32 sums in other orders;
# bf16 rounds P to bf16 before P.V in the kernels, not in the plain one.
SWA_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
           "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _swa_inputs(rng, b, hq, hkv, s, d):
    """q [B, Hq, S, D], k / v [B, Hkv, S, D], standard normal (f32)."""
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


# The staged kernels' hard cases (csrc/bucket_stage.cuh): "dense" hits six
# user and five item slots sixty times a worker (a slot hit many times, an
# eviction between two uses of a slot, a user evicted and re-added in one
# bucket); "wide" is a bucket of 600 events, over two staged chunks of
# 256; padding interleaved, at the tail, or everywhere. The pairwise
# mode's own (negative slots by ``_negatives``): "alias" (j == i on every
# other event), "empty_tenants" (most negatives on empty slots),
# "dense_mixed" (negatives on the bucket's own item slots, whose tenants
# and rated bytes the bucket changes) and "wide_mixed" (the same over
# three chunks, so a chunk reads bytes the previous one wrote); a kernel
# that read the rated byte or the tenant as staged, without the chunk's
# earlier events, fails them. (n_w, u_cap, i_cap, k, n_ev), padding,
# negatives.
FACTOR_CASES = {
    "tiny": ((2, 16, 8, 6, 24), "random", "random"),
    "small": ((4, 300, 70, 10, 64), "random", "random"),
    "dense": ((2, 6, 5, 4, 60), "random", "random"),
    "wide": ((3, 40, 24, 10, 600), "random", "random"),
    "tail_padding": ((2, 12, 9, 10, 40), "tail", "random"),
    "all_padding": ((2, 12, 9, 10, 40), "all", "random"),
    "alias": ((2, 6, 5, 4, 60), "random", "alias"),
    "empty_tenants": ((2, 12, 9, 10, 40), "random", "empty"),
    "dense_mixed": ((2, 6, 5, 4, 60), "random", "mixed"),
    "wide_mixed": ((2, 8, 6, 10, 700), "random", "mixed"),
}


def _factor_case(shape, pairwise, seed=11):
    (n_w, u_cap, i_cap, k, n_ev), padding, negs = FACTOR_CASES[shape]
    rng = np.random.default_rng(seed)
    st = _worker_state(rng, n_w, u_cap, i_cap, k)
    ev = _events(rng, n_w, n_ev, u_cap, i_cap, k, pairwise, padding)
    return _negatives(rng, st, ev, negs)


@pytest.mark.gpu
@pytest.mark.parametrize("pairwise", [False, True], ids=["isgd", "bpr"])
@pytest.mark.parametrize("shape", list(FACTOR_CASES))
def test_factor_update_kernel_matches_plain(cuda_device, pairwise, shape):
    st, ev = _factor_case(shape, pairwise)
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


# K2's hard cases (csrc/masked_scores.cu): I not a multiple of 4 (the
# kernel's scalar path: 37, 6,785) or of its 1,024-item strip (1,028: the
# 4-byte mask loads and float4 stores, then a partial strip), B not a
# multiple of the 16 rows a CTA walks, k at both ends (1, 32), and masks
# all false and all true. (n_w, b, i, k), mask.
MASKED_CASES = {
    "items_37": ((2, 9, 37, 8), "random"),
    "items_6785": ((2, 37, 6785, 10), "random"),
    "partial_strip": ((3, 21, 1028, 10), "random"),
    "k_1": ((2, 40, 300, 1), "random"),
    "k_32": ((2, 40, 300, 32), "random"),
    "all_false": ((2, 17, 1024, 10), "none"),
    "all_true": ((2, 17, 1024, 10), "all"),
}


def _assert_scores_match(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MASKED_CASES))
def test_masked_scores_kernel_hard_cases(cuda_device, case):
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, fill = MASKED_CASES[case]
    u, it, mask, _ = _score_inputs(np.random.default_rng(14), *shape)
    if fill != "random":
        mask[:] = fill == "all"
    args = [torch.tensor(x, device=cuda_device) for x in (u, it, mask)]
    before = ops.launch_counts()["masked_scores"]
    got = ops.masked_scores(*args)
    assert ops.launch_counts()["masked_scores"] == before + 1
    _assert_scores_match(got, ref.masked_scores(*args))


@pytest.mark.gpu
def test_masked_scores_kernel_takes_a_mask_at_an_odd_address(cuda_device):
    """A contiguous mask view one byte into its buffer cannot take the
    4-byte loads: the kernel's scalar path runs, with the same scores."""
    u, it, mask, _ = _score_inputs(np.random.default_rng(15), 2, 20, 1024, 10)
    buf = torch.zeros(mask.size + 1, dtype=torch.uint8, device=cuda_device)
    odd = buf[1:].view(mask.shape)
    odd.copy_(torch.tensor(mask, device=cuda_device))
    assert odd.data_ptr() % 4 and odd.is_contiguous()
    u_t, it_t = (torch.tensor(x, device=cuda_device) for x in (u, it))
    _assert_scores_match(ops.masked_scores(u_t, it_t, odd),
                         ref.masked_scores(u_t, it_t, odd))


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



def _assert_topn_match(got, want, exact):
    """``fused_topn`` lists against the plain version's: scores within
    RTOL / ATOL (the two sum k products in other orders); ids exactly
    where ``exact`` (integer factors: exact scores) or else wherever
    neighbouring scores are clearly apart."""
    (got_ids, got_sc), (want_ids, want_sc) = (
        [x.cpu().numpy() for x in pair] for pair in (got, want))
    np.testing.assert_array_equal(np.isneginf(got_sc), np.isneginf(want_sc))
    np.testing.assert_allclose(got_sc, want_sc, rtol=RTOL, atol=ATOL)
    if exact:
        np.testing.assert_array_equal(got_ids, want_ids)
        return
    gap = np.abs(np.diff(want_sc, axis=-1))
    sep = np.ones_like(want_sc, dtype=bool)
    near = ~((gap > 1e-4) | np.isnan(gap))
    sep[..., 1:] &= ~near
    sep[..., :-1] &= ~near
    np.testing.assert_array_equal(got_ids[sep], want_ids[sep])


def _candidate_counts(mask, counts):
    """Row r of every worker keeps only its first ``counts[r % len]``
    candidates (a count past I keeps them all)."""
    for r in range(mask.shape[1]):
        c = counts[r % len(counts)]
        row = mask[:, r]
        keep = np.cumsum(row, axis=-1) <= c
        mask[:, r] = row & keep


def _late_candidates(u, it, mask, top_n, span=1024):
    """Row r of every worker keeps candidates as the r-th of the patterns
    below (in turn) says, in the kernel's passes of ``span`` items: c1 of
    the last 32 items of pass 1 (those that score lowest), then in pass 2
    the N best of its first 32 items ("top": one a lane, so the pass floor
    is their lowest score), all its candidates or none, then c3 of the
    first 32 items of pass 3 (lowest) or all its candidates. So the list
    still fills when a later pass of N or more candidates begins, and
    after "top" it ends full with pass 2's entries first: a floor set too
    high changes it."""
    n = top_n
    patterns = [(0, "top", n), (1, "top", 1), (n - 1, "top", 0),
                (n // 2, "top", n // 2), (1, "all", "all"), (0, None, "all")]
    scores = np.einsum("wbk,wik->wbi", u.astype(np.float64),
                       it.astype(np.float64))

    def pick(row, lo, count, low):
        s = row[lo:lo + 32]
        keep = np.zeros(32, bool)
        keep[np.argsort(s if low else -s, kind="stable")[:count]] = True
        return keep

    for r in range(mask.shape[1]):
        if not mask[:, r].any():       # a row without a candidate stays so
            continue
        c1, mid, c3 = patterns[r % len(patterns)]
        for w in range(mask.shape[0]):
            row, sc = mask[w, r].copy(), scores[w, r]
            mask[w, r] = False
            mask[w, r, span - 32:span] = pick(sc, span - 32, c1, True)
            if mid == "top":
                mask[w, r, span:span + 32] = pick(sc, span, n, False)
            elif mid == "all":
                mask[w, r, span:2 * span] = row[span:2 * span]
            if c3 == "all":
                mask[w, r, 2 * span:] = row[2 * span:]
            else:
                mask[w, r, 2 * span:2 * span + 32] = pick(sc, 2 * span, c3,
                                                          True)


# K3's hard cases (csrc/fused_topn.cu): I not a multiple of 4 (the byte
# mask loads and scalar item loads: 37, 6,785), k at both ends and at the
# serve width (1, 10, 32: the instances' widths and the float4 path), N at
# both ends (1, 32: the longest lane list), rows with 0, 1, N - 1, N, N + 1
# and all candidates (the shared list of rows without a candidate and
# the exact pass of rows with 1 to N - 1), rows whose list still fills
# when a later pass of N or more candidates begins (the pass floor; I =
# 3,072 takes the cp.async copies across 3 passes), a batch of padding
# rows only (no candidate anywhere), and I < N (n = I). (n_w, b, i, k),
# top_n, kind.
FUSED_CASES = {
    "items_37": ((2, 9, 37, 8), 10, None),
    "items_6785": ((2, 37, 6785, 10), 10, None),
    "k_1": ((2, 40, 300, 1), 10, None),
    "k_10": ((2, 40, 1024, 10), 10, None),
    "k_32": ((2, 40, 300, 32), 10, None),
    "n_1": ((2, 24, 300, 10), 1, None),
    "n_32": ((2, 24, 300, 10), 32, None),
    "few_candidates": ((3, 50, 1024, 10), 10, "few"),
    "late_candidates": ((2, 40, 3072, 10), 10, "late"),
    "late_n_32": ((2, 40, 3072, 10), 32, "late"),
    "padding_only": ((2, 64, 1024, 10), 10, "none"),
    "items_below_n": ((2, 9, 7, 8), 10, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_topn_kernel_hard_cases(cuda_device, case, ties):
    torch.backends.cuda.matmul.allow_tf32 = False
    shape, top_n, kind = FUSED_CASES[case]
    u, it, mask, ids = _score_inputs(np.random.default_rng(19), *shape,
                                     ties=ties)
    if kind == "few":
        _candidate_counts(mask, [0, 1, top_n - 1, top_n, top_n + 1,
                                 shape[2]])
    elif kind == "late":
        _late_candidates(u, it, mask, top_n)
    elif kind == "none":
        mask[:] = False
    args = [torch.tensor(x, device=cuda_device) for x in (u, it, mask, ids)]
    before = ops.launch_counts()["fused_topn"]
    got = ops.fused_topn(*args, top_n=top_n)
    assert ops.launch_counts()["fused_topn"] == before + 1
    assert got[0].shape == (shape[0], shape[1], min(top_n, shape[2]))
    _assert_topn_match(got, ref.fused_topn(*args, top_n=top_n), ties)


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
def test_fused_topn_kernel_takes_a_mask_at_an_odd_address(cuda_device, ties):
    """A contiguous mask view one byte into its buffer cannot take the
    4-byte mask loads: the kernel's byte loads run, with the same lists."""
    u, it, mask, ids = _score_inputs(np.random.default_rng(23), 2, 20, 1024,
                                     10, ties=ties)
    buf = torch.zeros(mask.size + 1, dtype=torch.uint8, device=cuda_device)
    odd = buf[1:].view(mask.shape)
    odd.copy_(torch.tensor(mask, device=cuda_device))
    assert odd.data_ptr() % 4 and odd.is_contiguous()
    u_t, it_t, ids_t = (torch.tensor(x, device=cuda_device)
                        for x in (u, it, ids))
    _assert_topn_match(ops.fused_topn(u_t, it_t, odd, ids_t, top_n=10),
                       ref.fused_topn(u_t, it_t, odd, ids_t, top_n=10), ties)

# As FACTOR_CASES, for DICS; the last user and item slots are live, so
# padding clears them. i_cap 32 and 48 take the kernel's 16-byte loads of
# the history rows (48: a half word last), 5, 24 and 70 its byte loads.
DICS_CASES = {
    "tiny": ((2, 64, 32, 24), "random"),
    "small": ((4, 300, 70, 96), "random"),
    "dense": ((2, 6, 5, 60), "random"),
    "wide": ((3, 40, 48, 600), "random"),
    "tail_padding": ((2, 12, 24, 40), "tail"),
    "all_padding": ((2, 12, 24, 40), "all"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("live", [None, True, False])
@pytest.mark.parametrize("shape", list(DICS_CASES))
def test_dics_update_kernel_matches_plain(cuda_device, shape, live):
    (n_w, u_cap, i_cap, n_ev), padding = DICS_CASES[shape]
    rng = np.random.default_rng(19)
    st = _dics_state(rng, n_w, u_cap, i_cap)
    ev = _dics_events(rng, n_w, n_ev, u_cap, i_cap, padding)
    before = ops.launch_counts()["dics_update"]
    got = _torch_dics_apply(st, ev, cuda_device, use_ops=True, live=live)
    assert ops.launch_counts()["dics_update"] == before + 1
    want = _torch_dics_apply(st, ev, cuda_device, use_ops=False, live=live)
    _assert_state_equal(got, want, rtol=0, atol=0)
    if live is False:
        _assert_state_equal(got, st, rtol=0, atol=0)


def _dics_main_state(device, n_w=16, u_cap=98_560, i_cap=768, n_ev=256):
    """A DICS grid at the main path's shapes, made on the card from a
    seed (numpy would take gigabytes of host temporaries for ``rated``):
    ~60% live slots, ~3 rated items per user row, symmetric counts, and
    events whose ids span twice the caps (evictions) with 20% padding."""
    gen = torch.Generator(device=device).manual_seed(23)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def ids(cap):
        base = torch.arange(cap, dtype=torch.int32, device=device)
        alt = (rand(n_w, cap) < 0.5).to(torch.int32) * cap
        return torch.where(rand(n_w, cap) < 0.6, base + alt, -1)

    def counts(shape, hi):
        return torch.floor(rand(*shape) * hi).to(torch.int32)

    co = torch.floor(rand(n_w, i_cap, i_cap) * 5)
    st = {"user_ids": ids(u_cap), "item_ids": ids(i_cap),
          "user_freq": counts((n_w, u_cap), 5),
          "item_freq": counts((n_w, i_cap), 5),
          "user_ts": counts((n_w, u_cap), 50),
          "item_ts": counts((n_w, i_cap), 50),
          "clock": 50 + counts((n_w,), 10),
          "co": co + co.transpose(1, 2),
          "item_cnt": torch.floor(rand(n_w, i_cap) * 2000),
          "rated": rand(n_w, u_cap, i_cap) < 0.004}
    ev_u = torch.floor(rand(n_w, n_ev) * 2 * u_cap).to(torch.int32)
    ev_i = torch.floor(rand(n_w, n_ev) * 2 * i_cap).to(torch.int32)
    pad = rand(n_w, n_ev) < 0.2
    ev_u[pad] = -1
    ev_i[pad] = -1
    events = (ev_u, ev_i, (ev_u % u_cap).to(torch.int32),
              (ev_i % i_cap).to(torch.int32))
    return st, events


@pytest.mark.gpu
def test_dics_update_kernel_matches_plain_at_main_path_shapes(cuda_device):
    st, events = _dics_main_state(cuda_device)
    out = {}
    for name, fn in (("kernel", ops.dics_update), ("plain", ref.dics_apply)):
        t = {n: v.clone() for n, v in st.items()}
        fn(t["co"], t["item_cnt"], t["rated"],
           tuple(t[n] for n in TABLE_NAMES), events)
        out[name] = t
    for n in st:
        assert torch.equal(out["kernel"][n], out["plain"][n]), n


def _factor_main_state(device, n_w=16, u_cap=38_912, i_cap=6_784, k=10,
                       n_ev=256):
    """A DISGD grid at the main path's shapes (``rated`` 4.2 GB), made on
    the card from a seed: ~60% live slots, ~16 rated items per user row,
    and events whose ids span twice the caps (evictions) with 20%
    padding. Returns the state, the tables' names and the events."""
    gen = torch.Generator(device=device).manual_seed(29)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def ids(cap):
        base = torch.arange(cap, dtype=torch.int32, device=device)
        alt = (rand(n_w, cap) < 0.5).to(torch.int32) * cap
        return torch.where(rand(n_w, cap) < 0.6, base + alt, -1)

    def counts(shape, hi):
        return torch.floor(rand(*shape) * hi).to(torch.int32)

    rated = torch.zeros((n_w, u_cap, i_cap), dtype=torch.bool, device=device)
    flat = torch.floor(rand(16 * n_w * u_cap) * rated.numel()).long()
    rated.view(-1)[flat] = True
    st = {"user_ids": ids(u_cap), "item_ids": ids(i_cap),
          "user_freq": counts((n_w, u_cap), 5),
          "item_freq": counts((n_w, i_cap), 5),
          "user_ts": counts((n_w, u_cap), 50),
          "item_ts": counts((n_w, i_cap), 50),
          "clock": 50 + counts((n_w,), 10),
          "user_vecs": (rand(n_w, u_cap, k) - 0.5) * 0.6,
          "item_vecs": (rand(n_w, i_cap, k) - 0.5) * 0.6,
          "rated": rated}
    ev_u = torch.floor(rand(n_w, n_ev) * 2 * u_cap).to(torch.int32)
    ev_i = torch.floor(rand(n_w, n_ev) * 2 * i_cap).to(torch.int32)
    pad = rand(n_w, n_ev) < 0.2
    ev_u[pad] = -1
    ev_i[pad] = -1
    events = (ev_u, ev_i, (ev_u % u_cap).to(torch.int32),
              (ev_i % i_cap).to(torch.int32), None,
              (rand(n_w, n_ev, k) - 0.5) * 0.2,
              (rand(n_w, n_ev, k) - 0.5) * 0.2)
    return st, events


def _main_path_compare(st, events):
    out = {}
    for name, fn in (("kernel", ops.factor_update),
                     ("plain", ref.factor_apply)):
        t = {n: v.clone() for n, v in st.items()}
        fn(t["user_vecs"], t["item_vecs"], t["rated"],
           tuple(t[n] for n in TABLE_NAMES), events, eta=0.05, lam=0.01)
        out[name] = t
        del t
    for n in st:
        got, want = out["kernel"][n], out["plain"][n]
        if got.dtype.is_floating_point:
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        else:
            assert torch.equal(got, want), n


@pytest.mark.gpu
def test_factor_update_kernel_matches_plain_at_main_path_shapes(cuda_device):
    _main_path_compare(*_factor_main_state(cuda_device))


@pytest.mark.gpu
def test_factor_update_pairwise_kernel_matches_plain_at_main_path_shapes(
        cuda_device):
    """Pairwise mode on the same state, half the negatives on the
    bucket's own item slots."""
    st, events = _factor_main_state(cuda_device)
    ev_u, ev_i, us, is_, _, init_u, init_i = events
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    n_w, n_ev = ev_u.shape
    i_cap = st["item_ids"].shape[1]
    js = torch.randint(0, i_cap, (n_w, n_ev), generator=gen,
                       device=cuda_device, dtype=torch.int32)
    other = is_.gather(1, torch.randint(0, n_ev, (n_w, n_ev), generator=gen,
                                        device=cuda_device))
    js = torch.where(torch.rand((n_w, n_ev), generator=gen,
                                device=cuda_device) < 0.5, other, js)
    _main_path_compare(st, (ev_u, ev_i, us, is_, js, init_u, init_i))


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("shape,top_n,k_nn",
                         [((2, 9, 37), 7, 5), ((3, 40, 300), 10, 10),
                          ((16, 512, 768), 10, 10), ((2, 8, 20), 20, 32)],
                         ids=["tiny", "small", "main_path", "short_rows"])
def test_dics_topn_kernel_matches_plain(cuda_device, shape, top_n, k_nn,
                                        ties):
    rng = np.random.default_rng(29)
    args = [torch.tensor(x, device=cuda_device)
            for x in _dics_topn_inputs(rng, *shape, ties=ties)]
    before = ops.launch_counts()["dics_topn"]
    got_ids, got_sc = ops.dics_topn(*args, top_n=top_n, k_nn=k_nn)
    assert ops.launch_counts()["dics_topn"] == before + 1
    want_ids, want_sc = ref.dics_topn(*args, top_n, k_nn)
    # Same IEEE operations in the same order: scores and ids exactly.
    np.testing.assert_array_equal(got_sc.cpu().numpy(), want_sc.cpu().numpy())
    np.testing.assert_array_equal(got_ids.cpu().numpy(),
                                  want_ids.cpu().numpy())


def _dics_topn_case(rng, n_w, b, i, kind, ties=False):
    """``_dics_topn_inputs`` made into one of K5's hard cases:
    ``"asymmetric"`` counts (so the kernel must read co[p, q], not
    co[q, p]), ``"dense"`` histories (~90% of a row: many batches of the
    kernel's co loads, and few candidates), ``"empty"`` (no query has a
    history: every list is the worker's smallest ids at -inf)."""
    co, cnt, hist, known, ids = _dics_topn_inputs(rng, n_w, b, i, ties=ties)
    if kind == "asymmetric":
        co = rng.integers(0, 40, (n_w, i, i)).astype(np.float32)
        assert not np.array_equal(co, co.transpose(0, 2, 1))
    elif kind == "dense":
        hist = (rng.random((n_w, b, i)) < 0.9) & known[..., None]
    elif kind == "empty":
        hist[:] = False
    return co, cnt, hist, known, ids


# K5's hard cases (csrc/dics_topn.cu): an asymmetric co, dense history
# rows, no history anywhere, I not a multiple of a warp's 32 candidates or
# of the CTA's 256 (20, 300), B not a multiple of the CTA's 8 queries,
# top_n = k_nn = 32 (the kernel's largest lists), and I = 7,000 (fewer
# queries a CTA, so their history lists fit in shared memory).
# (n_w, b, i), top_n, k_nn, kind.
DICS_TOPN_CASES = {
    "asymmetric": ((2, 24, 300), 10, 10, "asymmetric"),
    "dense_rows": ((2, 12, 300), 10, 10, "dense"),
    "no_history": ((2, 16, 70), 10, 10, "empty"),
    "items_20": ((2, 8, 20), 10, 10, None),
    "items_300": ((3, 37, 300), 10, 10, None),
    "lists_32": ((2, 24, 300), 32, 32, None),
    "items_7000": ((1, 9, 7000), 10, 10, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("case", list(DICS_TOPN_CASES))
def test_dics_topn_kernel_hard_cases(cuda_device, case, ties):
    shape, top_n, k_nn, kind = DICS_TOPN_CASES[case]
    args = [torch.tensor(x, device=cuda_device) for x in
            _dics_topn_case(np.random.default_rng(37), *shape, kind, ties)]
    before = ops.launch_counts()["dics_topn"]
    got_ids, got_sc = ops.dics_topn(*args, top_n=top_n, k_nn=k_nn)
    assert ops.launch_counts()["dics_topn"] == before + 1
    want_ids, want_sc = ref.dics_topn(*args, top_n, k_nn)
    np.testing.assert_array_equal(got_sc.cpu().numpy(), want_sc.cpu().numpy())
    np.testing.assert_array_equal(got_ids.cpu().numpy(),
                                  want_ids.cpu().numpy())


@pytest.mark.gpu
def test_dics_topn_refuses_lists_beyond_its_registers(cuda_device):
    args = [torch.tensor(x, device=cuda_device) for x in
            _dics_topn_inputs(np.random.default_rng(0), 1, 2, 64)]
    with pytest.raises(ValueError, match="top_n"):
        ops.dics_topn(*args, top_n=ops.MAX_TOP_N + 1, k_nn=10)
    with pytest.raises(ValueError, match="k_nn"):
        ops.dics_topn(*args, top_n=10, k_nn=ops.MAX_K_NN + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["disgd", "dics"])
@pytest.mark.parametrize("backend", ["cuda", "scan"])
def test_stream_loop_never_waits_for_the_card(cuda_device, backend,
                                              algorithm):
    """Each step of the device loop only enqueues work: under CUDA's
    sync debug mode "error", a host synchronisation (``.item()``, a
    copy from pageable host memory, ``nonzero``) raises."""
    import repro_torch as rt
    from repro_torch.core import engine
    from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream
    from repro_torch.kernels import build

    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    hyper = {"disgd": rt.DisgdHyper, "dics": rt.DicsHyper}[algorithm]
    cfg = rt.StreamConfig(algorithm=algorithm, grid=rt.GridSpec(2),
                          micro_batch=256,
                          hyper=hyper(u_cap=128, i_cap=32),
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
    processed, requeued, dropped = (int(carry[4]), int((carry[1] >= 0).sum()),
                                    int(carry[5]))
    assert processed + requeued + dropped == n


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 16, 4, 10), (64, 48, 10, 100),
                                   (4096, 2048, 10, 16384),
                                   (38_912, 6_784, 10, 256)],
                         ids=["tiny", "small", "bench", "worker"])
def test_isgd_update_kernel_matches_plain(cuda_device, shape):
    inp = _isgd_inputs(np.random.default_rng(31), *shape)
    out = {}
    for name, fn in (("kernel", ops.isgd_update), ("plain", ref.isgd_apply)):
        args = [torch.tensor(inp[n], device=cuda_device) for n in ISGD_NAMES]
        before = ops.launch_counts()["isgd_update"]
        fn(*args, eta=0.05, lam=0.01)
        assert ops.launch_counts()["isgd_update"] == before + (
            name == "kernel")
        out[name] = [a.cpu().numpy() for a in args[:2]]
    for got, want in zip(out["kernel"], out["plain"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)



def _isgd_one_event_at_a_time(args, eta, lam):
    """The kernel launched once per event: the batch's order with the
    kernel's own arithmetic, one dependent step after another."""
    ut, it, u_slots, i_slots, valid = args
    for e in range(u_slots.shape[0]):
        ops.isgd_update(ut, it, u_slots[e:e + 1], i_slots[e:e + 1],
                        valid[e:e + 1], eta=eta, lam=lam)
    return ut, it


# K6's deep chains (csrc/isgd_update.cu): every event on one user row, or
# on one item row (one event at a time, 16,384 deep, over eight staged
# chunks), the bench shape (random slots, ~30 levels deep) and one DISGD
# worker's shape (a 256-event bucket, 2 levels). (u_cap, i_cap, k, n_ev),
# the slot drawn for every event (None: random).
ISGD_CHAIN_CASES = {
    "one_user_row": ((4096, 2048, 10, 16384), "user"),
    "one_item_row": ((4096, 2048, 10, 16384), "item"),
    "bench": ((4096, 2048, 10, 16384), None),
    "worker": ((38_912, 6_784, 10, 256), None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ISGD_CHAIN_CASES))
def test_isgd_update_kernel_replays_deep_chains_bit_for_bit(cuda_device,
                                                            case):
    """The parallel replay gives what the events give one at a time, bit
    for bit: each row's events run in the batch's order."""
    shape, one = ISGD_CHAIN_CASES[case]
    inp = _isgd_inputs(np.random.default_rng(53), *shape)
    if one is not None:
        inp[f"{one[0]}_slots"][:] = 7
    out = {}
    for name in ("batch", "events"):
        args = [torch.tensor(inp[n], device=cuda_device) for n in ISGD_NAMES]
        if name == "batch":
            before = ops.launch_counts()["isgd_update"]
            ops.isgd_update(*args, eta=0.05, lam=0.01)
            assert ops.launch_counts()["isgd_update"] == before + 1
        else:
            _isgd_one_event_at_a_time(args, 0.05, 0.01)
        out[name] = [a.cpu().numpy() for a in args[:2]]
    for got, want in zip(out["batch"], out["events"]):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(out["batch"][0], inp["user_tab"])

@pytest.mark.gpu
def test_isgd_update_kernel_skips_slots_outside_the_tables(cuda_device):
    """Both versions skip an event whose slot lies outside its table: the
    kernel equals the plain version on the same slots, and both equal the
    plain version with those events marked invalid."""
    inp = _isgd_inputs(np.random.default_rng(33), 64, 48, 10, 100)
    bad = inp["u_slots"].copy()
    bad[::7] = 64                     # one past the user table
    bad[3::7] = -1
    inside = (bad >= 0) & (bad < 64)
    runs = {}
    for name, fn, slots, valid in (
            ("kernel", ops.isgd_update, bad, inp["valid"]),
            ("plain", ref.isgd_apply, bad, inp["valid"]),
            ("masked", ref.isgd_apply, np.where(inside, bad, 0),
             inp["valid"] & inside)):
        args = [torch.tensor(inp[n], device=cuda_device) for n in ISGD_NAMES]
        args[2] = torch.tensor(slots.astype(np.int32), device=cuda_device)
        args[4] = torch.tensor(valid, device=cuda_device)
        runs[name] = [a.cpu().numpy() for a in fn(*args, eta=0.05, lam=0.01)]
    for name in ("plain", "masked"):
        for g, w in zip(runs["kernel"], runs[name]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


# (B, Hq, Hkv, S, D, window, causal, dtype)
SWA_CASES = {
    "danube_ragged": (1, 8, 2, 1000, 80, 256, True, "bfloat16"),
    "danube_two_windows": (1, 4, 1, 2049, 80, 1024, True, "bfloat16"),
    "gqa8_full_causal": (2, 8, 1, 513, 128, None, True, "bfloat16"),
    "d64_non_causal": (1, 4, 2, 257, 64, 48, False, "bfloat16"),
    "d32_short": (2, 2, 2, 5, 32, 3, True, "bfloat16"),
    # The wgmma design's edges: S around one 128-row tile and a ragged
    # tail with several heads (a tensor map crossing heads would show),
    # windows that are no multiple of the tile, no window, group sizes 1,
    # 4 and 8, every head width.
    "s1_heads": (2, 4, 2, 1, 80, 4096, True, "bfloat16"),
    "s127_w100_g4": (2, 8, 2, 127, 64, 100, True, "bfloat16"),
    "s128_w129_g8": (1, 8, 1, 128, 128, 129, True, "bfloat16"),
    "s129_w1_g1": (2, 4, 4, 129, 32, 1, True, "bfloat16"),
    "s8193_w4095_g8": (1, 8, 1, 8193, 80, 4095, True, "bfloat16"),
    "s300_full_non_causal_g4": (2, 4, 1, 300, 80, None, False, "bfloat16"),
    "s777_full_causal_g1": (2, 2, 2, 777, 64, None, True, "bfloat16"),
    "s640_w4095_d128_g4": (1, 8, 2, 640, 128, 4095, True, "bfloat16"),
    "d32_w100_non_causal": (2, 4, 1, 385, 32, 100, False, "bfloat16"),
    "d80_w129_g4": (2, 8, 2, 1000, 80, 129, True, "bfloat16"),
    "f32_d80_ragged": (1, 4, 2, 130, 80, 32, True, "float32"),
    "f32_d32_gqa": (2, 4, 1, 300, 32, 64, True, "float32"),
    "f32_d128": (1, 2, 2, 96, 128, None, True, "float32"),
    # The full-attention archs' shapes at window=None: olmoe's D 128 over
    # a 4,096-token context (group 1), dbrx's group 6 and granite's MQA
    # group 48, the last two ragged.
    "olmoe_s4096_full_g1": (1, 2, 2, 4096, 128, None, True, "bfloat16"),
    "dbrx_s1031_full_g6": (1, 12, 2, 1031, 128, None, True, "bfloat16"),
    "granite_s777_full_g48": (1, 48, 1, 777, 128, None, True, "bfloat16"),
    # Head dim 96 (phi-3-vision: panels of 64 + 32 columns, 2 stages):
    # its ragged S of 1,600 causal, hubert's mask (no window, not causal)
    # at a ragged S, a window, and the f32 path.
    "phi3_s1600_d96_causal": (2, 4, 4, 1600, 96, None, True, "bfloat16"),
    "d96_s777_full_non_causal_g2": (2, 4, 2, 777, 96, None, False,
                                    "bfloat16"),
    "d96_s300_w129_g4": (1, 8, 2, 300, 96, 129, True, "bfloat16"),
    "d96_s1_heads": (2, 4, 4, 1, 96, None, False, "bfloat16"),
    "f32_d96_non_causal": (1, 2, 2, 130, 96, None, False, "float32"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SWA_CASES))
def test_swa_attention_kernel_matches_plain(cuda_device, case):
    b, hq, hkv, s, d, window, causal, dtype = SWA_CASES[case]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(x, device=cuda_device).to(tdt) for x in
               _swa_inputs(np.random.default_rng(37), b, hq, hkv, s, d))
    before = ops.launch_counts()["swa_attention"]
    got = ops.swa_attention(q, k, v, window=window, causal=causal)
    assert ops.launch_counts()["swa_attention"] == before + 1
    want = ref.swa_attention(q, k, v, window=window, causal=causal)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **SWA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("s", [129, 1000])
def test_swa_attention_heads_leave_their_neighbours_alone_when_s_is_ragged(
        cuda_device, s):
    """Every head of a call with a ragged S equals the same head run
    alone, bit for bit: a tile loaded or stored across the end of a head
    would change its neighbour's rows."""
    b, hq, hkv, d, window = 2, 4, 2, 80, 100
    q, k, v = (torch.tensor(x, device=cuda_device).to(torch.bfloat16) for x in
               _swa_inputs(np.random.default_rng(53), b, hq, hkv, s, d))
    got = ops.swa_attention(q, k, v, window=window)
    g = hq // hkv
    for bi in range(b):
        for h in range(hq):
            kv = slice(h // g, h // g + 1)
            alone = ops.swa_attention(
                q[bi:bi + 1, h:h + 1].contiguous(),
                k[bi:bi + 1, kv].contiguous(), v[bi:bi + 1, kv].contiguous(),
                window=window)
            assert torch.equal(got[bi:bi + 1, h:h + 1], alone), (bi, h)
    want = ref.swa_attention(q, k, v, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **SWA_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_attention_rows_without_keys_give_zero_on_the_card(cuda_device,
                                                               dtype):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(x, device=cuda_device).to(tdt) for x in
               _swa_inputs(np.random.default_rng(41), 1, 2, 1, 100, 80))
    got = ops.swa_attention(q, k, v, window=0, causal=False)
    want = ref.swa_attention(q, k, v, window=0, causal=False)
    assert torch.all(got[:, :, -1] == 0)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **SWA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bf16_window", "f32_non_causal"])
def test_swa_attention_custom_op_passes_opcheck(cuda_device, case):
    """K7 as ``torch.ops.repro_torch.swa_attention``: schema, fake
    (the dry-run's trace), autograd registration and an AOT dispatch with
    dynamic shapes agree with the kernel's launch."""
    dtype, window, causal = ((torch.bfloat16, 100, True) if case ==
                             "bf16_window" else (torch.float32, None, False))
    q, k, v = (torch.tensor(x, device=cuda_device).to(dtype) for x in
               _swa_inputs(np.random.default_rng(59), 2, 4, 2, 257, 80))
    result = torch.library.opcheck(torch.ops.repro_torch.swa_attention.default,
                                   (q, k, v, window, causal))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.gpu
def test_swa_attention_refuses_what_it_was_not_built_for(cuda_device):
    def qkv(d, dtype=torch.bfloat16, hkv=2):
        return (torch.zeros(1, 4, 8, d, dtype=dtype, device=cuda_device),
                torch.zeros(1, hkv, 8, d, dtype=dtype, device=cuda_device),
                torch.zeros(1, hkv, 8, d, dtype=dtype, device=cuda_device))

    with pytest.raises(ValueError, match="head_dim"):
        ops.swa_attention(*qkv(48), window=4)
    with pytest.raises(ValueError, match="dtype"):
        ops.swa_attention(*qkv(32, torch.float16), window=4)
    with pytest.raises(ValueError, match="kv heads"):
        ops.swa_attention(*qkv(32, hkv=3), window=4)


@pytest.mark.gpu
def test_forward_full_launches_swa_attention_once_per_layer(cuda_device):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.factory import build

    cfg = get_smoke_config("h2o_danube_1p8b")
    bundle = build(cfg, device="cuda")
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.tensor(make_batch(cfg, 2, 97, seed=0)["tokens"],
                        device=cuda_device)
    before = ops.launch_counts()["swa_attention"]
    with torch.no_grad():
        x = tfm.embed_tokens(params, toks, cfg)
        h, _, _ = tfm.forward_full(params, x,
                                   torch.arange(97, device="cuda"), cfg)
    assert ops.launch_counts()["swa_attention"] == before + cfg.n_layers
    logits, caches = bundle.prefill(params, {"tokens": toks[:, :-1]})
    assert ops.launch_counts()["swa_attention"] == before + 2 * cfg.n_layers
    nxt, _ = bundle.decode(params, caches, toks[:, -1:])
    assert ops.launch_counts()["swa_attention"] == before + 2 * cfg.n_layers
    assert torch.isfinite(h.float()).all() and nxt.shape == (2, 1)


@pytest.mark.gpu
def test_moe_forward_full_launches_swa_attention_and_routes_as_the_cpu(
        cuda_device):
    """olmoe-smoke (head dim 32) on the card: one ``swa_attention`` launch
    per layer, and its MoE layer picks the CPU's experts, positions and
    kept assignments (exactly, with no near-tie in the router) and the
    lowest indices when the router ties every expert."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.factory import build
    from repro_torch.models.layers import moe

    cfg = get_smoke_config("olmoe_1b_7b")
    bundle = build(cfg, device="cuda")
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.tensor(make_batch(cfg, 2, 97, seed=0)["tokens"],
                        device=cuda_device)
    before = ops.launch_counts()["swa_attention"]
    with torch.no_grad():
        x = tfm.embed_tokens(params, toks, cfg)
        h, _, aux = tfm.forward_full(params, x,
                                     torch.arange(97, device="cuda"), cfg)
    assert ops.launch_counts()["swa_attention"] == before + cfg.n_layers
    assert torch.isfinite(h.float()).all() and aux.item() > 0

    layer = {k: v for k, v in params.layers[0].moe.named_parameters()}
    xs = torch.tensor(np.random.default_rng(61).normal(
        size=(4, 32, cfg.d_model)), dtype=torch.bfloat16)
    e = dataclasses.replace(cfg.moe, capacity_factor=0.5)   # some dropped
    for zero in (False, True):
        p = {k: (torch.zeros_like(v) if zero and k == "router" else v)
             for k, v in layer.items()}
        got = moe.route(p, xs.to(cuda_device), e)
        want = moe.route({k: v.cpu() for k, v in p.items()}, xs, e)
        if zero:
            assert (want.top_i == torch.arange(e.top_k)).all()
        else:
            ranked = want.probs.sort(-1, descending=True).values
            gaps = ranked[..., :e.top_k] - ranked[..., 1:e.top_k + 1]
            assert gaps.min().item() >= 1e-6
        assert not want.kept.all()
        for f in ("top_i", "pos", "kept"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["xlstm_350m", "phi3_vision_4p2b",
                                  "hubert_xlarge"])
def test_family_prefill_and_decode_run_on_the_card(cuda_device, arch):
    """The xLSTM, VLM and audio smoke models (head dim 32, or no
    attention) on the card: one ``swa_attention`` launch per attention
    layer in a prefill, none in decode, finite logits, and the card's
    prefill logits equal to the CPU's on the same parameters within
    tests/test_decode.py's 0.15 of their scale (the CPU runs K7's plain
    version)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.models.factory import build

    cfg = get_smoke_config(arch)
    bundle, host = build(cfg, device="cuda"), build(cfg, device="cpu")
    params = host.init(torch.Generator().manual_seed(0))
    card = host.init(torch.Generator().manual_seed(0)).to(cuda_device)
    batch = make_batch(cfg, 2, 97, seed=0)
    layers = 0 if cfg.family == "ssm" else cfg.n_layers
    before = ops.launch_counts()["swa_attention"]
    logits, caches = bundle.prefill(card, batch)
    assert ops.launch_counts()["swa_attention"] == before + layers
    want, _ = host.prefill(params, batch)
    got = logits.float().cpu()
    scale = max(want.float().abs().max().item(), 1.0)
    assert torch.isfinite(got).all()
    assert (got - want.float()).abs().max().item() / scale <= 0.15
    if cfg.decoder:
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        nxt, _ = bundle.decode(card, caches, tok)
        assert ops.launch_counts()["swa_attention"] == before + layers
        assert nxt.shape == (2, 1)
        assert ((nxt >= 0) & (nxt < cfg.vocab)).all()


@pytest.mark.gpu
def test_dbrx_smoke_serve_fails_on_the_card(cuda_device):
    """dbrx-smoke's head dim 16 is no width ``swa_attention`` is built
    for: ``serve --device cuda`` raises at the first prefill, before any
    launch, and is not routed to the plain version."""
    from repro_torch.launch import serve

    before = ops.launch_counts()["swa_attention"]
    with pytest.raises(ValueError, match="head_dim 16"):
        serve.main(["--arch", "dbrx_132b", "--smoke", "--device", "cuda"])
    assert ops.launch_counts()["swa_attention"] == before


@pytest.mark.gpu
def test_cuda_calls_never_reach_the_plain_versions(cuda_device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "swa_attention", refuse)
    monkeypatch.setattr(ref, "isgd_apply", refuse)
    q, k, v = (torch.tensor(x, device=cuda_device).to(torch.bfloat16) for x in
               _swa_inputs(np.random.default_rng(43), 1, 4, 2, 77, 80))
    ops.swa_attention(q, k, v, window=16)      # ragged S included
    inp = _isgd_inputs(np.random.default_rng(47), 32, 16, 10, 50)
    ops.isgd_update(*(torch.tensor(inp[n], device=cuda_device)
                      for n in ISGD_NAMES), eta=0.05, lam=0.01)
    torch.cuda.synchronize()


# -- training: K7 under the attention Function ----------------------------------

# (B, Hq, Hkv, S, D, window, causal, q_chunk): danube's head dim under a
# binding window (GQA 4), phi-3-vision's D 96 causal without a window,
# hubert's D 80 bidirectional, each at a ragged last chunk of K7's tiles.
TRAIN_GRAD_CASES = {
    "danube_d80_w256_g4": (1, 8, 2, 1000, 80, 256, True, 250),
    "phi3_d96_causal": (2, 4, 4, 640, 96, None, True, 128),
    "hubert_d80_bidirectional": (1, 4, 4, 513, 80, None, False, 171),
}


def _max_row_rel_err(got, want):
    """Max over rows of |got - want|_2 / |want|_2 (a row norm below 1e-3
    of the mean counts as that floor), as chip_smoke.py's K7 checks."""
    got, want = got.float(), want.float()
    norm = want.norm(dim=-1)
    norm = norm.clamp_min(1e-3 * norm.mean().item())
    return ((got - want).norm(dim=-1) / norm).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(TRAIN_GRAD_CASES))
def test_swa_attention_function_gradients_match_plain(cuda_device, case):
    """``SwaAttention`` on the card (K7 forward, the plain chunked
    backward) against ``ref.swa_attention`` under autograd on the same
    bf16 inputs: out, dq, dk, dv within 1e-2 max row relative error (K7
    rounds P to bf16 before P.V; both round every result to bf16)."""
    from repro_torch.models.layers.attention import SwaAttention

    b, hq, hkv, s, d, window, causal, qc = TRAIN_GRAD_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_(True)
               for h in (hq, hkv, hkv))
    dout = torch.randn((b, hq, s, d), generator=gen, device=cuda_device,
                       dtype=torch.bfloat16)
    before = ops.launch_counts()["swa_attention"]
    out = SwaAttention.apply(q, k, v, window, causal, qc)
    got = (out,) + torch.autograd.grad(out, (q, k, v), dout)
    assert ops.launch_counts()["swa_attention"] == before + 1
    want_out = ref.swa_attention(q, k, v, window=window, causal=causal)
    want = (want_out,) + torch.autograd.grad(want_out, (q, k, v), dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _max_row_rel_err(g, w) <= 1e-2, (name, _max_row_rel_err(g, w))


@pytest.mark.gpu
def test_train_step_at_head_dim_80_reaches_every_parameter(cuda_device):
    """danube-smoke widened to danube's head dim 80, remat on: every
    parameter gets a finite, nonzero gradient on the card, K7 runs twice
    a layer (forward, recompute), and the gradients match the CPU's on
    the same parameters (the CPU runs K7's plain version) within 5e-2
    relative L2 a leaf (tests/train_parity.py's tolerance)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.models.factory import build

    cfg = dataclasses.replace(get_smoke_config("h2o_danube_1p8b"), d_head=80,
                              remat=True)
    host = build(cfg, device="cpu")
    params = host.init(torch.Generator().manual_seed(0))
    card = host.init(torch.Generator().manual_seed(0)).to(cuda_device)
    batch = make_batch(cfg, 2, 96, seed=0)
    before = ops.launch_counts()["swa_attention"]
    loss, _ = build(cfg, device="cuda").loss_fn(card, batch)
    got = torch.autograd.grad(loss, list(card.parameters()))
    assert ops.launch_counts()["swa_attention"] == before + 2 * cfg.n_layers
    want_loss, _ = host.loss_fn(params, batch)
    want = torch.autograd.grad(want_loss, list(params.parameters()))
    assert abs(loss.item() - want_loss.item()) <= 1e-3 * want_loss.item()
    for (name, _), g, w in zip(card.named_parameters(), got, want):
        g = g.cpu()
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert (g - w).norm() <= 5e-2 * w.norm(), name


@pytest.mark.gpu
def test_train_main_runs_on_the_card(cuda_device, tmp_path):
    """``launch.train.main`` on danube-smoke (head dim 32) on the card:
    one K7 launch a layer a step (remat off in the smoke config), finite
    losses, and a checkpoint whose AdamW ``m`` is nonzero in every leaf
    (every parameter had a gradient)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train

    cfg = get_smoke_config("h2o_danube_1p8b")
    before = ops.launch_counts()["swa_attention"]
    losses = train.main(["--arch", "h2o_danube_1p8b", "--smoke", "--steps",
                         "3", "--batch", "2", "--seq", "96", "--ckpt-dir",
                         str(tmp_path), "--ckpt-every", "3"])
    assert ops.launch_counts()["swa_attention"] == before + 3 * cfg.n_layers
    assert len(losses) == 3 and np.isfinite(losses).all()
    step, tree = restore_checkpoint(str(tmp_path))
    assert step == 3 and int(tree["opt"]["count"]) == 3

    def leaves(t):
        return [x for v in t.values() for x in
                (leaves(v) if isinstance(v, dict) else [v])]

    for m in leaves(tree["opt"]["m"]):
        assert np.isfinite(m).all() and np.abs(m).max() > 0
