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
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from tests.test_torch_kernels_gpu import (  # noqa: E402
    ATOL, ISGD_NAMES, RTOL, SWA_TOL, TABLE_NAMES, _EV_NAMES,
    _assert_state_equal, _dics_events, _dics_state, _dics_topn_inputs,
    _events, _isgd_inputs, _late_candidates, _score_inputs, _swa_inputs,
    _factor_case, _negatives, _torch_dics_apply, _torch_factor_apply,
    _worker_state)


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


# -- K6 isgd_update and K7 swa_attention ------------------------------------


@pytest.mark.parametrize("u_cap,i_cap,k,e", [(16, 16, 4, 10), (64, 48, 10, 100),
                                             (128, 64, 32, 257)])
def test_isgd_apply_matches_jax_kernel(u_cap, i_cap, k, e):
    """Repeated slots and invalid events, against the Pallas body
    (interpret mode) and the JAX oracle, at the JAX test's rtol 1e-5 /
    atol 1e-6."""
    inp = _isgd_inputs(np.random.default_rng(u_cap + e), u_cap, i_cap, k, e)
    args = [torch.tensor(inp[n]) for n in ISGD_NAMES]
    before = ops.launch_counts()["isgd_update"]
    got_u, got_i = ops.isgd_update(*args, eta=0.05, lam=0.01)
    assert ops.launch_counts()["isgd_update"] == before  # CPU: plain version
    jargs = [jnp.asarray(inp[n]) for n in ISGD_NAMES]
    for want_u, want_i in (
            jops.isgd_update(*jargs, eta=0.05, lam=0.01, interpret=True),
            jref.isgd_apply(*jargs, eta=0.05, lam=0.01)):
        np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i),
                                   rtol=1e-5, atol=1e-6)


def test_isgd_chain_through_one_slot_matches_jax_kernel():
    """Eight events on the same user and item rows: each reads the rows
    the previous one wrote (``tests/test_kernels.py:50``)."""
    k = 4
    ut = np.full((4, k), 0.3, np.float32)
    it = np.full((4, k), 0.3, np.float32)
    zeros, ones = np.zeros(8, np.int32), np.ones(8, bool)
    got_u, got_i = ops.isgd_update(
        *(torch.tensor(x) for x in (ut, it, zeros, zeros, ones)),
        eta=0.1, lam=0.0)
    want_u, want_i = jops.isgd_update(
        *(jnp.asarray(x) for x in (ut, it, zeros, zeros, ones)),
        eta=0.1, lam=0.0, interpret=True)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=1e-5)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-5)
    assert not np.allclose(got_u.numpy()[0], ut[0])   # the chain moved it


def test_isgd_apply_skips_slots_outside_the_tables():
    """An event whose user or item slot lies outside its table changes
    nothing, as in the kernel: the same as marking it invalid (exact)."""
    inp = _isgd_inputs(np.random.default_rng(35), 64, 48, 10, 100)
    u_bad, i_bad = inp["u_slots"].copy(), inp["i_slots"].copy()
    u_bad[::7], u_bad[3::7], i_bad[5::11] = 64, -1, 48
    inside = (u_bad >= 0) & (u_bad < 64) & (i_bad < 48)
    runs = []
    for u_s, i_s, valid in ((u_bad, i_bad, inp["valid"]),
                            (np.where(inside, u_bad, 0),
                             np.where(inside, i_bad, 0), inp["valid"] & inside)):
        args = [torch.tensor(inp[n]) for n in ISGD_NAMES]
        args[2:] = [torch.tensor(x) for x in (u_s, i_s, valid)]
        runs.append([a.numpy() for a in ops.isgd_update(*args, eta=0.05,
                                                        lam=0.01)])
    for got, want in zip(*runs):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(runs[0][0], inp["user_tab"])


def test_isgd_edge_slots_match_jax_kernel():
    """In-range edge slots (0, U - 1, I - 1), each repeated in a chain,
    against the Pallas body (interpret mode) and the JAX oracle, at the
    tolerance of the K6 tests above. Slots outside the tables fall outside
    the parity contract (``ops.isgd_update``)."""
    u_cap, i_cap, k, e = 16, 12, 10, 40
    inp = _isgd_inputs(np.random.default_rng(39), u_cap, i_cap, k, e)
    rng = np.random.default_rng(40)
    inp["u_slots"] = rng.choice([0, u_cap - 1, 0, 5], e).astype(np.int32)
    inp["i_slots"] = rng.choice([0, i_cap - 1, i_cap - 1, 3],
                                e).astype(np.int32)
    inp["u_slots"][:6] = u_cap - 1              # a chain through one pair
    inp["i_slots"][:6] = i_cap - 1
    got_u, got_i = ops.isgd_update(*(torch.tensor(inp[n]) for n in ISGD_NAMES),
                                   eta=0.05, lam=0.01)
    jargs = [jnp.asarray(inp[n]) for n in ISGD_NAMES]
    for want_u, want_i in (
            jops.isgd_update(*jargs, eta=0.05, lam=0.01, interpret=True),
            jops.isgd_update(*jargs, eta=0.05, lam=0.01)):
        np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i),
                                   rtol=1e-5, atol=1e-6)
    for tab, slots in ((got_u, (0, u_cap - 1)), (got_i, (0, i_cap - 1))):
        for s in slots:                        # every edge row was trained
            assert not np.array_equal(tab[s].numpy(), inp[
                "user_tab" if tab is got_u else "item_tab"][s])


# -- K5 dics_topn's list building --------------------------------------------

# csrc/dics_topn.cu's kGroup (queries a CTA), kWarps (warps a CTA) and
# kMaxDynamicSmem, and the lanes of a warp.
K5_GROUP, K5_WARPS, K5_SMEM, LANES = 8, 8, 200 * 1024, 32


def _k5_group(n_i):
    """The kernel's queries a CTA at ``n_i`` items: kGroup, fewer where
    their compacted histories would not fit its shared memory."""
    per_query = 4 * n_i + 4 * -(-n_i // 32)
    g = K5_GROUP
    while g > 1 and g * per_query > K5_SMEM:
        g -= 1
    return g


def dics_topn_schedule(co, item_cnt, hist, known, item_ids, top_n, k_nn):
    """The ``dics_topn`` kernel's way to ``ref.dics_topn``'s lists, step by
    step in Python (small shapes only): the masses are
    ``ref.neighbour_mass``'s, the list building is the kernel's.

    Per CTA of ``_k5_group(I)`` queries (CTA c of n takes rows c, c + n,
    ...): queries with a history each form a work item; the others (no
    history, or an unknown user) share one "empty" work item whose
    candidates all score -inf. For each item, warp ``v`` takes the
    candidates ``p = LANES * v + lane + LANES * K5_WARPS * j`` in steps of
    LANES and keeps a running top-N, one entry per lane: the lanes whose
    (score, id) beats the list's last entry are inserted in lane order,
    each behind the entries it does not beat, re-checking the rest
    against the new last entry. The warp lists are merged by N rounds of
    an arg-max over their heads by (score desc, id asc, warp asc).
    Returns (ids i32[W, B, n], scores f32[W, B, n]).
    """
    n_w, n_b, n_i = hist.shape
    n = min(top_n, n_i)
    group = _k5_group(n_i)
    mass = ref.neighbour_mass(ref.similarity_matrix(co, item_cnt), hist,
                              k_nn)
    cand = ((item_ids >= 0)[:, None, :] & ~hist & known[..., None]
            & (mass > 0))
    scores = torch.where(cand, mass, float("-inf")).tolist()
    ids = item_ids.tolist()
    has_hist = (known & hist.any(-1)).tolist()
    worst = (float("-inf"), 2**31 - 1)           # an unused entry

    def better(a, b):
        return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])

    def warp_list(row, ids_w, v):
        lst = [worst] * n
        for base in range(LANES * v, n_i, LANES * K5_WARPS):
            offers = [(row[p], ids_w[p])
                      for p in range(base, min(base + LANES, n_i))]
            pend = [e for e in offers if better(e, lst[-1])]
            while pend:
                e = pend.pop(0)
                r = sum(not better(e, x) for x in lst)
                if r < n:
                    lst = lst[:r] + [e] + lst[r:-1]
                pend = [x for x in pend if better(x, lst[-1])]
        return lst

    def merge(lists):
        heads, out = [0] * len(lists), []
        for _ in range(n):
            best = None
            for v, lst in enumerate(lists):
                e = lst[heads[v]] if heads[v] < n else worst
                if best is None or better(e, best[0]):
                    best = (e, v)
            out.append(best[0])
            heads[best[1]] += 1
        return out

    out_ids = torch.empty((n_w, n_b, n), dtype=torch.int32)
    out_sc = torch.empty((n_w, n_b, n), dtype=torch.float32)
    for w in range(n_w):
        n_cta = -(-n_b // group)
        for c in range(n_cta):
            rows = range(c, n_b, n_cta)
            items = {b: scores[w][b] for b in rows if has_hist[w][b]}
            if any(not has_hist[w][b] for b in rows):
                items["empty"] = [float("-inf")] * n_i
            lists = {x: merge([warp_list(row, ids[w], v)
                               for v in range(K5_WARPS)])
                     for x, row in items.items()}
            for b in rows:
                lst = lists[b if has_hist[w][b] else "empty"]
                out_sc[w, b] = torch.tensor([e[0] for e in lst])
                out_ids[w, b] = torch.tensor([e[1] for e in lst],
                                             dtype=torch.int32)
    return out_ids, out_sc


# (n_w, b, i), top_n, k_nn: B not a multiple of the 8 queries a CTA
# serves, I not a multiple of a warp's 32 candidates or of the CTA's 256,
# lists as long as the kernel keeps (32), and a worker with fewer items
# than warps * 32 (some warps' lists stay empty).
SCHEDULE_CASES = {
    "tiny": ((2, 9, 37), 7, 5),
    "items_300": ((2, 11, 300), 10, 10),
    "lists_32": ((2, 10, 70), 32, 32),
    "items_20": ((2, 8, 20), 20, 32),
}


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_dics_topn_schedule_matches_plain(case, ties):
    """The kernel's list building (``dics_topn_schedule``: the shared
    list of history-less queries, each warp's running top-N over its
    share of the candidates, the warp lists' merge) gives the plain
    version's lists exactly: ties broken by id, dead slots (id -1) and
    unknown users included."""
    shape, top_n, k_nn = SCHEDULE_CASES[case]
    args = [torch.tensor(x) for x in
            _dics_topn_inputs(np.random.default_rng(41), *shape, ties=ties)]
    got_ids, got_sc = dics_topn_schedule(*args, top_n, k_nn)
    want_ids, want_sc = ref.dics_topn(*args, top_n, k_nn)
    assert torch.equal(got_ids, want_ids)
    assert torch.equal(got_sc, want_sc)
    assert torch.isinf(want_sc).any() and torch.isfinite(want_sc).any()


def test_k5_group_follows_the_kernels_shared_memory():
    """The model's queries a CTA: 8 at the serve shape (I 768), fewer
    where 8 compacted histories pass the kernel's 200 KB (I 7,000: 7)."""
    assert _k5_group(768) == 8
    assert _k5_group(6_200) == 8
    assert _k5_group(7_000) == 7
    assert _k5_group(60_000) == 1


# -- K3 fused_topn's list building -------------------------------------------

# csrc/fused_topn.cu's kGroup (queries a CTA), kWarps (warps a CTA) and
# kItems (consecutive items a thread).
K3_GROUP, K3_WARPS, K3_ITEMS = 8, 8, 4
_WORST = (float("-inf"), 2**31 - 1)              # an unused list entry


def _better(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _offer(lst, offers):
    """topn_merge.cuh's ``offer``: the offers (in lane order) that beat
    the list's last entry go in one by one, each behind the entries it
    does not beat, the rest re-checked against the new last entry."""
    n = len(lst)
    pend = [e for e in offers if _better(e, lst[-1])]
    while pend:
        e = pend.pop(0)
        r = sum(not _better(e, x) for x in lst)
        if r < n:
            lst = lst[:r] + [e] + lst[r:-1]
        pend = [x for x in pend if _better(x, lst[-1])]
    return lst


def _merge(lists, n):
    """``merge_lists``: n rounds of an arg-max over the lists' heads by
    (score desc, id asc, list asc), each popping the winner's head."""
    heads, out = [0] * len(lists), []
    for _ in range(n):
        best = None
        for v, lst in enumerate(lists):
            e = lst[heads[v]] if heads[v] < n else _WORST
            if best is None or _better(e, best[0]):
                best = (e, v)
        out.append(best[0])
        heads[best[1]] += 1
    return out


def fused_topn_schedule(u_vecs, item_vecs, mask, item_ids, top_n):
    """The ``fused_topn`` kernel's way to ``ref.fused_topn``'s lists, step
    by step in Python (small shapes only): the scores are
    ``ref.masked_scores``', the list building is the kernel's.

    Per CTA of K3_GROUP queries (CTA c of n takes rows c, c + n, ...),
    the items go 1,024 a pass. Query q's one list (its warp's): per pass,
    lane l marks which of its items ``base + 32 j + l`` (j < 32) beat the
    list's last entry at the start of the pass (finite scores only); while
    the list still fills (its last entry -inf), a pass with no finite
    score is skipped, and only scores no lower than the pass floor (the
    N-th largest of the 32 lanes' best scores) are marked; then each round
    j with a mark offers the marked lanes' entries. The list of
    candidate-less rows: warp v = t // 32 of thread t keeps a list of the
    ids of items ``base + 4 t .. base + 4 t + 3`` at -inf (item j of every
    lane, then item j + 1), and the warp lists are merged. A query with N
    finite entries keeps its list, one with none takes the -inf list (the
    worker's N smallest ids), and one with 1 to N - 1 takes an exact pass:
    warp v offers items ``32 v + lane + 256 j`` with their scores or -inf,
    32 at a time, and the warp lists are merged.
    Returns (ids i32[W, B, n], scores f32[W, B, n]).
    """
    n_w, n_b, n_i = mask.shape
    n = min(top_n, n_i)
    threads = 32 * K3_WARPS
    span = threads * K3_ITEMS
    scores = ref.masked_scores(u_vecs, item_vecs, mask).tolist()
    ids = item_ids.tolist()
    ninf = float("-inf")

    def query_list(row, ids_w):
        lst = [_WORST] * n
        for base in range(0, n_i, span):
            last = lst[-1]
            floor = ninf
            if last[0] == ninf:        # the list still fills
                best = [max((row[p] for p in range(base + l, base + span, 32)
                             if p < n_i), default=ninf) for l in range(32)]
                if max(best) == ninf:
                    continue
                floor = sorted(best, reverse=True)[n - 1]
            marks = [[p < n_i and row[p] > ninf and row[p] >= floor
                      and _better((row[p], ids_w[p]), last)
                      for p in range(base + 32 * j, base + 32 * j + 32)]
                     for j in range(span // 32)]
            for j, lanes in enumerate(marks):
                if any(lanes):
                    lst = _offer(lst, [
                        (row[base + 32 * j + l], ids_w[base + 32 * j + l])
                        if lanes[l] else _WORST for l in range(32)])
        return lst

    def empty_lists(ids_w):
        lists = []
        for v in range(K3_WARPS):
            lst = [_WORST] * n
            for base in range(0, n_i, span):
                for j in range(K3_ITEMS):
                    lst = _offer(lst, [
                        (ninf, ids_w[p]) if p < n_i else _WORST
                        for p in (base + K3_ITEMS * (32 * v + lane) + j
                                  for lane in range(32))])
            lists.append(lst)
        return lists

    def exact_lists(row, ids_w):
        lists = []
        for v in range(K3_WARPS):
            lst = [_WORST] * n
            for base in range(32 * v, n_i, threads):
                lst = _offer(lst, [(row[p], ids_w[p]) if p < n_i else _WORST
                                   for p in range(base, base + 32)])
            lists.append(lst)
        return lists

    out_ids = torch.empty((n_w, n_b, n), dtype=torch.int32)
    out_sc = torch.empty((n_w, n_b, n), dtype=torch.float32)
    for w in range(n_w):
        empty = _merge(empty_lists(ids[w]), n)
        n_cta = -(-n_b // K3_GROUP)
        for c in range(n_cta):
            for b in range(c, n_b, n_cta):
                lst = query_list(scores[w][b], ids[w])
                finite = sum(e[0] > ninf for e in lst)
                if finite == 0:
                    lst = empty
                elif finite < n:
                    lst = _merge(exact_lists(scores[w][b], ids[w]), n)
                out_sc[w, b] = torch.tensor([e[0] for e in lst])
                out_ids[w, b] = torch.tensor([e[1] for e in lst],
                                             dtype=torch.int32)
    return out_ids, out_sc


def _fused_case(rng, shape, top_n, kind, ties):
    """``_score_inputs`` made into one of K3's hard cases: ``"few"`` (row
    r keeps 0, 1, N - 1, N, N + 1 or all of its candidates), ``"late"``
    (``_late_candidates``: a list that still fills when a later pass of N
    or more candidates begins),
    ``"none"`` (padding rows only: no candidate anywhere)."""
    u, it, mask, ids = _score_inputs(rng, *shape, ties=ties)
    if kind == "few":
        for r in range(mask.shape[1]):
            c = [0, 1, top_n - 1, top_n, top_n + 1, shape[2]][r % 6]
            mask[:, r] &= np.cumsum(mask[:, r], axis=-1) <= c
    elif kind == "late":
        _late_candidates(u, it, mask, top_n)
    elif kind == "none":
        mask[:] = False
    return [torch.tensor(x) for x in (u, it, mask, ids)]


# (n_w, b, i, k), top_n, kind: I not a multiple of a thread's 4 items or
# of the CTA's 1,024 (37, 1,030), B not a multiple of the CTA's 8
# queries, rows with 0, 1, N - 1, N, N + 1 and all candidates, rows whose
# list still fills after the first of 3 passes (the pass floor), padding
# rows only, lists of 1 and 32, and I < N.
K3_SCHEDULE_CASES = {
    "tiny": ((2, 9, 37, 4), 7, None),
    "few_candidates": ((2, 13, 1030, 3), 10, "few"),
    "late_candidates": ((1, 9, 3072, 3), 10, "late"),
    "late_lists_32": ((1, 9, 3072, 3), 32, "late"),
    "padding_only": ((1, 10, 300, 3), 10, "none"),
    "lists_1": ((1, 9, 100, 3), 1, "few"),
    "lists_32": ((1, 12, 300, 3), 32, "few"),
    "items_below_n": ((2, 9, 7, 4), 10, None),
}


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("case", list(K3_SCHEDULE_CASES))
def test_fused_topn_schedule_matches_plain(case, ties):
    """The kernel's list building (``fused_topn_schedule``: one lane list
    a query offered its marked finite scores pass by pass, the shared -inf
    list of rows without a candidate, the exact pass of rows with 1 to
    N - 1, the merges) gives the plain version's lists exactly: ties
    broken by id, duplicate -1 ids of empty slots included."""
    shape, top_n, kind = K3_SCHEDULE_CASES[case]
    args = _fused_case(np.random.default_rng(61), shape, top_n, kind, ties)
    got_ids, got_sc = fused_topn_schedule(*args, top_n)
    want_ids, want_sc = ref.fused_topn(*args, top_n)
    assert torch.equal(got_ids, want_ids)
    assert torch.equal(got_sc, want_sc)
    if kind != "none":
        assert torch.isinf(want_sc).any() and torch.isfinite(want_sc).any()


def test_fused_topn_schedule_matches_the_pallas_kernel():
    """Tied integer factors (exact scores), rows with few candidates and
    dead slots: the schedule's lists equal the Pallas body's (interpret
    mode) exactly."""
    args = _fused_case(np.random.default_rng(62), (2, 12, 40, 4), 7, "few",
                       True)
    got_ids, got_sc = fused_topn_schedule(*args, 7)
    for w in range(2):
        want_ids, want_sc = jops.fused_topn(
            *(jnp.asarray(x[w].numpy()) for x in args), top_n=7,
            interpret=True)
        np.testing.assert_array_equal(got_ids[w].numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_sc[w].numpy(), np.asarray(want_sc))


# -- K6 isgd_update's replay -------------------------------------------------

# csrc/isgd_update.cu's warps and largest chunk (k <= 22 fits 2,048 events).
K6_WARPS, K6_CHUNK = 32, 2048


def _previous_events(slots, ok):
    """For each event, the previous ``ok`` event on its slot (-1: none),
    and whether it is the last one: the kernel's links."""
    prev = np.full(slots.size, -1)
    last = np.zeros(slots.size, bool)
    order = np.lexsort((np.arange(slots.size), slots))
    order = order[ok[order]]
    for a, b in zip(order[:-1], order[1:]):
        if slots[a] == slots[b]:
            prev[b] = a
    for a, b in zip(order, list(order[1:]) + [-1]):
        last[a] = b < 0 or slots[a] != slots[b]
    return prev, last


def isgd_schedule(user_tab, item_tab, u_slots, i_slots, valid, *, eta, lam,
                  chunk=K6_CHUNK):
    """The ``isgd_update`` kernel's way to ``ref.isgd_apply``, IN PLACE:
    per chunk, each valid in-range event linked to the previous one on
    its user and its item row, the rows of events with no previous one
    gathered, then a dataflow replay on the staged rows: an event belongs
    to warp ``slot % K6_WARPS`` of its row in the table with more links in
    the chunk; each warp runs its events in order, each once both of its
    previous events have run (the warps take turns, one event at a time),
    with the plain version's arithmetic; every row is written back by its
    last event. Returns (user_tab, item_tab, [chain depth of each chunk]).
    """
    u_all, i_all = u_slots.numpy(), i_slots.numpy()
    inside = ((u_all >= 0) & (u_all < user_tab.shape[0]) & (i_all >= 0)
              & (i_all < item_tab.shape[0]))
    ok_all = valid.numpy().astype(bool) & inside
    depths = []
    for e0 in range(0, u_all.size, chunk):
        us, is_ = u_all[e0:e0 + chunk], i_all[e0:e0 + chunk]
        ok = ok_all[e0:e0 + chunk]
        pu, last_u = _previous_events(us, ok)
        pi, last_i = _previous_events(is_, ok)
        urow = {e: user_tab[us[e]:us[e] + 1].clone()
                for e in np.flatnonzero(ok & (pu < 0))}
        irow = {e: item_tab[is_[e]:is_[e] + 1].clone()
                for e in np.flatnonzero(ok & (pi < 0))}
        owner = (is_ if (pi >= 0).sum() > (pu >= 0).sum() else us) % K6_WARPS
        queues = [[e for e in range(us.size) if ok[e] and owner[e] == v]
                  for v in range(K6_WARPS)]
        level = {}
        while any(queues):
            ran = False
            for q in queues:
                if not q:
                    continue
                e = q[0]
                a, b = pu[e], pi[e]
                if (a >= 0 and a not in level) or (b >= 0 and b not in level):
                    continue
                u = urow[a if a >= 0 else e]
                i = irow[b if b >= 0 else e]
                err = 1.0 - (u * i).sum(-1, keepdim=True)
                urow[e] = u + eta * (err * i - lam * u)
                irow[e] = i + eta * (err * u - lam * i)
                level[e] = 1 + max(level.get(a, 0), level.get(b, 0))
                q.pop(0)
                ran = True
            assert ran, "the replay waits on an event that never runs"
        for e in np.flatnonzero(ok & last_u):
            user_tab[us[e]:us[e] + 1] = urow[e]
        for e in np.flatnonzero(ok & last_i):
            item_tab[is_[e]:is_[e] + 1] = irow[e]
        depths.append(max(level.values(), default=0))
    return user_tab, item_tab, depths


def _isgd_chain_case(rng, kind, u_cap=64, i_cap=48, k=10, n_ev=1024):
    inp = _isgd_inputs(rng, u_cap, i_cap, k, n_ev)
    if kind == "one_slot":             # every event on one user and item row
        inp["u_slots"][:] = 5
        inp["i_slots"][:] = 3
    elif kind == "alternating":        # two rows each, taking turns
        inp["u_slots"] = (np.arange(n_ev) % 2 * 9).astype(np.int32)
        inp["i_slots"] = (np.arange(n_ev) // 2 % 2 * 7).astype(np.int32)
    elif kind == "outside":            # slots past either table skipped
        inp["u_slots"][::5] = u_cap
        inp["i_slots"][3::7] = -1
    return inp


@pytest.mark.parametrize("chunk", [K6_CHUNK, 100])
@pytest.mark.parametrize("kind", ["one_slot", "alternating", "random",
                                  "outside"])
def test_isgd_schedule_matches_plain_bit_for_bit(kind, chunk):
    """The kernel's replay order (``isgd_schedule``) gives the plain
    version's tables bit for bit: one row pair hit by every event (a chain
    as long as the batch), rows taking turns, random slots at E = 1,024
    (and chunks of 100 events, so rows carry over between chunks), slots
    outside the tables."""
    inp = _isgd_chain_case(np.random.default_rng(71), kind)
    got = [torch.tensor(inp[n]) for n in ISGD_NAMES]
    want = [torch.tensor(inp[n]) for n in ISGD_NAMES]
    got_u, got_i, depths = isgd_schedule(*got, eta=0.05, lam=0.01,
                                         chunk=chunk)
    want_u, want_i = ref.isgd_apply(*want, eta=0.05, lam=0.01)
    assert torch.equal(got_u, want_u) and torch.equal(got_i, want_i)
    n_ok = int(inp["valid"].sum())
    if kind == "one_slot":             # one event after another
        assert sum(depths) == n_ok
    if kind == "random":               # far shorter than the batch
        assert max(depths) < n_ok // 10


def test_isgd_schedule_matches_the_pallas_kernel():
    """Random slots with repeats and invalid events: the schedule's tables
    against the Pallas body (interpret mode), at the K6 tests'
    tolerance."""
    inp = _isgd_chain_case(np.random.default_rng(72), "random", 32, 24, 8,
                           200)
    got_u, got_i, _ = isgd_schedule(
        *(torch.tensor(inp[n]) for n in ISGD_NAMES), eta=0.05, lam=0.01,
        chunk=64)
    want_u, want_i = jops.isgd_update(
        *(jnp.asarray(inp[n]) for n in ISGD_NAMES), eta=0.05, lam=0.01,
        interpret=True)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-5,
                               atol=1e-6)


def _swa_check(q, k, v, dtype, *, window, causal=True, pallas=True):
    """ops.swa_attention on CPU tensors (the plain version) against the
    JAX oracle and, where S is a multiple of 64, the Pallas body."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    got = ops.swa_attention(*(torch.tensor(x).to(tdt) for x in (q, k, v)),
                            window=window, causal=causal)
    assert got.dtype == tdt
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    wants = [jref.swa_attention(jq, jk, jv, window=window, causal=causal)]
    if pallas:
        wants.append(jops.swa_attention(jq, jk, jv, window=window,
                                        causal=causal, block_q=64,
                                        block_k=64, interpret=True))
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **SWA_TOL[dtype])
    return got


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [None, 32, 128])
def test_swa_attention_matches_jax_kernel(hq, hkv, window):
    """``tests/test_kernels.py:69``'s sweep: GQA groups 1, 2 and 8."""
    q, k, v = _swa_inputs(np.random.default_rng(hq * 7 + hkv), 2, hq, hkv,
                          256, 32)
    _swa_check(q, k, v, "float32", window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 80])
def test_swa_attention_head_dims_and_dtypes_match_jax_kernel(d, dtype):
    """danube's head_dim 80 (no power of two) and 32, in f32 and bf16."""
    q, k, v = _swa_inputs(np.random.default_rng(d), 1, 4, 2, 128, d)
    _swa_check(q, k, v, dtype, window=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_attention_ragged_matches_jax_oracle(dtype):
    """S = 200: no multiple of a block; the Pallas kernel refuses it (the
    JAX wrapper takes the oracle), the port's kernel masks the tail."""
    q, k, v = _swa_inputs(np.random.default_rng(5), 1, 4, 2, 200, 80)
    _swa_check(q, k, v, dtype, window=48, pallas=False)


@pytest.mark.parametrize("window", [None, 32])
def test_swa_attention_non_causal_matches_jax_kernel(window):
    q, k, v = _swa_inputs(np.random.default_rng(6), 1, 4, 2, 128, 32)
    _swa_check(q, k, v, "float32", window=window, causal=False)


def test_swa_attention_rows_without_keys_give_zero():
    """causal=False, window 0: row r sees keys (r, S), so the last row
    sees none. The Pallas body gives 0 there (p zeroed while m is still
    -1e30, l == 0 -> 0); so does the port (the JAX oracle gives NaN)."""
    q, k, v = _swa_inputs(np.random.default_rng(7), 1, 2, 1, 128, 32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = np.asarray(jops.swa_attention(jq, jk, jv, window=0, causal=False,
                                         block_q=64, block_k=64,
                                         interpret=True))
    got = ops.swa_attention(*(torch.tensor(x) for x in (q, k, v)), window=0,
                            causal=False).numpy()
    assert np.all(want[:, :, -1] == 0) and np.all(got[:, :, -1] == 0)
    np.testing.assert_allclose(got, want, **SWA_TOL["float32"])


# -- the bf16 K7 kernel's tile classes ---------------------------------------
#
# csrc/swa_attention.cu visits, for each block of bq q rows, the kv tiles of
# bk keys from the rows' first visible key to their last, and masks only
# the boundary ones. ref.swa_tile_classes mirrors that rule; here it is
# held against the brute-force visible set of every (row, key) pair.

SWA_MASKS = [(None, True), (None, False), (1, True), (100, True),
             (129, True), (4095, True), (48, False), (0, False)]


def _visible(s, window, causal):
    r, c = np.arange(s)[:, None], np.arange(s)[None, :]
    vis = np.ones((s, s), bool)
    if causal:
        vis &= c <= r
    if window is not None:
        vis &= c > r - window
    return vis


@pytest.mark.parametrize("s", [1, 5, 127, 128, 129, 300, 513])
@pytest.mark.parametrize("window,causal", SWA_MASKS)
@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128)])
def test_swa_tile_classes_match_the_visible_pairs(s, window, causal, bq, bk):
    cls = ref.swa_tile_classes(s, window, causal, bq, bk).numpy()
    nq, nk = cls.shape
    vis = _visible(s, window, causal)
    # Any pair visible in a tile; every pair visible, where rows past S
    # (never stored) count as seeing all and keys past S as unseen.
    some = np.zeros((nq * bq, nk * bk), bool)
    some[:s, :s] = vis
    every = np.ones((nq * bq, nk * bk), bool)
    every[:s, :] = False
    every[:s, :s] = vis
    some = some.reshape(nq, bq, nk, bk).any((1, 3))
    every = every.reshape(nq, bq, nk, bk).all((1, 3))
    visited = cls != ref.SWA_SKIPPED
    assert not np.any(some & ~visited), "a visible pair in a skipped tile"
    assert not np.any((cls == ref.SWA_FULL) & ~every), \
        "a full tile holds a pair that is not visible"
    for row in visited:            # the kernel walks one run lo..hi
        idx = np.flatnonzero(row)
        assert idx.size == 0 or idx[-1] - idx[0] + 1 == idx.size


def test_swa_tile_classes_at_the_serving_shape():
    """h2o-danube's prefill: S 8,192, window 4,096, 128 x 128 tiles. An
    interior q block visits 33 tiles: 31 full, 2 boundary (the diagonal
    and the window's lower edge); a block before the first full window
    visits its causal prefix, only the diagonal masked."""
    cls = ref.swa_tile_classes(8192, 4096, True, 128, 128)
    full = (cls == ref.SWA_FULL).sum(1).tolist()
    boundary = (cls == ref.SWA_BOUNDARY).sum(1).tolist()
    assert full[32:] == [31] * 32 and boundary[32:] == [2] * 32
    assert full[:32] == list(range(32)) and boundary[:32] == [1] * 32
    assert int((cls != ref.SWA_SKIPPED).sum()) == 32 * 33 + sum(
        range(1, 33))


# -- the staged schedule of K1 (ISGD) and K4 --------------------------------
#
# A numpy model of how csrc/bucket_stage.cuh reorders a bucket: per chunk,
# the tenancy and clears worked out from the chunk-start tables, the chain
# replayed on staged copies, then every entry written once by its last
# writer, `rated` by the rule (a set survives unless a later event of the
# chunk clears its row or column; otherwise a cleared cell ends at 0), and
# DICS's co / cnt adds in a shuffled order (the kernel's atomics) after the
# clears. Held against the sequential plain versions on buckets dense in
# collisions: the reasoning the kernels rest on, checked where there is no
# card.


def _negatives_pass(ev_i, us, is_, js, valid, flags, iid, rated, stale):
    """The pairwise analysis of csrc/factor_update.cu on one chunk: each
    valid event's neg_ok from the chunk-start tenant iid[js] and byte
    rated[us, js] (the tables are still at chunk start here), replayed
    against the chunk's earlier events: the last earlier i event on js
    is its tenant; the event's own new user zeroes the byte, else the
    last earlier op on the cell (a set of (us, js): 1; a clear of row us
    or column js: 0) decides. ``stale`` reads the staged byte alone."""
    upd = np.zeros(len(js), bool)
    for e in np.flatnonzero(valid):
        tenant, t_found = iid[js[e]], False
        r_found = bool(flags[e][0]) and not stale
        byte = 0 if r_found else rated[us[e], js[e]]
        for f in range(e - 1, -1, -1):
            if stale or (t_found and r_found):
                break
            if not valid[f]:
                continue
            col = is_[f] == js[e]
            if not t_found and col:
                tenant, t_found = ev_i[f], True
            if not r_found:
                row = us[f] == us[e]
                if row and col:
                    byte, r_found = 1, True
                elif (row and flags[f][0]) or (col and flags[f][1]):
                    byte, r_found = 0, True
        upd[e] = (js[e] != is_[e] and tenant >= 0 and tenant != ev_i[e]
                  and not byte)
    return upd


def _staged_chunk(st, w, ev, lo, hi, dics, rng, eta=0.0, lam=0.0,
                  stale=False):
    ev_u, ev_i = ev["ev_u"][w, lo:hi], ev["ev_i"][w, lo:hi]
    us, is_ = ev["u_slots"][w, lo:hi], ev["i_slots"][w, lo:hi]
    n = hi - lo
    valid = ev_u >= 0
    touch = np.ones(n, bool) if dics else valid
    uid, iid = st["user_ids"][w], st["item_ids"][w]
    u0 = {s: uid[s] for s in us[touch]}          # staged tenants
    i0 = {s: iid[s] for s in is_[touch]}
    flags = []
    last_row, last_col = {}, {}
    ten_u, ten_i = dict(u0), dict(i0)            # replayed tenancy
    for e in range(n):
        if not touch[e]:
            flags.append((False, False))
            continue
        new_u, new_i = ten_u[us[e]] != ev_u[e], ten_i[is_[e]] != ev_i[e]
        if new_u:
            last_row[us[e]] = e
        if new_i:
            last_col[is_[e]] = e
        if valid[e]:
            ten_u[us[e]], ten_i[is_[e]] = ev_u[e], ev_i[e]
        flags.append((new_u, new_i))
    rated = st["rated"][w]
    if dics:   # the history rows, staged and replayed
        rows = {s: rated[s].copy() for s in us}
        snaps = {}
        for e in range(n):
            new_u, new_i = flags[e]
            if new_u:
                rows[us[e]][:] = False
            if new_i:
                for r in rows.values():
                    r[is_[e]] = False
            if valid[e]:
                snaps[e] = np.flatnonzero(rows[us[e]])
                rows[us[e]][is_[e]] = True
    else:      # the SGD chain, on staged rows
        eta_, lam_ = np.float32(eta), np.float32(lam)
        js = None if ev["j_slots"] is None else ev["j_slots"][w, lo:hi]
        upd = (np.zeros(n, bool) if js is None
               else _negatives_pass(ev_i, us, is_, js, valid, flags, iid,
                                    rated, stale))
        uv = {s: st["user_vecs"][w, s].copy() for s in us[valid]}
        # One staged row a slot: an i and a j step on a slot share it.
        iv = {s: st["item_vecs"][w, s].copy()
              for s in np.concatenate([is_[valid], [] if js is None
                                       else js[upd]]).astype(int)}
        for e in np.flatnonzero(valid):
            u = ev["init_u"][w, lo + e] if flags[e][0] else uv[us[e]]
            i = ev["init_i"][w, lo + e] if flags[e][1] else iv[is_[e]]
            if js is None:
                err = np.float32(1.0) - np.dot(u, i)
                uv[us[e]] = u + eta_ * (err * i - lam_ * u)
                iv[is_[e]] = i + eta_ * (err * u - lam_ * i)
            elif upd[e]:
                j = iv[js[e]]
                x = np.dot(u, i) - np.dot(u, j)
                sg = np.float32(1.0) / (np.float32(1.0) + np.exp(x))
                iv[js[e]] = j + eta_ * (-sg * u - lam_ * j)
                uv[us[e]] = u + eta_ * (sg * (i - j) - lam_ * u)
                iv[is_[e]] = i + eta_ * (sg * u - lam_ * i)
            else:      # the negative fails: u and i written unchanged
                uv[us[e]], iv[is_[e]] = u, i
        for s, v in uv.items():
            st["user_vecs"][w, s] = v
        for s, v in iv.items():
            st["item_vecs"][w, s] = v
    # rated: the clears, then the sets that survive them.
    rated[list(last_row)] = False
    rated[:, list(last_col)] = False
    for e in np.flatnonzero(valid):
        if (last_row.get(us[e], -1) <= e and last_col.get(is_[e], -1) <= e):
            rated[us[e], is_[e]] = True
    if dics:   # co / cnt: zero what a clear touches, then surviving adds
        co, cnt = st["co"][w], st["item_cnt"][w]
        cleared = list(last_col)
        co[cleared, :] = 0.0
        co[:, cleared] = 0.0
        cnt[cleared] = 0.0
        adds = [(e, j) for e, hist in snaps.items() for j in hist
                if last_col.get(is_[e], -1) <= e and last_col.get(j, -1) <= e]
        for x in rng.permutation(len(adds)):
            e, j = adds[x]
            co[is_[e], j] += np.float32(1.0)
            co[j, is_[e]] += np.float32(1.0)
        for e in rng.permutation(np.flatnonzero(valid)):
            if last_col.get(is_[e], -1) <= e:
                cnt[is_[e]] += np.float32(1.0)
    # The bookkeeping, by each slot's last valid event.
    clock = st["clock"][w] + np.cumsum(valid)
    for side, ids, slots, flag_at in (("user", ev_u, us, 0),
                                      ("item", ev_i, is_, 1)):
        for s in np.unique(slots[valid]):
            on = np.flatnonzero(valid & (slots == s))
            news = [e for e in on if flags[e][flag_at]]
            freq = (on.size - on.tolist().index(news[-1]) if news
                    else st[f"{side}_freq"][w, s] + on.size)
            st[f"{side}_ids"][w, s] = ids[on[-1]]
            st[f"{side}_freq"][w, s] = freq
            st[f"{side}_ts"][w, s] = clock[on[-1]]
    st["clock"][w] = clock[-1]


def _staged_apply(st, ev, *, dics, chunk, seed=0, eta=0.0, lam=0.0,
                  stale=False):
    st = {n: v.copy() for n, v in st.items()}
    rng = np.random.default_rng(seed)
    n_w, n_ev = ev["ev_u"].shape
    for w in range(n_w):
        for lo in range(0, n_ev, chunk):
            _staged_chunk(st, w, ev, lo, min(n_ev, lo + chunk), dics, rng,
                          eta, lam, stale)
    return st


@pytest.mark.parametrize("chunk", [5, 13, 64])
@pytest.mark.parametrize("seed", range(3))
def test_staged_schedule_matches_factor_apply(seed, chunk):
    """ISGD mode: six user and five item slots under sixty events with
    ids spanning twice the caps and 20% padding, so slots are hit many
    times and users are evicted and re-added inside one chunk."""
    rng = np.random.default_rng(100 + seed)
    n_w, u_cap, i_cap, k, n_ev = 2, 6, 5, 4, 60
    st = _worker_state(rng, n_w, u_cap, i_cap, k)
    ev = _events(rng, n_w, n_ev, u_cap, i_cap, k, False)
    want = _torch_factor_apply(st, ev, "cpu", eta=0.05, lam=0.01,
                               use_ops=False)
    got = _staged_apply(st, ev, dics=False, chunk=chunk, eta=0.05, lam=0.01)
    _assert_state_equal(got, want)


@pytest.mark.parametrize("negatives", ["mixed", "alias", "empty"])
@pytest.mark.parametrize("chunk", [5, 13, 64])
@pytest.mark.parametrize("seed", range(3))
def test_staged_pairwise_schedule_matches_factor_apply(seed, chunk,
                                                       negatives):
    """Pairwise mode at ISGD's collision density: negatives among the
    bucket's own item slots (so on evicted columns and on bytes the
    bucket set), on the event's own slot, or on empty tenants (see
    ``_negatives``). Integers exactly; floats as the card tests hold
    them (the model steps in numpy, the plain version in torch)."""
    rng = np.random.default_rng(300 + seed)
    n_w, u_cap, i_cap, k, n_ev = 2, 6, 5, 4, 60
    st = _worker_state(rng, n_w, u_cap, i_cap, k)
    ev = _events(rng, n_w, n_ev, u_cap, i_cap, k, True)
    st, ev = _negatives(rng, st, ev, negatives)
    want = _torch_factor_apply(st, ev, "cpu", eta=0.05, lam=0.01,
                               use_ops=False)
    got = _staged_apply(st, ev, dics=False, chunk=chunk, eta=0.05, lam=0.01)
    _assert_state_equal(got, want)


@pytest.mark.parametrize("shape", ["dense_mixed", "wide_mixed", "alias"])
def test_staged_pairwise_schedule_needs_the_live_rated_byte(shape):
    """The card cases of the pairwise mode: the schedule holds at the
    kernel's chunk of 256, and a schedule that reads the rated byte and
    the tenant as staged, without the chunk's earlier events, does not."""
    st, ev = _factor_case(shape, True)
    want = _torch_factor_apply(st, ev, "cpu", eta=0.05, lam=0.01,
                               use_ops=False)
    kw = dict(dics=False, chunk=256, eta=0.05, lam=0.01)
    _assert_state_equal(_staged_apply(st, ev, **kw), want)
    with pytest.raises(AssertionError):
        _assert_state_equal(_staged_apply(st, ev, stale=True, **kw), want)


@pytest.mark.parametrize("chunk", [5, 13, 64])
@pytest.mark.parametrize("seed", range(3))
def test_staged_schedule_matches_dics_apply(seed, chunk):
    """DICS: the same collision density, padding that clears live last
    slots, and co / cnt adds in a shuffled order: every array exact."""
    rng = np.random.default_rng(200 + seed)
    n_w, u_cap, i_cap, n_ev = 2, 6, 5, 60
    st = _dics_state(rng, n_w, u_cap, i_cap)
    ev = _dics_events(rng, n_w, n_ev, u_cap, i_cap)
    want = _torch_dics_apply(st, ev, "cpu", use_ops=False)
    got = _staged_apply(st, ev, dics=True, chunk=chunk, seed=seed)
    _assert_state_equal(got, want, rtol=0, atol=0)
    assert any(not np.array_equal(got["co"][w], st["co"][w])
               for w in range(n_w))
