"""The ensemble runtime of the PyTorch port against the JAX package's.

The cases of ``tests/test_ensemble.py``, each held to JAX on the CPU at
its sizes (the first 600-800 events of ``synth_stream(scaled(
MOVIELENS_25M, 0.002))``, ``GridSpec(2)``, micro-batch 128, u_cap 128,
i_cap 32; the drift case on ``make_scenario("recurring", 8192)``):

  * ``ScopedRegistry``: the same operations give the same exposition;
  * the weigher, step by step on random rewards with drift flags, for
    several configurations: reward, mass and the counters bit for bit,
    weights within rtol 1e-6 (``exp`` differs in the last bits), the
    switch choice of every stratum equal; its dict round trip and
    ``popularity_stratum`` equal;
  * ``fuse_topn`` (RRF and Borda, unknown rows, zero weights, ties) and
    ``switch_choice``: bit for bit;
  * ``EnsembleSession`` on the ``cuda`` (CPU tensors, against JAX's
    ``pallas``; the default here), ``scan`` and ``host`` backends:
    segment results (recall bits, drift, resets), member states (factors
    within the port's RTOL / ATOL 1e-5, everything else exactly),
    weights, the registry's
    member-tagged series, blend (RRF, Borda) and switch answers, the
    stratified weigher (``strata=2``) on ``scan`` and ``host``, live
    rescale, the validation errors, and ``ingest(verbose=True)``'s lines;
  * checkpoints across the packages: the ``ensemble.json`` either
    package writes restores in the other, whose own checkpoint of it is
    byte-identical, and one more segment after the restore is equal.
"""

import dataclasses
import functools
import os

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro import ensemble as jens  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro.ensemble import weights as jweights  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs import ScopedRegistry as JScoped  # noqa: E402
from repro_torch import ensemble as tens  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from repro_torch.drift import make_scenario  # noqa: E402
from repro_torch.ensemble import weights as tweights  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
W_RTOL = 1e-6
PAIR = ("dics", "disgd")
BACKENDS = [("scan", "scan"), ("cuda", "pallas"), ("host", "host")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are too small to gain from intra-op threads, and the
    test workers share the cores: with one thread, OpenMP's idle threads
    do not spin against the other workers (several times the suite's
    wall time here)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _stream(n=600):
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:n], items[:n]


def _cfgs(algo, backend=("cuda", "pallas"), grid=(2, 2), u_cap=128, i_cap=32,
          micro_batch=128, drift=False):
    th = rt.get_algorithm(algo).default_hyper()._replace(u_cap=u_cap,
                                                          i_cap=i_cap)
    jh = repro.get_algorithm(algo).default_hyper()._replace(u_cap=u_cap,
                                                            i_cap=i_cap)
    t = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec.rect(*grid),
                        micro_batch=micro_batch, hyper=th,
                        backend=backend[0], device="cpu",
                        drift=rt.DriftPolicy() if drift else None)
    j = jpipe.StreamConfig(algorithm=algo, grid=JGrid.rect(*grid),
                           micro_batch=micro_batch, hyper=jh,
                           backend=backend[1],
                           drift=repro.DriftPolicy() if drift else None)
    return t, j


def _pair(algos=PAIR, weigher=None, blend=None, **cfg_kw):
    cfgs = [_cfgs(a, **cfg_kw) for a in algos]
    t = rt.EnsembleSession(
        [c[0] for c in cfgs],
        weigher=rt.WeigherConfig(**weigher) if weigher else None,
        blend=rt.BlendPolicy(**blend) if blend else None)
    j = repro.EnsembleSession(
        [c[1] for c in cfgs],
        weigher=repro.WeigherConfig(**weigher) if weigher else None,
        blend=repro.BlendPolicy(**blend) if blend else None)
    return t, j


def _nan_equal(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


def _assert_weigher_match(t_state, j_state):
    for name in ("reward", "mass", "resets", "updates"):
        np.testing.assert_array_equal(
            getattr(t_state, name).cpu().numpy(),
            np.asarray(getattr(j_state, name)), err_msg=name)
    tw, jw = t_state.weights.cpu().numpy(), np.asarray(j_state.weights)
    np.testing.assert_allclose(tw, jw, rtol=W_RTOL, atol=0)
    # Every stratum routes to the same member.
    names = [str(i) for i in range(tw.shape[0])]
    for s in range(tw.shape[1]):
        assert (tens.switch_choice(tw[:, s], names)
                == jens.switch_choice(jw[:, s], names))


def _assert_states_match(t_states, j_states, algo):
    got = convert.states_to_numpy(t_states)
    want = convert.flatten_state(jax.tree.map(np.asarray, j_states))
    assert got.keys() == want.keys()
    for name, w in want.items():
        if w.dtype.kind == "f" and algo != "dics":
            np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def _assert_segment_match(tr, jr):
    assert tr.members.keys() == jr.members.keys()
    assert (tr.drift, tr.events_processed, tr.resets) == (
        jr.drift, jr.events_processed, jr.resets)
    for name in tr.members:
        a, b = tr.members[name], jr.members[name]
        assert (a.events_processed, a.dropped) == (b.events_processed,
                                                   b.dropped)
        _nan_equal(a.recall.bits(), b.recall.bits())
        np.testing.assert_allclose(tr.weights[name], jr.weights[name],
                                   rtol=W_RTOL, atol=0)


def _assert_ensembles_match(t, j):
    assert t.member_names == j.member_names
    assert t.events_processed == j.events_processed
    _assert_weigher_match(t.weigher_state, j.weigher_state)
    for name in t.members:
        _assert_states_match(t.members[name].states, j.members[name].states,
                             name)


def _assert_responses_match(got, want):
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_array_equal(got.known, np.asarray(want.known))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=RTOL, atol=ATOL)
    for f in ("snapshot_version", "cache_hits", "fallbacks",
              "staleness_events", "snapshot_forgets"):
        assert getattr(got, f) == getattr(want, f), f


def _series(registry, name):
    """(labels, value) of every series; a histogram's value is its count."""
    def value(inst):
        return (inst.snapshot().count if hasattr(inst, "snapshot")
                else inst.value)

    return sorted((tuple(sorted(lab.items())), value(inst))
                  for lab, inst in registry.get(name).series())


def _ingest_both(t, j, users, items, segments=2):
    for seg in np.array_split(np.arange(users.size), segments):
        _assert_segment_match(t.ingest(users[seg], items[seg]),
                              j.ingest(users[seg], items[seg]))


# ---------------------------------------------------------------------------
# ScopedRegistry
# ---------------------------------------------------------------------------


def test_scoped_registry_matches_jax():
    texts = []
    for registry, scoped in ((rt.MetricsRegistry, rt.ScopedRegistry),
                             (JRegistry, JScoped)):
        reg = registry()
        a, b = scoped(reg, member="a"), scoped(reg, member="b")
        a.counter("x_total", "x").inc(2)
        b.counter("x_total", "x").inc(3)
        a.gauge("y", "y", labels=("k",)).labels(k="1").set(5)
        nested = scoped(a, stage="s")
        assert nested.scope == {"member": "a", "stage": "s"}
        assert nested.base is reg
        assert [lab["member"] for lab, _ in
                a.counter("x_total", "x").series()] == ["a"]
        with pytest.raises(ValueError):
            scoped(reg)
        texts.append(reg.to_prometheus())
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# Weigher
# ---------------------------------------------------------------------------

WEIGHERS = {"default": {}, "strata2": dict(strata=2),
            "strata3_precision": dict(strata=3, reward="precision"),
            "no_reset": dict(drift_reset=False),
            "sharp": dict(eta=60.0, gamma=0.01, decay=0.93,
                          drift_discount=0.5)}


@pytest.mark.parametrize("name", sorted(WEIGHERS))
def test_weigher_step_by_step_matches_jax(name):
    tcfg = rt.WeigherConfig(**WEIGHERS[name])
    jcfg = repro.WeigherConfig(**WEIGHERS[name])
    rng = np.random.default_rng(sorted(WEIGHERS).index(name))
    for m in (2, 3):
        t, j = tweights.weigher_init(m, tcfg), jweights.weigher_init(m, jcfg)
        _assert_weigher_match(t, j)
        s = t.weights.shape[1]
        for _ in range(24):
            evals = rng.integers(0, 600, (m, s)).astype(np.float64)
            evals[rng.random((m, s)) < 0.2] = 0
            hits = np.floor(evals * rng.random((m, s)) * 0.4)
            drift = bool(rng.random() < 0.15)
            t = tweights.weigher_update(t, hits, evals, drift, tcfg)
            j = jweights.weigher_update(j, hits, evals, drift, jcfg)
            _assert_weigher_match(t, j)


def test_weigher_tracks_the_better_member():
    cfg = rt.WeigherConfig()
    st = tens.weigher_init(2, cfg)
    jst = jens.weigher_init(2, repro.WeigherConfig())
    for _ in range(3):
        st = tens.weigher_update(st, [[8.0], [2.0]], [[10.0], [10.0]],
                                 False, cfg)
        jst = jens.weigher_update(jst, [[8.0], [2.0]], [[10.0], [10.0]],
                                  False, repro.WeigherConfig())
    w = st.weights.numpy()[:, 0]
    assert w[0] > 0.6 > 0.4 > w[1]
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-6)
    assert int(st.updates) == 3 and int(st.resets) == 0
    _assert_weigher_match(st, jst)


def test_weigher_unseen_stratum_and_drift_match_jax():
    # An unseen stratum keeps its prior estimate (no phantom zero).
    cfg, jcfg = rt.WeigherConfig(strata=2), repro.WeigherConfig(strata=2)
    args = ([[8.0, 0.0], [2.0, 0.0]], [[10.0, 0.0], [10.0, 0.0]], False)
    st = tens.weigher_update(tens.weigher_init(2, cfg), *args, cfg)
    _assert_weigher_match(st, jens.weigher_update(jens.weigher_init(2, jcfg),
                                                  *args, jcfg))
    np.testing.assert_array_equal(st.reward.numpy()[:, 1], 0.0)
    np.testing.assert_allclose(st.weights.numpy()[:, 1], 0.5)
    # Drift flattens the weights, counts a reset, discounts the mass;
    # drift_reset=False keeps them sharp.
    for over in ({}, dict(drift_reset=False)):
        cfg, jcfg = rt.WeigherConfig(**over), repro.WeigherConfig(**over)
        st, jst = tens.weigher_init(2, cfg), jens.weigher_init(2, jcfg)
        for drift in (False, True):
            st = tens.weigher_update(st, [[9.0], [1.0]], [[10.0], [10.0]],
                                     drift, cfg)
            jst = jens.weigher_update(jst, [[9.0], [1.0]], [[10.0], [10.0]],
                                      drift, jcfg)
            _assert_weigher_match(st, jst)
        assert int(st.resets) == (0 if over else 1)


def test_weigher_dict_roundtrip_and_popularity_strata_match_jax():
    cfg, jcfg = rt.WeigherConfig(strata=3), repro.WeigherConfig(strata=3)
    args = ([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]],
            [[4.0, 4.0, 4.0], [4.0, 4.0, 4.0]], False)
    st = tens.weigher_update(tens.weigher_init(2, cfg), *args, cfg)
    jst = jens.weigher_update(jens.weigher_init(2, jcfg), *args, jcfg)
    # The port writes JAX's dict from JAX's state, and reads it back.
    mirrored = tweights.weigher_from_dict(
        jweights.weigher_to_dict(jst))
    assert tweights.weigher_to_dict(mirrored) == jweights.weigher_to_dict(jst)
    back = tweights.weigher_from_dict(tweights.weigher_to_dict(st))
    for a, b in zip(st, back):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert a.dtype == b.dtype
    freq = [0, 1, 2, 3, 7, 1000]
    np.testing.assert_array_equal(tens.popularity_stratum(freq, 4),
                                  jens.popularity_stratum(freq, 4))
    np.testing.assert_array_equal(tens.popularity_stratum(freq, 4),
                                  [0, 1, 1, 2, 3, 3])


# ---------------------------------------------------------------------------
# Rank fusion and switch routing
# ---------------------------------------------------------------------------


def _random_lists(rng, m=3, q=40, n=10, n_items=30):
    ids, scores, known = [], [], []
    for _ in range(m):
        rows = np.stack([rng.choice(n_items, n, replace=False)
                         for _ in range(q)]).astype(np.int32)
        short = rng.integers(0, n + 1, q)
        rows[np.arange(n)[None, :] >= short[:, None]] = -1
        ids.append(rows)
        scores.append(rng.random((q, n)).astype(np.float32))
        known.append(rng.random(q) < 0.85)
    w = rng.random((q, m)).astype(np.float32)
    w[rng.random((q, m)) < 0.1] = 0.0
    w[:4] = 1.0                       # equal weights: ties to break by id
    return ids, scores, known, w


HAND = {
    "rrf": ([[[5, 7]], [[7, 3]]], [True, True], [[1.0, 1.0]],
            dict(top_n=3, method="rrf", rrf_k=1)),
    "tie": ([[[1, 2]], [[2, 1]]], [True, True], [[1.0, 1.0]],
            dict(top_n=2)),
    "borda_unknown": ([[[5, 7]], [[9, 3]]], [True, False], [[1.0, 1.0]],
                      dict(top_n=2, method="borda")),
    "borda_zero_weight": ([[[5, 7]], [[9, 3]]], [True, True], [[1.0, 0.0]],
                          dict(top_n=2, method="borda")),
    "all_unknown": ([[[5, 7]], [[9, 3]]], [False, False], [[1.0, 1.0]],
                    dict(top_n=2)),
}


@pytest.mark.parametrize("case", sorted(HAND) + ["random_rrf",
                                                 "random_borda"])
def test_fuse_topn_matches_jax(case):
    if case in HAND:
        rows, kn, w, kw = HAND[case]
        ids = [np.array(r, np.int32) for r in rows]
        scores = [np.ones((1, 2), np.float32)] * 2
        known = [np.array([k]) for k in kn]
        w = np.array(w)
    else:
        rng = np.random.default_rng(0 if case.endswith("rrf") else 1)
        ids, scores, known, w = _random_lists(rng)
        kw = dict(top_n=10, method=case.split("_")[1])
    got = tens.fuse_topn(ids, scores, known, w, **kw)
    want = jens.fuse_topn(ids, scores, known, w, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if case == "rrf":
        np.testing.assert_array_equal(got[0][0], [7, 5, 3])
    if case == "tie":
        np.testing.assert_array_equal(got[0][0], [1, 2])
    if case == "all_unknown":
        np.testing.assert_array_equal(got[0][0], [-1, -1])
        assert not got[2][0]


def test_switch_choice_matches_jax():
    rng = np.random.default_rng(3)
    for names in (["a", "b", "c"], ["c", "a", "b"], ["b", "a"]):
        for _ in range(50):
            w = rng.choice([0.2, 0.3, 0.5], len(names))
            assert (tens.switch_choice(w, names)
                    == jens.switch_choice(w, names))
    assert tens.switch_choice(np.array([0.3, 0.3, 0.4]), ["a", "b", "c"]) == 2
    assert tens.switch_choice(np.array([0.5, 0.5]), ["b", "a"]) == 1


# ---------------------------------------------------------------------------
# EnsembleSession
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS, ids=[b[0] for b in BACKENDS])
def test_ensemble_trains_two_algorithms_matches_jax(backend):
    users, items = _stream()
    t, j = _pair(backend=backend)
    _ingest_both(t, j, users, items)
    _assert_ensembles_match(t, j)
    for name in ("stream_events_total", "stream_recall_hits_total",
                 "stream_recall_evals_total", "ensemble_member_weight_trail"):
        assert _series(t.metrics, name) == _series(j.metrics, name), name
    text = t.metrics.to_prometheus()
    assert 'member="dics"' in text and "ensemble_member_weight" in text
    # Serving on every backend: blend and switch equal JAX's.
    uids = np.unique(users)[:24]
    for mode in ("blend", "switch"):
        _assert_responses_match(t.recommend(uids, mode=mode),
                                j.recommend(uids, mode=mode))


def test_ensemble_validates_member_sets_like_jax():
    for make, cfg in ((rt.EnsembleSession, 0), (repro.EnsembleSession, 1)):
        with pytest.raises(ValueError, match="needs >= 2 members"):
            make([_cfgs("dics")[cfg]])
        with pytest.raises(ValueError, match="duplicate"):
            make([_cfgs("dics")[cfg]] * 2)
        ens = make.for_algorithms(["disgd", "dics"], base=_cfgs("dics")[cfg])
        assert ens.member_names == ("dics", "disgd")


def test_blend_and_switch_serving_match_jax():
    users, items = _stream()
    uids = np.concatenate([np.unique(users)[:24], [10**6]])
    t1, j = _pair()
    t2 = rt.EnsembleSession([_cfgs("disgd")[0], _cfgs("dics")[0]])
    for ens in (t1, t2, j):
        ens.ingest(users, items)
    r1 = t1.recommend(uids)
    _assert_responses_match(r1, j.recommend(uids))
    # Config order and a repeated call change nothing.
    r2 = t2.recommend(uids)
    np.testing.assert_array_equal(r1.ids, r2.ids)
    np.testing.assert_array_equal(r1.scores, r2.scores)
    np.testing.assert_array_equal(r1.ids, t1.recommend(uids).ids)
    j.recommend(uids)
    # Switch mode: the argmax member's own answer, counted per member.
    names = list(t1.member_names)
    w = t1.weights
    best = names[tens.switch_choice(np.array([w[m] for m in names]), names)]
    r = t1.recommend(uids, mode="switch")
    _assert_responses_match(r, j.recommend(uids, mode="switch"))
    own = t1.members[best].recommend(uids)
    np.testing.assert_array_equal(r.ids, own.ids)
    assert (_series(t1.metrics, "ensemble_switch_total")
            == _series(j.metrics, "ensemble_switch_total"))
    with pytest.raises(ValueError):
        t1.recommend(uids, mode="winner-takes-all")
    # Borda.
    tb, jb = _pair(blend=dict(method="borda"))
    tb.ingest(users, items)
    jb.ingest(users, items)
    _assert_responses_match(tb.recommend(uids), jb.recommend(uids))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ensemble_checkpoint_crosses_packages(tmp_path, writer):
    users, items = _stream(800)
    t, j = _pair(weigher=dict(reward="precision"))
    _ingest_both(t, j, users[:600], items[:600])
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    t_cfgs = [m.cfg for m in t.members.values()]
    j_cfgs = [m.cfg for m in j.members.values()]
    if writer == "jax":
        j.checkpoint(src)
        back = rt.EnsembleSession.restore(src, t_cfgs)
        live = j
    else:
        t.checkpoint(src)
        back = repro.EnsembleSession.restore(src, j_cfgs)
        live = t
    back.checkpoint(dst)
    with open(os.path.join(src, "ensemble.json"), "rb") as f:
        want = f.read()
    with open(os.path.join(dst, "ensemble.json"), "rb") as f:
        assert f.read() == want
    assert back.weights == live.weights
    assert back.events_processed == live.events_processed
    assert back.weigher_config.reward == "precision"
    uids = np.unique(users)[:16]
    a, b = back.recommend(uids), live.recommend(uids)
    np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
    # One more segment: the restored ensemble continues as the live one.
    ra = back.ingest(users[600:], items[600:])
    rb = live.ingest(users[600:], items[600:])
    if writer == "jax":
        _assert_segment_match(ra, rb)
        _assert_ensembles_match(back, live)
    else:
        _assert_segment_match(rb, ra)
        _assert_ensembles_match(live, back)
    # A restore at another grid (the rescale-through-restart path).
    wide = [dataclasses.replace(c, grid=rt.GridSpec.rect(2, 2))
            for c in t_cfgs]
    big = rt.EnsembleSession.restore(src, wide)
    assert all(m.grid.n_c == 4 for m in big.members.values())
    assert big.recommend(uids).ids.shape == a.ids.shape
    with pytest.raises(ValueError):
        rt.EnsembleSession.restore(src, [_cfgs("dics")[0], _cfgs("bpr")[0]])


def test_ensemble_live_rescale_matches_jax():
    users, items = _stream()
    t, j = _pair()
    _ingest_both(t, j, users, items, segments=1)
    w, st = t.weights, t.weigher_state
    t.rescale(rt.GridSpec.rect(2, 2))
    j.rescale(repro.GridSpec.rect(2, 2))
    assert t.weights == w
    for a, b in zip(st, t.weigher_state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(m.grid.n_c == 4 for m in t.members.values())
    uids = np.unique(users)[:8]
    _assert_responses_match(t.recommend(uids), j.recommend(uids))
    _ingest_both(t, j, users[:256], items[:256], segments=1)
    _assert_ensembles_match(t, j)
    assert int(t.weigher_state.updates) == 2


@pytest.mark.parametrize("backend", [("scan", "scan"), ("host", "host")],
                         ids=["scan", "host"])
def test_stratified_reward_matches_jax(backend):
    users, items = _stream(800)
    t, j = _pair(weigher=dict(strata=2), backend=backend)
    _ingest_both(t, j, users, items)
    _assert_ensembles_match(t, j)
    assert t.weigher_state.weights.shape == (2, 2)
    # The recall-bit layout: fresh bits of every step in submission order.
    for name, member in t.members.items():
        cfg = member.cfg
        res = member.ingest(users[:300], items[:300])
        jres = j.members[name].ingest(users[:300], items[:300])
        got = tens.members._aligned_bits(res, cfg, 300)
        want = jens.members._aligned_bits(jres, j.members[name].cfg, 300)
        _nan_equal(got, want)
    uids = np.unique(users)[:8]
    _assert_responses_match(t.recommend(uids, mode="switch"),
                            j.recommend(uids, mode="switch"))


def test_drift_flag_reopens_exploration_matches_jax():
    sc = make_scenario("recurring", events=8192, seed=0)
    t, j = _pair(u_cap=256, i_cap=64, micro_batch=256, drift=True)
    segments = np.array_split(np.arange(len(sc.users)), 16)
    drift_segment = None
    for seg in segments:
        tr = t.ingest(sc.users[seg], sc.items[seg])
        _assert_segment_match(tr, j.ingest(sc.users[seg], sc.items[seg]))
        if tr.drift and drift_segment is None:
            drift_segment = tr
    assert drift_segment is not None, "no member detector fired"
    assert t.exploration_resets == j.exploration_resets >= 1
    for w in drift_segment.weights.values():
        np.testing.assert_allclose(np.asarray(w), 0.5)
    _assert_ensembles_match(t, j)
    for name in ("ensemble_exploration_resets_total",
                 "ensemble_drift_flags_total"):
        assert _series(t.metrics, name) == _series(j.metrics, name), name
    for lab, hist in t.metrics.get("ensemble_member_weight_trail").series():
        assert hist.snapshot().count == len(segments)


def test_ensemble_ingest_verbose_prints_jax_lines(capsys):
    users, items = _stream()
    lines = []
    for ens in _pair():
        ens.ingest(users[:300], items[:300], verbose=True)
        lines.append(capsys.readouterr().out.splitlines())
    assert lines[0] and lines[0] == lines[1]
