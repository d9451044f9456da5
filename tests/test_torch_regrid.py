"""Regrid of the PyTorch port against the JAX package.

The counterparts of ``tests/test_regrid.py``, each held to JAX's result
on the same state: DISGD and DICS trained by JAX (``scan``, the first
2,048 events of ``synth_stream(scaled(MOVIELENS_25M, 0.002))``, grid
2 x 2, u_cap 512, i_cap 64, micro-batch 256) and moved to the port with
``core.convert``. Exactly, float tables included:

  * ``extract_logical`` (every leaf);
  * ``regrid`` to the identity, a refine (4 x 2, 4 x 4), a coarsen (1 x 1,
    2 x 1, 1 x 2), a non-divisible shape (3 x 2, 2 x 3) and a column
    change (1 x 4) with merge ``fresh``; merge ``mean`` and a capacity
    shrink (u_cap 64, i_cap 16: slot collisions evict) on the identity
    and 3 x 2;
  * the same under a storage policy, and a policy migration
    (``storage`` -> ``storage_out``), in the encoded bytes;
  * the handmade coarsening of ``test_merge_policies_on_coarsening``
    (diverged replicas of one user), both merges, and an unknown merge;
  * resume after a regrid: half the stream, regrid (identity and 2 x 2 ->
    4 x 2), the other half on the port and on JAX.
"""

import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import regrid as jrg  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core import storage as jstorage  # noqa: E402
from repro.core.dics import DicsHyper as JDics  # noqa: E402
from repro.core.disgd import DisgdHyper as JDisgd  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro_torch.core import convert, regrid, storage  # noqa: E402
from repro_torch.core import state as state_lib  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402
from tests.test_torch_storage import _assert_same_tables, _bits  # noqa: E402

HYPERS = {"disgd": (rt.DisgdHyper, JDisgd), "dics": (rt.DicsHyper, JDics)}
CAPS = dict(u_cap=512, i_cap=64)
SHAPES = [(2, 2), (4, 2), (4, 4), (1, 1), (2, 1), (1, 2), (3, 2), (2, 3),
          (1, 4)]


@functools.lru_cache(maxsize=None)
def _stream(n=2048):
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users[:n], items[:n]


def _cfgs(algo, grid=(2, 2)):
    th, jh = HYPERS[algo]
    t = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec.rect(*grid),
                        micro_batch=256, backend="scan", hyper=th(**CAPS),
                        device="cpu")
    j = jpipe.StreamConfig(algorithm=algo, grid=JGrid.rect(*grid),
                           micro_batch=256, backend="scan", hyper=jh(**CAPS))
    return t, j


@functools.lru_cache(maxsize=None)
def _trained(algo):
    """JAX's trained states (device arrays), shared by the tests."""
    return jpipe.run_stream(*_stream(), _cfgs(algo)[1]).final_states


def _port(j_states):
    return convert.states_from_numpy(
        convert.flatten_state(jax.tree.map(np.asarray, j_states)),
        device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("algo", sorted(HYPERS))
def test_extract_logical_matches_jax(algo):
    js = _trained(algo)
    got = regrid.extract_logical(_port(js), rt.GridSpec.rect(2, 2))
    want = jrg.extract_logical(js, JGrid.rect(2, 2))
    assert regrid.LogicalState._fields == jrg.LogicalState._fields
    for f, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


# Every shape with merge "fresh" and the test's capacities; "mean" and a
# capacity shrink on the identity and a non-divisible shape (JAX compiles
# build_states anew for each).
REGRIDS = ([(dst, "fresh", None) for dst in SHAPES]
           + [(dst, merge, caps) for dst in ((2, 2), (3, 2))
              for merge, caps in (("mean", None), ("fresh", (64, 16)),
                                  ("mean", (64, 16)))])


@pytest.mark.parametrize(
    "dst,merge,caps", REGRIDS,
    ids=[f"{d[0]}x{d[1]}-{m}-{'shrink' if c else 'caps'}"
         for d, m, c in REGRIDS])
@pytest.mark.parametrize("algo", sorted(HYPERS))
def test_regrid_matches_jax(algo, dst, merge, caps):
    js = _trained(algo)
    kw = {} if caps is None else dict(u_cap=caps[0], i_cap=caps[1])
    want = jrg.regrid(js, JGrid.rect(2, 2), JGrid.rect(*dst), merge=merge,
                      **kw)
    got = regrid.regrid(_port(js), rt.GridSpec.rect(2, 2),
                        rt.GridSpec.rect(*dst), merge=merge, **kw)
    _assert_same_tables(got, _np(want))
    if dst == (2, 2) and caps is None and merge == "fresh":
        # The identity, bit for bit ("mean" divides (v w) / w: rounded).
        _assert_same_tables(got, _np(js))


@pytest.mark.parametrize("policy", ["compressed", "bf16", "int8", "migrate"])
@pytest.mark.parametrize("algo", sorted(HYPERS))
def test_regrid_under_a_policy_matches_jax(algo, policy):
    desc = {"compressed": dict(co="uint16", rated="packed"),
            "bf16": dict(factors="bf16", co="uint16", rated="packed"),
            "int8": dict(co="int8", rated="packed"),
            "migrate": dict(co="uint16", rated="packed")}[policy]
    out = dict(factors="bf16", co="int8") if policy == "migrate" else desc
    tp, jp = rt.StoragePolicy(**desc), jstorage.StoragePolicy(**desc)
    to, jo = rt.StoragePolicy(**out), jstorage.StoragePolicy(**out)
    js = jstorage.encode_state(_trained(algo), jp)
    ts = storage.encode_state(_port(_trained(algo)), tp)
    _assert_same_tables(ts, _np(js))
    for dst in ((2, 2), (1, 4), (4, 2)):
        want = jrg.regrid(js, JGrid.rect(2, 2), JGrid.rect(*dst),
                          storage=jp, storage_out=jo)
        got = regrid.regrid(ts, rt.GridSpec.rect(2, 2),
                            rt.GridSpec.rect(*dst), storage=tp,
                            storage_out=to)
        _assert_same_tables(got, _np(want))


def _handmade(init, k=4):
    """Two diverged replicas of user 0 on the rows of a (2, 1) grid
    (``tests/test_regrid.py::test_merge_policies_on_coarsening``)."""
    vec = {0: np.arange(k, dtype=np.float32),
           1: 10.0 + np.arange(k, dtype=np.float32)}
    freq, ts = {0: 3, 1: 1}, {0: 5, 1: 9}
    flats = []
    for row in (0, 1):
        st = convert.states_to_numpy(init(4, 4, k, device="cpu"))
        st["user_ids"][0], st["user_freq"][0] = 0, freq[row]
        st["user_ts"][0], st["item_ids"][0] = ts[row], row
        st["clock"][...] = 10
        st["user_vecs"][0] = vec[row]
        flats.append(st)
    return {name: np.stack([f[name] for f in flats]) for name in flats[0]}


@pytest.mark.parametrize("merge", ["fresh", "mean", "median"])
def test_merge_policies_on_coarsening_match_jax(merge):
    flat = _handmade(state_lib.init_disgd_state)
    j_states = jstate.DisgdState(
        jstate.Tables(*(jnp.asarray(flat[f]) for f in jstate.Tables._fields)),
        *(jnp.asarray(flat[f]) for f in ("user_vecs", "item_vecs", "rated")))
    src, dst = (2, 1), (1, 1)
    args = (rt.GridSpec.rect(*src), rt.GridSpec.rect(*dst))
    if merge == "median":
        with pytest.raises(ValueError, match="merge"):
            regrid.regrid(convert.states_from_numpy(flat, device="cpu"),
                          *args, merge=merge)
        return
    got = regrid.regrid(convert.states_from_numpy(flat, device="cpu"), *args,
                        merge=merge)
    want = jrg.regrid(j_states, JGrid.rect(*src), JGrid.rect(*dst),
                      merge=merge)
    _assert_same_tables(got, _np(want))
    assert int(got.tables.user_freq[0, 0]) == 4
    assert int(got.tables.user_ts[0, 0]) == 9


@pytest.mark.parametrize("dst", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
@pytest.mark.parametrize("algo", sorted(HYPERS))
def test_resume_after_regrid_matches_jax(algo, dst):
    users, items = _stream()
    cut = users.size // 2
    t_cfg, j_cfg = _cfgs(algo)
    jh = jpipe.run_stream(users[:cut], items[:cut], j_cfg)
    th = rt.run_stream(users[:cut], items[:cut], t_cfg)
    jd, td = _cfgs(algo, dst)
    j_rest = jpipe.run_stream(
        users[cut:], items[cut:], td,
        initial_states=jrg.regrid(jh.final_states, JGrid.rect(2, 2),
                                  JGrid.rect(*dst)))
    t_rest = rt.run_stream(
        users[cut:], items[cut:], jd,
        initial_states=regrid.regrid(th.final_states, rt.GridSpec.rect(2, 2),
                                     rt.GridSpec.rect(*dst)))
    np.testing.assert_array_equal(t_rest.recall.bits(),
                                  j_rest.recall.bits())
    got = convert.states_to_numpy(t_rest.final_states)
    for name, want in convert.flatten_state(_np(j_rest.final_states)).items():
        if name in ("user_vecs", "item_vecs"):
            np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
    if dst == (2, 2):       # the identity regrid resumes as if never cut
        whole = rt.run_stream(users, items, t_cfg)
        for name, w in convert.states_to_numpy(whole.final_states).items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)

