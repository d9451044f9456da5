"""The elastic autoscaler of the PyTorch port against the JAX package's.

The autoscaler cases of ``tests/test_storage.py`` and
``tests/test_drift.py``, each run in both packages on the same stream
(port ``cuda`` on CPU tensors against JAX's ``pallas``):

  * ``balanced_grid``'s ladder;
  * an undersized one-worker grid (quartered dispatch capacity, an
    8-slot re-queue) relieved by growing: the same decision trail, grid
    and ``dropped`` as JAX, fewer drops than the fixed grid, the
    ``autoscaler_decisions_total`` series summing to the steps and
    ``autoscaler_workers`` equal to ``n_c``;
  * shrinking on idle traffic, and the cooldown and ``max_workers``
    bounds: JAX's trail;
  * a grow fired inside an adaptive-drift boost window (DICS, abrupt
    drift): the detector carried across the rescale bit for bit, the
    loop going on with flags on the new grid, as in JAX.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro.serve import autoscaler as jauto  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.drift import make_scenario  # noqa: E402
from repro_torch.serve import autoscaler as tauto  # noqa: E402
from tests.test_torch_ensemble import one_torch_thread  # noqa: E402,F401

PACKAGES = {"torch": (rt, tauto), "jax": (repro, jauto)}


def _config(pkg, grid=(1, 1), backend="pallas", **kw):
    kw.setdefault("micro_batch", 256)
    if pkg == "torch":
        return rt.StreamConfig(grid=rt.GridSpec.rect(*grid), backend=backend,
                               device="cpu", **kw)
    return jpipe.StreamConfig(grid=JGrid.rect(*grid), backend=backend, **kw)


def _stream(n=1536, n_users=200, n_items=80, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32))


def _trail(session):
    fam = session.metrics.get("autoscaler_decisions_total")
    return {lab["action"]: c.value for lab, c in fam.series()}


def _assert_states_match(t, j):
    want = convert.flatten_state(jax.tree.map(np.asarray, j.states))
    for name, a in convert.states_to_numpy(t.states).items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, want[name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, want[name], err_msg=name)


def test_balanced_grid_ladder_matches_jax():
    for n in range(1, 65):
        t, j = tauto.balanced_grid(n), jauto.balanced_grid(n)
        assert (t.n_i, t.g) == (j.n_i, j.g)
    assert [tauto.balanced_grid(n).shape for n in (1, 2, 4, 8, 16)] == \
        [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4)]
    for kw in (dict(min_workers=0), dict(min_workers=4, max_workers=2),
               dict(shrink_occupancy_frac=0.9)):
        for cls in (tauto.AutoscalePolicy, jauto.AutoscalePolicy):
            with pytest.raises(ValueError):
                cls(**kw)


def _overloaded_run(pkg, autoscale):
    """Mixed ingest+query load against a deliberately undersized grid:
    one worker, quartered dispatch capacity, a tiny re-queue."""
    mod, auto = PACKAGES[pkg]
    rng = np.random.default_rng(7)
    s = mod.StreamSession(_config(pkg, micro_batch=64, capacity_factor=0.25,
                                  carry_slots=8))
    scaler = (auto.Autoscaler(s, auto.AutoscalePolicy(max_workers=8,
                                                      cooldown=0))
              if autoscale else None)
    actions, dropped = [], 0
    for _ in range(8):
        u = rng.integers(0, 400, 512).astype(np.int32)
        i = rng.integers(0, 160, 512).astype(np.int32)
        dropped += s.ingest(u, i).dropped
        s.recommend(u[:8])
        if scaler is not None:
            actions.append(scaler.step())
    return s, actions, dropped


@pytest.mark.parametrize("autoscale", [True, False], ids=["scaled", "fixed"])
def test_autoscaler_relieves_undersized_grid_like_jax(autoscale):
    t, t_actions, t_dropped = _overloaded_run("torch", autoscale)
    j, j_actions, j_dropped = _overloaded_run("jax", autoscale)
    assert t_actions == j_actions
    assert t_dropped == j_dropped
    assert t.grid.shape == j.grid.shape
    _assert_states_match(t, j)
    if autoscale:
        assert "grow" in t_actions and t.grid.n_c > 1
        assert t_dropped < _overloaded_run("torch", False)[2]
        trail = _trail(t)
        assert trail == _trail(j)
        assert sum(trail.values()) == len(t_actions)
        assert t.metrics.get("autoscaler_workers").value == t.grid.n_c


def test_autoscaler_shrinks_when_idle_like_jax():
    users, items = _stream(n=256, n_users=40, n_items=16)
    out = []
    for pkg in ("torch", "jax"):
        mod, auto = PACKAGES[pkg]
        s = mod.StreamSession(_config(
            pkg, grid=(2, 2),
            hyper=mod.DisgdHyper(u_cap=512, i_cap=64)))
        scaler = auto.Autoscaler(s, auto.AutoscalePolicy(
            min_workers=1, cooldown=0, grow_occupancy_frac=1.0,
            shrink_occupancy_frac=0.99))
        s.ingest(users, items)
        out.append((scaler.step(), s.grid.shape, _trail(s)))
    assert out[0] == out[1]
    assert out[0][0] == "shrink" and out[0][1] == (2, 1)


def test_autoscaler_cooldown_and_bounds_like_jax():
    users, items = _stream(n=256)
    trails = []
    for pkg in ("torch", "jax"):
        mod, auto = PACKAGES[pkg]
        s = mod.StreamSession(_config(pkg, micro_batch=64,
                                      capacity_factor=0.25, carry_slots=8))
        scaler = auto.Autoscaler(s, auto.AutoscalePolicy(max_workers=2,
                                                         cooldown=2))
        steps = []
        for _ in range(4):
            s.ingest(users, items)
            steps.append((scaler.step(), s.grid.n_c))
        trails.append(steps)
    assert trails[0] == trails[1]
    assert trails[0][:3] == [("grow", 2), ("hold", 2), ("hold", 2)]
    assert trails[0][3][0] in ("hold", "shrink")


def test_autoscaler_rescale_mid_boost_preserves_drift_loop_like_jax():
    sc = make_scenario("abrupt", events=16384, seed=0, at=0.5)
    n, chunk, tail = len(sc.users), 1024, 2048
    runs = {}
    for pkg in ("torch", "jax"):
        mod, auto = PACKAGES[pkg]
        session = mod.StreamSession(_config(
            pkg, algorithm="dics", hyper=mod.DicsHyper(u_cap=256, i_cap=64),
            drift=mod.DriftPolicy(boost_batches=8)))
        scaler = auto.Autoscaler(session, auto.AutoscalePolicy(
            cooldown=0, max_workers=4, grow_occupancy_frac=0.5))
        hi = 0
        while hi < n - tail and int(
                session._detector.fires
                if session._detector is not None else 0) < 1:
            session.ingest(sc.users[hi:hi + chunk], sc.items[hi:hi + chunk])
            hi += chunk
        before = [np.asarray(x) for x in session._detector]
        assert int(session._detector.fires) >= 1
        action = scaler.step()
        after = [np.asarray(x) for x in session._detector]
        r2 = session.ingest(sc.users[hi:], sc.items[hi:])
        runs[pkg] = (hi, action, session.grid.shape, before, after,
                     np.asarray(r2.drift_flags), session)
    t, j = runs["torch"], runs["jax"]
    assert t[:3] == j[:3] == (t[0], "grow", (2, 1))
    for a, b, c in zip(t[3], t[4], j[3]):
        np.testing.assert_array_equal(a, b)     # carried across the regrid
        np.testing.assert_array_equal(a, c)     # equal to JAX's
    np.testing.assert_array_equal(t[5], j[5])
    for a, b in zip(t[6]._detector, j[6]._detector):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _assert_states_match(t[6], j[6])
