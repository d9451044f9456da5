"""DICS streams and DICS serving of the PyTorch port against the JAX
package.

``run_stream(algorithm="dics")`` on ``synth_stream(scaled(NETFLIX, 0.0015,
n_items=128))`` (2,909 events, 521 users, 128 items) at ``GridSpec(2)``,
micro-batch 256, u_cap 128 and i_cap 32 — 64 items per split over 32
slots, so item slots collide and the last slot is live — on the CPU:

  * ``backend="scan"`` against JAX ``scan``, and ``backend="cuda"``
    (plain kernel versions on CPU tensors) against JAX ``pallas``, with
    the padding-alias clears shown to fire;
  * the JAX state after half the stream carried into the port, which
    finishes the stream as JAX does;
  * ``grid_topn(algorithm="dics")`` on that state against JAX's.

No tolerance: states (``co`` and ``item_cnt`` included), counters,
recall bits, serving ids and scores are equal.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.dics import DicsHyper as JHyper  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro.serve import plane as jplane  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.stream import NETFLIX, scaled, synth_stream  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serve.plane import query_capacity  # noqa: E402

CAPS = dict(u_cap=128, i_cap=32)


@pytest.fixture(scope="module")
def stream():
    users, items, _ = synth_stream(scaled(NETFLIX, 0.0015, n_items=128),
                                   seed=0)
    return users, items


def _cfgs(backend_t, backend_j):
    t = rt.StreamConfig(algorithm="dics", grid=rt.GridSpec(2),
                        micro_batch=256, backend=backend_t,
                        hyper=rt.DicsHyper(**CAPS), device="cpu")
    j = jpipe.StreamConfig(algorithm="dics", grid=JGrid(2), micro_batch=256,
                           backend=backend_j, hyper=JHyper(**CAPS),
                           telemetry=False)
    return t, j


@pytest.fixture(scope="module")
def jax_pallas(stream):
    """JAX ``pallas`` over the whole stream and over its first half."""
    users, items = stream
    j_cfg = _cfgs("cuda", "pallas")[1]
    half = users.size // 2
    return (jpipe.run_stream(users, items, j_cfg),
            jpipe.run_stream(users[:half], items[:half], j_cfg))


def _flat(j_states):
    return convert.flatten_state(jax.tree.map(np.asarray, j_states))


def _assert_results_match(tr, jr, n):
    assert tr.events_processed == jr.events_processed
    assert tr.dropped == jr.dropped
    assert tr.events_processed + tr.dropped == n
    got = convert.states_to_numpy(tr.final_states)
    for name, want in _flat(jr.final_states).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    np.testing.assert_array_equal(np.stack(tr.load_history),
                                  np.stack(jr.load_history))
    np.testing.assert_array_equal(tr.recall.bits(), jr.recall.bits())


@pytest.fixture
def alias_clears(monkeypatch):
    """Counts padding events whose aliased slot clear ran."""
    fired = [0]
    clear = ref.dics_clear

    def counting(*args):
        new_u, new_i = clear(*args)
        u_id, live = args[5], args[9]
        hit = (u_id < 0) & (new_u | new_i)
        if live is not None:
            hit = hit & live
        fired[0] += int(hit.sum())
        return new_u, new_i

    monkeypatch.setattr(ref, "dics_clear", counting)
    return fired


@pytest.mark.parametrize("backends", [("scan", "scan"), ("cuda", "pallas"),
                                      ("host", "host")],
                         ids=["scan", "cuda", "host"])
def test_run_stream_matches_jax(stream, jax_pallas, alias_clears, backends):
    users, items = stream
    t_cfg, j_cfg = _cfgs(*backends)
    tr = rt.run_stream(users, items, t_cfg)
    jr = (jax_pallas[0] if backends[1] == "pallas"
          else jpipe.run_stream(users, items, j_cfg))
    _assert_results_match(tr, jr, users.size)
    assert tr.recall.mean() > 0.02
    assert alias_clears[0] > 0
    # Item slots collide: the last slot is live at the end of the stream.
    assert (tr.final_states.tables.item_ids[:, -1] >= 0).any()


def test_state_carries_from_jax_mid_stream(stream, jax_pallas):
    """JAX trains the first half; the port, from the converted state,
    finishes the stream exactly as JAX does."""
    users, items = stream
    half = users.size // 2
    t_cfg, j_cfg = _cfgs("cuda", "pallas")
    j_first = jax_pallas[1]
    t_states = convert.states_from_numpy(_flat(j_first.final_states),
                                         device="cpu")
    tr = rt.run_stream(users[half:], items[half:], t_cfg,
                       initial_states=t_states)
    jr = jpipe.run_stream(users[half:], items[half:], j_cfg,
                          initial_states=j_first.final_states)
    _assert_results_match(tr, jr, users.size - half)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_grid_topn_matches_jax_on_carried_state(stream, jax_pallas,
                                                use_kernel):
    users, _ = stream
    j_states = jax_pallas[0].final_states
    t_states = convert.states_from_numpy(_flat(j_states), device="cpu")
    rng = np.random.default_rng(3)
    q = np.concatenate([rng.choice(np.unique(users), 90, replace=False),
                        [-1, 10**6, -1]]).astype(np.int32)
    kw = dict(algorithm="dics", top_n=10, u_cap=CAPS["u_cap"],
              qcap=query_capacity(q.size, 2), k_nn=10, use_kernel=use_kernel)
    want = jplane.grid_topn(j_states, jnp.asarray(q), grid=JGrid(2), **kw)
    got = rt.grid_topn(t_states, torch.tensor(q), grid=rt.GridSpec(2), **kw)
    for g, w, name in zip(got, want, ("ids", "scores", "known", "served")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert np.isfinite(got[1].numpy()).sum() > 50    # real lists served
    assert got[3].sum() == 91                         # all but padding


@pytest.mark.parametrize("backend", ["scan", "cuda"])
def test_step_without_events_changes_no_state(backend):
    """The JAX engine skips a step with no events (its ``lax.cond`` dead
    branch), so the padding clears of a drain step must not run: on
    states whose last slots are live, such a step changes nothing; a step
    with one event runs them on every worker."""
    from repro_torch.core import engine
    from tests.test_torch_kernels_gpu import _dics_state

    t_cfg = _cfgs(backend, "pallas")[0]
    flat = _dics_state(np.random.default_rng(5), t_cfg.grid.n_c, **CAPS)
    assert flat["co"][:, -1].any() and flat["rated"][:, -1].any()
    step = engine._make_batch_step(t_cfg, engine.make_worker_fn(t_cfg,
                                                                backend))
    carry = engine.init_scan_carry(
        t_cfg, states=convert.states_from_numpy(flat, device="cpu"))
    fresh = torch.full((t_cfg.micro_batch,), -1, dtype=torch.int32)
    carry, _ = step(carry, fresh, fresh)
    got = convert.states_to_numpy(carry[0])
    for name, want in flat.items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    fresh[0] = 0
    carry, _ = step(carry, fresh, fresh)
    got = convert.states_to_numpy(carry[0])
    assert not got["co"][:, -1].any() and not got["rated"][:, -1].any()
