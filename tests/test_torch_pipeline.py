"""The PyTorch port's streaming pipeline against the JAX package.

``run_stream`` on ``synth_stream(scaled(MOVIELENS_25M, 0.002))`` (2,423
events, 310 users for 2 x 128 user slots: slots collide) at
``GridSpec(n_i=2)``, u_cap 128, i_cap 32, micro-batch 256, on the CPU:

  * ``backend="scan"`` against JAX ``backend="scan"``, and
    ``backend="cuda"`` (plain kernel versions on CPU tensors) against JAX
    ``backend="pallas"`` (its jnp oracles off TPU);
  * the overflow re-queue and the drop count, with buckets and the carry
    buffer too small for the traffic;
  * state carried across the two packages half way through the stream.

Integers (state, dispatch loads, counters) exactly; factor vectors within
1e-5 (summation order, init vectors within a few f32 ulp of XLA's);
recall bits equal (no score on this stream lies within that tolerance of
a tie).
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch as rt  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.disgd import DisgdHyper as JHyper  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
CAPS = dict(u_cap=128, i_cap=32)


@pytest.fixture(scope="module")
def stream():
    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.002), seed=0)
    return users, items


def _cfgs(backend_t, backend_j, **over):
    t = rt.StreamConfig(grid=rt.GridSpec(2), micro_batch=256,
                        backend=backend_t, hyper=rt.DisgdHyper(**CAPS),
                        device="cpu", **over)
    j = jpipe.StreamConfig(grid=JGrid(2), micro_batch=256, backend=backend_j,
                           hyper=JHyper(**CAPS), telemetry=False, **over)
    return t, j


def _jax_states(flat):
    tables = jstate.Tables(*(jnp.asarray(flat[f])
                             for f in jstate.Tables._fields))
    return jstate.DisgdState(tables, jnp.asarray(flat["user_vecs"]),
                             jnp.asarray(flat["item_vecs"]),
                             jnp.asarray(flat["rated"]))


def _assert_results_match(tr, jr, n):
    assert tr.events_processed == jr.events_processed
    assert tr.dropped == jr.dropped
    assert tr.events_processed + tr.dropped == n
    got = convert.states_to_numpy(tr.final_states)
    want = convert.flatten_state(jax.tree.map(np.asarray, jr.final_states))
    for name, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    np.testing.assert_array_equal(np.stack(tr.load_history),
                                  np.stack(jr.load_history))
    np.testing.assert_array_equal(tr.recall.bits(), jr.recall.bits())
    for a, b in zip(tr.user_occupancy + tr.item_occupancy,
                    jr.user_occupancy + jr.item_occupancy):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], np.asarray(b[1]))


@pytest.mark.parametrize("backends", [("scan", "scan"), ("cuda", "pallas"),
                                      ("pallas", "pallas")],
                         ids=["scan", "cuda", "pallas_alias"])
def test_run_stream_matches_jax(stream, backends):
    users, items = stream
    t_cfg, j_cfg = _cfgs(*backends)
    tr = rt.run_stream(users, items, t_cfg)
    jr = jpipe.run_stream(users, items, j_cfg)
    _assert_results_match(tr, jr, users.size)
    assert tr.telemetry is None and tr.recall.mean() > 0


def test_overflow_requeue_and_drops_match_jax(stream):
    """Buckets at half the fair share and a 24-slot carry buffer: events
    re-queue in stream order, the rest are dropped and counted."""
    users, items = (x[:1200] for x in stream)
    t_cfg, j_cfg = _cfgs("cuda", "pallas", capacity_factor=0.5,
                         carry_slots=24)
    tr = rt.run_stream(users, items, t_cfg)
    jr = jpipe.run_stream(users, items, j_cfg)
    assert tr.dropped > 0
    _assert_results_match(tr, jr, users.size)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_state_carries_across_packages_mid_stream(stream, first):
    """Half the stream in one package, the other half in the other from
    the converted state: the end state equals the one package's run."""
    users, items = stream
    half = users.size // 2
    t_cfg, j_cfg = _cfgs("cuda", "pallas")
    j_first = jpipe.run_stream(users[:half], items[:half], j_cfg)
    if first == "jax":
        flat = convert.flatten_state(jax.tree.map(np.asarray,
                                                  j_first.final_states))
        tr = rt.run_stream(users[half:], items[half:], t_cfg,
                           initial_states=convert.states_from_numpy(
                               flat, device="cpu"))
    else:
        t_first = rt.run_stream(users[:half], items[:half], t_cfg)
        # Read before continuing: run_stream updates its states in place.
        flat = convert.states_to_numpy(t_first.final_states)
        tr = rt.run_stream(users[half:], items[half:], t_cfg,
                           initial_states=t_first.final_states)
        jr_cross = jpipe.run_stream(users[half:], items[half:], j_cfg,
                                    initial_states=_jax_states(flat))
        _assert_results_match(tr, jr_cross, users.size - half)
    jr = jpipe.run_stream(users[half:], items[half:], j_cfg,
                          initial_states=j_first.final_states)
    _assert_results_match(tr, jr, users.size - half)


def test_resumed_carry_matches_jax(stream):
    """A re-queue handed over at resume is drained first, as in JAX."""
    users, items = (x[:600] for x in stream)
    carry = tuple(x[600:640] for x in stream)
    t_cfg, j_cfg = _cfgs("scan", "scan")
    tr = rt.run_stream(users, items, t_cfg, initial_carry=carry)
    jr = jpipe.run_stream(users, items, j_cfg, initial_carry=carry)
    assert tr.events_processed == users.size + 40
    _assert_results_match(tr, jr, users.size + 40)


@pytest.mark.parametrize("over,needle", [
    (dict(backend="host"), "host-loop slice"),
    (dict(backend="shard_map"), "multi-GPU slice"),
    (dict(backend="tpu"), "unknown backend"),
    (dict(forgetting="lru"), "forgetting"),
    (dict(drift=object()), "drift"),
    (dict(storage=object()), "storage"),
])
def test_unported_options_raise(stream, over, needle):
    cfg = dataclasses.replace(_cfgs("cuda", "pallas")[0], **over)
    with pytest.raises(ValueError, match=needle):
        rt.run_stream(*stream, cfg)


def test_default_config_targets_the_card():
    cfg = rt.StreamConfig()
    assert cfg.device == "cuda" and cfg.backend == "cuda"
    assert cfg.bucket_capacity == jpipe.StreamConfig().bucket_capacity
    grid = rt.GridSpec(4)
    assert (dataclasses.replace(cfg, grid=grid).bucket_capacity
            == jpipe.StreamConfig(grid=JGrid(4)).bucket_capacity)
    assert isinstance(rt.StreamConfig().resolved_hyper(), rt.DisgdHyper)
    assert torch.tensor(0).device.type == "cpu"
