"""The port's kernel path on the 4 x 4 grid against the JAX package.

The main path's grid shape (``GridSpec(n_i=4)``, 16 workers) with caps
that hold every column's users and every split's items (no collisions,
as at deployment size), on ``synth_stream(scaled(MOVIELENS_25M, 0.01))``
(14,104 events) on the CPU: ``backend="cuda"`` against JAX
``backend="pallas"``, recall bits and integer state exactly equal.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402,F401

import repro_torch as rt  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core.disgd import DisgdHyper as JHyper  # noqa: E402
from repro.core.routing import GridSpec as JGrid  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream  # noqa: E402


def test_recall_matches_jax_on_the_main_path_grid():
    profile = scaled(MOVIELENS_25M, 0.01)
    users, items, _ = synth_stream(profile, seed=0)
    # Slots for every user of a column and every item of a split.
    u_cap = -(-profile.n_users // 4 // 64) * 64
    i_cap = -(-profile.n_items // 4 // 64) * 64
    tr = rt.run_stream(users, items, rt.StreamConfig(
        grid=rt.GridSpec(4), micro_batch=2048, backend="cuda",
        hyper=rt.DisgdHyper(u_cap=u_cap, i_cap=i_cap), device="cpu"))
    jr = jpipe.run_stream(users, items, jpipe.StreamConfig(
        grid=JGrid(4), micro_batch=2048, backend="pallas",
        hyper=JHyper(u_cap=u_cap, i_cap=i_cap), telemetry=False))
    assert (tr.events_processed, tr.dropped) == (users.size, 0)
    assert jr.events_processed == users.size
    np.testing.assert_array_equal(tr.recall.bits(), jr.recall.bits())
    assert tr.recall.mean() == jr.recall.mean() > 0
    got = convert.states_to_numpy(tr.final_states)
    want = convert.flatten_state(jax.tree.map(np.asarray, jr.final_states))
    for name, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)
