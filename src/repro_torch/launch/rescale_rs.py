"""Elastic rescale driver: train → checkpoint → re-shard → resume → serve.

Port of ``repro/launch/rescale_rs.py``; the same flags plus ``--device``,
and ``--backend`` defaults to ``cuda``.

The end-to-end autoscaling story for the S&R recommender: train the
stream on one worker grid, write a grid-portable logical checkpoint
(``save_stream_checkpoint(grid=...)``), "scale out" by restoring the same
checkpoint at a different ``(n_i, g)`` — ``restore_stream_checkpoint``
rebuilds worker tables for the new shape via ``repro_torch.core.regrid`` — then
resume the stream mid-flight on the new grid and keep serving queries the
whole way through: the front-end answers from the last pre-rescale
snapshot, retargets to the new shape, and serves the regridded snapshot
before the first post-rescale micro-batch has even trained.

  PYTHONPATH=src python -m repro_torch.launch.rescale_rs \\
      --algorithm disgd --events 8192 --micro-batch 256 \\
      --from-grid 2x2 --to-grid 4x4 --split 0.5 --queries 256

(Sibling drivers: ``serve_rs`` fixed-grid train-and-serve,
``repro_torch.launch.serve`` the unrelated LLM decode driver.)
"""

from __future__ import annotations

import dataclasses
import tempfile
import time

import numpy as np

from repro_torch.checkpoint import latest_step
from repro_torch.core import state as state_lib
from repro_torch.core.pipeline import (restore_stream_checkpoint, run_stream,
                                       save_stream_checkpoint)
from repro_torch.launch import common
from repro_torch.launch.common import parse_grid
from repro_torch.obs import MetricsRegistry, TelemetryFolder
from repro_torch.serve import QueryFrontend, ServeConfig, SnapshotStore


def main(argv=None):
    ap = common.base_parser(__doc__.splitlines()[0], grid=False)
    ap.add_argument("--from-grid", default="2x2", type=parse_grid,
                    help="initial n_i x g worker grid")
    ap.add_argument("--to-grid", default="4x4", type=parse_grid,
                    help="worker grid after the rescale")
    ap.add_argument("--split", type=float, default=0.5,
                    help="fraction of the stream trained before rescaling")
    ap.add_argument("--queries", type=int, default=256,
                    help="query burst size at each serving point")
    ap.add_argument("--batch", type=int, default=64, help="query micro-batch")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    args = ap.parse_args(argv)

    cfg_a = common.stream_config(args, grid=args.from_grid)

    users, items = common.demo_stream(args.events, args.seed)
    cut = int(args.split * users.size)

    # One registry across both grids: snapshot/serve instruments live in
    # the store/front-end, engine telemetry folds in after each phase.
    registry = MetricsRegistry()
    folder = TelemetryFolder(registry)
    store = SnapshotStore(registry=registry)
    frontend = QueryFrontend(
        store, ServeConfig.from_stream(cfg_a, batch_size=args.batch))
    rng = np.random.default_rng(args.seed + 1)
    pool = np.unique(users)

    def burst(tag: str):
        q = rng.choice(pool, size=args.queries)
        t0 = time.perf_counter()
        resp = frontend.serve(q)
        dt = time.perf_counter() - t0
        print(f"[rescale_rs]   {tag}: {q.size} queries in {dt * 1e3:.1f}ms "
              f"({q.size / max(dt, 1e-9):,.0f} QPS, "
              f"snapshot v{resp.snapshot_version}, "
              f"fallbacks={resp.fallbacks})")

    # --- phase 1: train on the initial grid -----------------------------
    with common.obs_capture(args):
        res1 = run_stream(users[:cut], items[:cut], cfg_a)
    if res1.telemetry is not None:
        folder.fold(res1.telemetry)
    store.publish(res1.final_states, res1.events_processed)
    print(f"[rescale_rs] phase 1: {res1.events_processed} events on "
          f"{args.from_grid.shape} ({cfg_a.grid.n_c} workers, "
          f"{res1.throughput:,.0f} ev/s), "
          f"recall@{args.top_n}={res1.recall.mean():.4f}")
    burst("pre-rescale serve")

    # --- checkpoint in the grid-portable logical format -----------------
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="rescale_rs_")
    save_stream_checkpoint(ckpt_dir, res1.events_processed, res1.final_states,
                           grid=args.from_grid, algorithm=args.algorithm)
    print(f"[rescale_rs] logical checkpoint @ {res1.events_processed} "
          f"events -> {ckpt_dir}")

    # --- scale out: restore the same checkpoint at the target grid ------
    cfg_b = dataclasses.replace(cfg_a, grid=args.to_grid)
    step = latest_step(ckpt_dir)
    t0 = time.perf_counter()
    ck = restore_stream_checkpoint(ckpt_dir, cfg_b, step)
    events_done, states, carry = ck.events_processed, ck.states, ck.carry
    restore_s = time.perf_counter() - t0
    print(f"[rescale_rs] restored step {step} at {args.to_grid.shape} "
          f"({cfg_b.grid.n_c} workers) in {restore_s * 1e3:.1f}ms")

    # Serve the regridded snapshot before any post-rescale training: a
    # copy, since phase 2 updates ``states`` in place.
    store.publish(state_lib.clone_state(states), events_done)
    frontend.retarget(cfg_b.grid)
    burst("post-regrid serve")

    # --- phase 2: resume the stream on the new grid ---------------------
    res2 = run_stream(users[cut:], items[cut:], cfg_b,
                      initial_states=states, initial_carry=carry)
    if res2.telemetry is not None:
        # The phase-2 vector restarts from zero (new run_stream call).
        folder.rebase()
        folder.fold(res2.telemetry)
    store.publish(res2.final_states, events_done + res2.events_processed)
    bits = np.concatenate([res1.recall.bits(), res2.recall.bits()])
    bits = bits[~np.isnan(bits)]
    print(f"[rescale_rs] phase 2: {res2.events_processed} events on "
          f"{args.to_grid.shape} ({res2.throughput:,.0f} ev/s), "
          f"dropped={res1.dropped + res2.dropped}, "
          f"stream recall@{args.top_n}={bits.mean():.4f} "
          f"(post-rescale {res2.recall.mean():.4f})")
    burst("post-rescale serve")
    common.export_metrics(args, registry)
    return res1, res2, frontend


if __name__ == "__main__":
    main()
