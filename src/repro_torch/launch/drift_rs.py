"""Closed-loop concept-drift driver for the S&R recommender.

Port of ``repro/launch/drift_rs.py``; the same flags plus ``--device``,
and ``--backend`` defaults to ``cuda``.

Runs a named drift scenario through the streaming engine with a chosen
forgetting policy and reports the closed-loop story end to end: where the
drift really happened, where the on-device detector fired, how deep the
recall dip was, and how many events the recovery took — the numbers
``benchmarks/bench_drift.py`` sweeps for the JAX package, for one run,
with the full flag timeline printed.

  PYTHONPATH=src python -m repro_torch.launch.drift_rs \\
      --scenario abrupt --algorithm dics --policy adaptive \\
      --events 32768 --micro-batch 256

With ``--ckpt-dir`` the final state is checkpointed *with* the detector
state (``sr-logical-v1`` + detector) and restored once as a round-trip
demonstration, so a resumed run keeps its drift baseline instead of
re-warming from scratch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.forgetting import ForgettingConfig
from repro_torch.core.pipeline import (restore_stream_checkpoint, run_stream,
                                       save_stream_checkpoint)
from repro_torch.drift import (DriftPolicy, list_scenarios, make_scenario,
                               recovery_report)
from repro_torch.launch import common
from repro_torch.obs import MetricsRegistry, TelemetryFolder


def main(argv=None):
    ap = common.base_parser(__doc__.splitlines()[0], algorithm="dics",
                            events=32768, u_cap=256)
    ap.add_argument("--scenario", default="abrupt", choices=list_scenarios())
    ap.add_argument("--policy", default="adaptive",
                    choices=("none", "fixed", "adaptive"))
    ap.add_argument("--trigger-every", type=int, default=2048,
                    help="fixed-cadence trigger (policy=fixed)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint (with detector state) + restore demo")
    args = ap.parse_args(argv)

    sc = make_scenario(args.scenario, events=args.events, seed=args.seed)
    cfg = common.stream_config(args)
    if args.policy == "fixed":
        cfg = dataclasses.replace(cfg, forgetting=ForgettingConfig(
            policy="lru", trigger_every=args.trigger_every, lru_max_age=512))
    elif args.policy == "adaptive":
        cfg = dataclasses.replace(cfg, drift=DriftPolicy())

    # No session here (run_stream is driven directly), so fold the
    # loop's telemetry vector into a driver-local registry for export.
    registry = MetricsRegistry()
    folder = TelemetryFolder(registry)
    with common.obs_capture(args):
        res = run_stream(sc.users, sc.items, cfg)
    if res.telemetry is not None:
        folder.fold(res.telemetry)
    print(f"[drift_rs] {sc.name} seed={sc.seed}: {sc.n} events "
          f"(drifts at {list(sc.drift_events)}), {args.algorithm} on "
          f"{cfg.grid.n_c} workers, policy={args.policy}, "
          f"backend={args.backend}")
    print(f"[drift_rs] recall@10={res.recall.mean():.4f} "
          f"{res.throughput:,.0f} events/s forgets={res.forgets} "
          f"dropped={res.dropped}")

    if res.drift_flags is not None:
        fired = np.flatnonzero(res.drift_flags)
        drift_batches = [d // args.micro_batch for d in sc.drift_events]
        print(f"[drift_rs] detector fired at micro-batches "
              f"{fired.tolist()} (true drift at batches {drift_batches})")

    for i, d in enumerate(sc.drift_events):
        rep = recovery_report(res.recall.bits(), d)
        rec = (f"{rep.recovery_events}" if rep.recovery_events is not None
               else f"censored(>{rep.horizon})")
        print(f"[drift_rs] drift {i} @ event {d}: pre={rep.pre:.3f} "
              f"dip={rep.dip:.3f} (+{rep.dip_events}ev) recovery={rec}ev")

    if args.ckpt_dir:
        save_stream_checkpoint(args.ckpt_dir, res.events_processed,
                               res.final_states, grid=cfg.grid,
                               algorithm=args.algorithm,
                               detector=res.final_detector)
        ck = restore_stream_checkpoint(args.ckpt_dir, cfg)
        state = ("restored with detector state"
                 if ck.detector is not None else "restored (no detector)")
        print(f"[drift_rs] checkpoint @ {res.events_processed} events -> "
              f"{args.ckpt_dir}: {state}")
    common.export_metrics(args, registry)
    return res


if __name__ == "__main__":
    main()
