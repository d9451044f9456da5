"""Mixed-load service driver: live ingest + query traffic, one session.

Port of ``repro/launch/service_rs.py``; the same flags plus ``--device``,
and ``--backend`` defaults to ``cuda``.

The production shape of the paper's system: the training stream ingests
events (publishing snapshots per the session's ``PublishPolicy``,
asynchronously by default so rotation stays off the loop's critical
path) while Zipf-skewed top-N query traffic is answered from the
double-buffered snapshot store — concurrently in ``--mode threaded``
(the honest p99-under-load measurement) or deterministically in
``--mode interleaved`` (bit-reproducible; what the tests drive).

  PYTHONPATH=src python -m repro_torch.launch.service_rs \\
      --algorithm disgd --n-i 2 --events 16384 --micro-batch 256 \\
      --publish-every 8 --mode threaded --arrival bursty --rate 200

Sibling drivers: ``serve_rs`` (burst-per-publish loop), ``drift_rs``
(closed-loop drift), ``rescale_rs`` (elastic regrid).
"""

from __future__ import annotations

from repro_torch.launch import common
from repro_torch.serve.loadgen import LoadConfig
from repro_torch.serve.policy import PublishPolicy
from repro_torch.serve.service import ServiceConfig, run_service
from repro_torch.session import StreamSession


def main(argv=None):
    ap = common.base_parser(__doc__.splitlines()[0], events=16384)
    ap.add_argument("--publish-every", type=int, default=8,
                    help="micro-batches per snapshot publish")
    ap.add_argument("--publish-mode", default="async",
                    choices=("async", "sync"))
    ap.add_argument("--mode", default="threaded",
                    choices=("threaded", "interleaved"))
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "bursty", "closed"))
    ap.add_argument("--rate", type=float, default=200.0,
                    help="target query batches/sec (open-loop arrivals)")
    ap.add_argument("--query-batches", type=int, default=200)
    ap.add_argument("--query-batch", type=int, default=16,
                    help="users per query batch")
    ap.add_argument("--zipf-a", type=float, default=1.1)
    ap.add_argument("--unknown-frac", type=float, default=0.05)
    ap.add_argument("--events-per-chunk", type=int, default=512,
                    help="ingest granularity (interleaved mode)")
    args = ap.parse_args(argv)

    cfg = common.stream_config(args)
    users, items = common.demo_stream(args.events, args.seed)

    policy = PublishPolicy(every=args.publish_every, mode=args.publish_mode)
    session = StreamSession(cfg, publish=policy)
    load = LoadConfig(
        n_users=int(users.max()) + 1, seed=args.seed + 1,
        query_batch=args.query_batch, zipf_a=args.zipf_a,
        unknown_frac=args.unknown_frac, arrival=args.arrival,
        rate_qps=args.rate)
    svc = ServiceConfig(mode=args.mode,
                        events_per_chunk=args.events_per_chunk,
                        query_batches=args.query_batches,
                        schedule_seed=args.seed)

    with common.obs_capture(args):
        report = run_service(session, users, items, load, svc)
    s = report.summary()

    print(f"[service_rs] {args.algorithm} on {cfg.grid.n_c} workers "
          f"(n_i={cfg.grid.n_i}, backend={args.backend}), mode={args.mode}, "
          f"arrival={args.arrival}, publish every {policy.every} "
          f"micro-batches ({policy.mode})")
    print(f"[service_rs] {s['events_processed']} events + {s['queries']} "
          f"queries in {s['wall_s']:.2f}s = "
          f"{s['combined_ops_per_s']:,.0f} combined ops/s "
          f"(ingest {s['ingest_events_per_s']:,.0f} ev/s)")
    if "p99_ms" in s:
        print(f"[service_rs] query batch latency p50={s['p50_ms']:.2f}ms "
              f"p99={s['p99_ms']:.2f}ms max={s['max_ms']:.2f}ms")
        print(f"[service_rs] staleness-at-answer mean={s['staleness_mean']} "
              f"p95={s['staleness_p95']} max={s['staleness_max']} events")
    if "rotation_batch_p99_ms" in s:
        print(f"[service_rs] rotation-boundary p99="
              f"{s['rotation_batch_p99_ms']:.2f}ms vs steady p99="
              f"{s['steady_batch_p99_ms']:.2f}ms")
    if "eviction_batches" in s:
        print(f"[service_rs] {s['eviction_batches']} batches crossed a "
              f"forgetting eviction (worst {s['eviction_batch_max_ms']:.2f}ms)")
    if "async_rotations" in s:
        print(f"[service_rs] async publishes: {s['async_rotations']} "
              f"rotations, {s.get('coalesced', 0)} coalesced")
    # The session registry carries the full catalogue (stream_*, serve_*,
    # snapshot_*, span_seconds); the report's per-run registry only the
    # under-load latency histograms — export the rich one.
    common.export_metrics(args, session.metrics)
    return report


if __name__ == "__main__":
    main()
