"""Train-and-serve driver for the S&R recommender's query plane.

Port of ``repro/launch/serve_rs.py``; the same flags plus ``--device``,
and ``--backend`` defaults to ``cuda``.

Runs the streaming trainer through a ``StreamSession`` whose
``PublishPolicy`` publishes a snapshot every ``--publish-every``
micro-batches, and serves a burst of top-N queries against each
published snapshot via a store listener (``SnapshotStore.subscribe``) —
the single-process simulation of the paper's deployment shape: the
training stream ingests events while read-only recommendation traffic
is answered from consistent, bounded-staleness snapshots. For
*concurrent* (not burst-per-publish) mixed load, see
``repro_torch.launch.service_rs``.

  PYTHONPATH=src python -m repro_torch.launch.serve_rs \\
      --algorithm disgd --n-i 2 --events 8192 --micro-batch 256 \\
      --publish-every 8 --queries-per-publish 256 --batch 64

(For the unrelated LLM decode driver see ``repro_torch.launch.serve``.)
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.launch import common
from repro_torch.serve import ServeConfig
from repro_torch.serve.policy import PublishPolicy
from repro_torch.session import StreamSession


def main(argv=None):
    ap = common.base_parser(__doc__.splitlines()[0])
    ap.add_argument("--publish-every", type=int, default=8,
                    help="micro-batches per snapshot publish")
    ap.add_argument("--queries-per-publish", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64, help="query micro-batch")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="staleness bound in events (default: unbounded)")
    args = ap.parse_args(argv)

    cfg = common.stream_config(args)
    users, items = common.demo_stream(args.events, args.seed)

    # Sync publishing: each rotation's listener burst runs inline, so a
    # burst is answered from exactly the snapshot that triggered it.
    policy = PublishPolicy(every=args.publish_every, mode="sync",
                           max_staleness_events=args.max_staleness)
    session = StreamSession(
        cfg, publish=policy,
        serve=ServeConfig.from_stream(cfg, batch_size=args.batch,
                                      publish=policy))
    frontend = session.frontend
    rng = np.random.default_rng(args.seed + 1)
    pool = np.unique(users)

    bursts = []          # (queries, seconds, staleness, cache_hits, fallbacks)

    def burst(snap):
        q = rng.choice(pool, size=args.queries_per_publish)
        t0 = time.perf_counter()
        resp = frontend.serve(q)
        dt = time.perf_counter() - t0
        bursts.append((q.size, dt, resp.staleness_events,
                       resp.cache_hits, resp.fallbacks))

    session.store.subscribe(burst)
    with common.obs_capture(args):
        res = session.ingest(users, items)

    total_q = sum(b[0] for b in bursts)
    total_t = sum(b[1] for b in bursts)
    qps = [b[0] / max(b[1], 1e-9) for b in bursts]
    print(f"[serve_rs] trained {res.events_processed} events "
          f"({res.throughput:,.0f} ev/s, backend={args.backend}, "
          f"n_c={cfg.grid.n_c} workers), recall@{args.top_n}="
          f"{res.recall.mean():.4f}, dropped={res.dropped}")
    print(f"[serve_rs] {session.store.latest_version} snapshots published "
          f"(every {args.publish_every} micro-batches -> staleness bound "
          f"{policy.staleness_bound_events(args.micro_batch)} events)")
    if bursts:
        fes = frontend.stats_snapshot()
        print(f"[serve_rs] served {total_q} queries in {total_t:.3f}s: "
              f"QPS mean={total_q / max(total_t, 1e-9):,.0f} "
              f"p50={np.percentile(qps, 50):,.0f} "
              f"worst-burst={min(qps):,.0f}")
        print(f"[serve_rs] cache hits={fes['cache_hits']} "
              f"fallbacks={fes['fallbacks']} "
              f"requeued={fes['requeued']} "
              f"invalidations={fes['invalidations']} "
              f"max staleness observed={max(b[2] for b in bursts)} events")
    common.export_metrics(args, session.metrics)
    return res, frontend


if __name__ == "__main__":
    main()
