"""Quickstart: the public StreamSession API in ~30 lines.

Port of ``examples/quickstart.py``. Streams synthetic MovieLens-like
ratings through a registered algorithm on an S&R worker grid (the
paper's Algorithm 1+2+4 end to end), then serves grid-wide top-N
recommendations from the trained snapshot — train, evaluate and serve
through ONE object, ``repro_torch.StreamSession``:

  PYTHONPATH=src python -m repro_torch.launch.quickstart \\
      [--events 2000] [--algorithm bpr] [--device cpu --backend scan]
"""

import numpy as np

import repro_torch
from repro_torch.launch import common


def main(argv=None):
    # The shared driver flags (--algorithm/--events/--backend/--seed, ...);
    # the grid is swept below and capacities derive from it.
    ap = common.base_parser("StreamSession quickstart", grid=False,
                            caps=False, events=0, micro_batch=1024)
    args = ap.parse_args(argv)

    users, items = common.demo_stream(args.events, args.seed)
    print(f"stream: {users.size} ratings, "
          f"{users.max()+1} users, {items.max()+1} items")

    algo = repro_torch.get_algorithm(args.algorithm)
    for n_i in (1, 2):  # n_i=1 == the paper's central (single-worker) baseline
        grid = repro_torch.GridSpec(n_i)
        cfg = repro_torch.StreamConfig(
            algorithm=args.algorithm,
            grid=grid,
            micro_batch=args.micro_batch,
            hyper=algo.default_hyper()._replace(u_cap=1024 // grid.g,
                                                i_cap=128 // grid.n_i),
            backend=args.backend,
            device=args.device,
        )
        session = repro_torch.StreamSession(cfg)
        res = session.ingest(users, items)
        occ = res.occupancy_summary()
        label = "central" if n_i == 1 else f"{args.algorithm} n_i={n_i}"
        print(f"{label:14s} recall@10={res.recall.mean():.4f} "
              f"throughput={res.throughput:,.0f} ev/s "
              f"mean state/worker: users={occ['user_mean']:.0f} "
              f"items={occ['item_mean']:.0f}")

    # Serve a few grid-wide top-N queries from the last session's snapshot.
    resp = session.recommend(np.unique(users)[:4])
    print(f"sample recommendations (known={resp.known.tolist()}):")
    for row in resp.ids:
        print("  ", [int(i) for i in row if i >= 0])


if __name__ == "__main__":
    main()
