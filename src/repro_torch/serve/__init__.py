"""Grid-wide query-serving plane for the S&R recommender.

Port of ``repro/serve/__init__.py:32-53``, the same public names:

  * ``plane``    — query fan-out over the user's replica column + the
    cross-split top-N merge on the device (DISGD, BPR-MF and DICS);
  * ``snapshot`` — double-buffered read-only state snapshots published
    by the engine at micro-batch boundaries (synchronously or via the
    async publisher thread), with a bounded-staleness knob;
  * ``policy``   — :class:`PublishPolicy`, the one knob surface for
    publish cadence, sync/async mode, and the staleness bound;
  * ``frontend`` — micro-batched query front-end: LRU response cache
    (lazily invalidated by snapshot generation) and a popularity
    fallback for unknown users;
  * ``autoscaler`` — closes the regrid loop: walks the grid up/down a
    balanced power-of-two ladder from the overflow / occupancy /
    staleness telemetry the loop already exports;
  * ``loadgen``  — seeded mixed-load traffic generation (Zipf-skewed
    queries, Poisson/bursty arrivals, events:queries mix);
  * ``service``  — the mixed-load runner: interleaved or threaded ingest
    + query traffic against one session, with tail-latency and
    staleness reporting.

Each part serves states resident under any storage policy
(``ServeConfig.storage``, ``grid_topn(storage=)``): the leaves decode
the rows they read, and ``QueryFrontend.retarget`` follows a regrid or a
policy migration (``StreamSession.rescale``).
"""

from repro_torch.serve.autoscaler import (AutoscalePolicy, Autoscaler,
                                          balanced_grid)
from repro_torch.serve.frontend import QueryFrontend, ServeConfig, ServeResponse
from repro_torch.serve.plane import grid_topn, query_capacity
from repro_torch.serve.policy import PublishPolicy
from repro_torch.serve.snapshot import (Snapshot, SnapshotStore,
                                        StaleSnapshotError, popularity_topn)

__all__ = [
    "AutoscalePolicy",
    "Autoscaler",
    "balanced_grid",
    "grid_topn",
    "query_capacity",
    "Snapshot",
    "SnapshotStore",
    "StaleSnapshotError",
    "popularity_topn",
    "PublishPolicy",
    "QueryFrontend",
    "ServeConfig",
    "ServeResponse",
]
