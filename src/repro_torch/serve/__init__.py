"""Grid-wide query-serving plane for the S&R recommender.

Port of ``repro/serve/__init__.py:39-53`` without the autoscaler, which
comes with ROADMAP Queue 1 item 13:

  * ``plane``    — query fan-out over the user's replica column + the
    cross-split top-N merge on the device (DISGD, BPR-MF and DICS);
  * ``snapshot`` — double-buffered read-only state snapshots published
    by the engine at micro-batch boundaries (synchronously or via the
    async publisher thread), with a bounded-staleness knob;
  * ``policy``   — :class:`PublishPolicy`, the one knob surface for
    publish cadence, sync/async mode, and the staleness bound;
  * ``frontend`` — micro-batched query front-end: LRU response cache
    (lazily invalidated by snapshot generation) and a popularity
    fallback for unknown users.

Each part serves states resident under any storage policy
(``ServeConfig.storage``, ``grid_topn(storage=)``): the leaves decode
the rows they read, and ``QueryFrontend.retarget`` follows a regrid or a
policy migration (``StreamSession.rescale``).
"""

from repro_torch.serve.frontend import QueryFrontend, ServeConfig, ServeResponse
from repro_torch.serve.plane import grid_topn, query_capacity
from repro_torch.serve.policy import PublishPolicy
from repro_torch.serve.snapshot import (Snapshot, SnapshotStore,
                                        StaleSnapshotError, popularity_topn)

__all__ = [
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
