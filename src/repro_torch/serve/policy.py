"""PublishPolicy — the one knob surface for snapshot publishing.

Port of ``repro/serve/policy.py:43-72``, with the same fields, defaults
and validation messages:

  * ``every``   — snapshot cadence in micro-batches (0 = publish only at
    the end of each ingest call). Publishing every ``k`` micro-batches
    of size ``mb`` bounds serving staleness by ``k * mb`` events.
  * ``mode``    — ``"async"`` (default): a mid-stream publish enqueues a
    copy of the states made on the card and returns at once; the
    store's publisher thread computes the popularity head and rotates
    off the training loop, coalescing to the freshest copy under load.
    ``"sync"``: the rotation completes before the trainer resumes.
  * ``max_staleness_events`` — read-side bound: ``QueryFrontend`` /
    ``StreamSession.recommend`` raise
    :class:`~repro_torch.serve.snapshot.StaleSnapshotError` when the front
    snapshot trails reported stream progress by more than this many
    events (``None`` = unbounded).

Owned by :class:`~repro_torch.session.StreamSession` (training side) and
:class:`~repro_torch.serve.frontend.ServeConfig` (serving side); the
session hands its policy to the front-end it builds, so one object
governs both halves.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PublishPolicy"]

_MODES = ("async", "sync")


@dataclasses.dataclass(frozen=True)
class PublishPolicy:
    """How and how often training state becomes a serving snapshot."""

    every: int = 0                          # micro-batches per publish
    mode: str = "async"                     # "async" | "sync"
    max_staleness_events: int | None = None  # serve-side staleness bound

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"PublishPolicy.mode must be one of {_MODES}, "
                f"got {self.mode!r}")
        if self.every < 0:
            raise ValueError(f"PublishPolicy.every must be >= 0, "
                             f"got {self.every}")
        if (self.max_staleness_events is not None
                and self.max_staleness_events < 0):
            raise ValueError("PublishPolicy.max_staleness_events must be "
                             ">= 0 or None")

    @property
    def is_async(self) -> bool:
        return self.mode == "async"

    def staleness_bound_events(self, micro_batch: int) -> int | None:
        """The staleness the cadence itself guarantees, in events."""
        if self.every <= 0:
            return None
        return self.every * micro_batch
