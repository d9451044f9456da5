"""Telemetry-driven elastic autoscaler: closes the regrid loop.

Port of ``repro/serve/autoscaler.py``: the same ladder, thresholds and
decision trail, on the port's session and registry.

The engine already *exports* its pressure signals — overflow re-queue /
drop counters and the per-worker occupancy high-water mark ride the device
loop's carry (``repro_torch.obs.telemetry``) and land in the session's metrics
registry — and the session already *has* an elasticity verb
(``StreamSession.rescale``). This module wires the two together: an
:class:`Autoscaler` observes the registry between ingest calls and walks
the grid up or down a balanced power-of-two ladder when the stream is
hot (events re-queued or dropped because dispatch buckets overflowed,
tables near capacity, snapshots going stale) or cold.

Decisions run on the driver thread between ingests — never inside the
loop — so a ``step()`` costs a handful of counter reads, and an actual
rescale costs exactly one ``session.rescale`` (logical extract +
rebuild + snapshot publish). Every decision, including holds, is
recorded under ``autoscaler_decisions_total{action=}`` so the scaling
history is auditable from the same registry that triggered it.

Why growing helps: dispatch-bucket capacity is
``max(8, ceil(micro_batch / n_c * capacity_factor))`` per worker, so in
the floored regime total dispatch capacity grows linearly with ``n_c``
— doubling the grid roughly halves the overflow pressure. Per-worker
tables are per-worker, so occupancy pressure also divides (items by
row count; user replicas by column count for the hash-partitioned id
space).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.routing import GridSpec

__all__ = ["AutoscalePolicy", "Autoscaler", "balanced_grid"]


def balanced_grid(n_c: int) -> GridSpec:
    """The balanced power-of-two grid with at least ``n_c`` workers.

    Rows lead: 1 -> (1,1), 2 -> (2,1), 4 -> (2,2), 8 -> (4,2),
    16 -> (4,4), ... Growing rows first splits the item space before
    replicating users, which is the cheaper direction for memory (item
    splits partition; user replicas duplicate).
    """
    k = max(0, math.ceil(math.log2(max(1, n_c))))
    return GridSpec.rect(2 ** ((k + 1) // 2), 2 ** (k // 2))


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds and bounds for :class:`Autoscaler` decisions.

    A step *grows* (doubles ``n_c``, re-balanced) when any hot signal
    fires: the overflow fraction of the events processed since the last
    step exceeds ``grow_overflow_frac``, any live worker's occupancy
    high-water mark exceeds ``grow_occupancy_frac`` of table capacity,
    or the serving snapshot trails stream progress by more than
    ``grow_staleness_events`` (None disables that signal). It *shrinks*
    (halves) only when every hot signal is quiet: overflow at or below
    ``shrink_overflow_frac`` and occupancy below
    ``shrink_occupancy_frac``. After any rescale the next ``cooldown``
    steps hold, so one hot burst can't ladder straight to
    ``max_workers`` before the bigger grid has seen traffic.
    """

    grow_overflow_frac: float = 0.05
    grow_occupancy_frac: float = 0.85
    grow_staleness_events: int | None = None
    shrink_overflow_frac: float = 0.0
    shrink_occupancy_frac: float = 0.30
    min_workers: int = 1
    max_workers: int = 64
    cooldown: int = 1

    def __post_init__(self):
        if not (self.min_workers >= 1
                and self.max_workers >= self.min_workers):
            raise ValueError(
                "need 1 <= min_workers <= max_workers, got "
                f"{self.min_workers}..{self.max_workers}")
        if self.shrink_occupancy_frac >= self.grow_occupancy_frac:
            raise ValueError("shrink_occupancy_frac must be below "
                             "grow_occupancy_frac")


class Autoscaler:
    """Drives ``session.rescale`` from the session's own telemetry.

    Call :meth:`step` between ingest calls (typically once per driver
    loop iteration). Reads are deltas against the previous step, so the
    cadence is the operator's choice; the scaler never needs to see
    every micro-batch.

        scaler = Autoscaler(session, AutoscalePolicy(max_workers=8))
        for users, items in traffic:
            session.ingest(users, items)
            scaler.step()
    """

    _COUNTERS = ("stream_events_total", "stream_requeued_total",
                 "stream_dropped_total")

    def __init__(self, session, policy: AutoscalePolicy | None = None):
        self.session = session
        self.policy = policy if policy is not None else AutoscalePolicy()
        reg = session.metrics
        self._decisions = reg.counter(
            "autoscaler_decisions_total",
            "Autoscaler decisions by outcome", labels=("action",))
        self._workers = reg.gauge(
            "autoscaler_workers", "Current worker-grid size n_c")
        self._occ_family = reg.gauge(
            "bucket_occupancy_frac", "Per-worker occupancy high-water "
            "mark as a fraction of table capacity (user + item entries)",
            labels=("bucket",))
        self._last: dict[str, int] = {}
        self._cooldown = 0
        self._workers.set(session.grid.n_c)
        # Baseline the counters so the first step sees only the traffic
        # that arrived after the scaler was attached.
        for name in self._COUNTERS:
            self._delta(name)

    # -- signal reads -----------------------------------------------------

    def _delta(self, name: str) -> int:
        value = int(self.session.metrics.counter(name).value)
        delta = value - self._last.get(name, 0)
        self._last[name] = value
        return max(0, delta)

    def _occupancy(self) -> float:
        """Max live-worker occupancy fraction (stale buckets from a
        previously larger grid are excluded by label)."""
        n_c = self.session.grid.n_c
        worst = 0.0
        for labels, gauge in self._occ_family.series():
            if int(labels["bucket"]) < n_c:
                worst = max(worst, float(gauge.value))
        return worst

    # -- the decision -----------------------------------------------------

    def step(self) -> str:
        """Observe, maybe rescale. Returns ``"grow"|"shrink"|"hold"``."""
        p = self.policy
        events = self._delta("stream_events_total")
        overflow = (self._delta("stream_requeued_total")
                    + self._delta("stream_dropped_total"))
        overflow_frac = overflow / events if events else 0.0
        occ = self._occupancy()
        staleness = self.session.store.staleness()
        n_c = self.session.grid.n_c

        action = "hold"
        if self._cooldown > 0:
            self._cooldown -= 1
        else:
            hot = (overflow_frac > p.grow_overflow_frac
                   or occ > p.grow_occupancy_frac
                   or (p.grow_staleness_events is not None
                       and staleness > p.grow_staleness_events))
            cold = (overflow_frac <= p.shrink_overflow_frac
                    and occ < p.shrink_occupancy_frac)
            if hot and n_c < p.max_workers:
                action = "grow"
            elif cold and n_c > p.min_workers:
                action = "shrink"

        if action != "hold":
            target = balanced_grid(
                min(p.max_workers, n_c * 2) if action == "grow"
                else max(p.min_workers, n_c // 2))
            self.session.rescale(target)
            self._cooldown = p.cooldown
            self._workers.set(target.n_c)
        self._decisions.labels(action=action).inc()
        return action
