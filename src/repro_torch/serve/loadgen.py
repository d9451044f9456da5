"""Seeded mixed-load traffic generation for the service harness.

Port of ``repro/serve/loadgen.py``, NumPy only: for a seed, the same
query batches, arrival gaps and mixed schedules as the JAX package's.

A streaming recommender in production carries two traffic classes at
once: the write path (``<user, item>`` events feeding the trainer) and
the read path (top-N point queries hitting the serving plane). This
module generates both from one seed so a mixed-load run is exactly
reproducible:

  * **query users** follow a Zipf popularity law over the user universe
    (the same ``ranks**-a``, shuffled-rank idiom as the event stream in
    ``repro_torch.data.stream``) plus a configurable fraction of *unknown*
    users — ids past the trained universe that exercise the popularity
    fallback;
  * **arrival schedules** produce inter-arrival gaps for open-loop load:
    ``"poisson"`` (exponential gaps at a target rate), ``"bursty"`` (a
    two-state MMPP-style modulation: quiet base rate with burst episodes
    at a multiplied rate — the drift-adjacent worst case for tail
    latency), or ``"closed"`` (zero gaps: issue the next batch as soon
    as the previous answer lands, which measures max sustainable
    throughput instead of latency at a fixed rate);
  * **mixed schedules** deterministically interleave ingest chunks and
    query batches at a configured events:queries ratio — the
    single-threaded, bit-reproducible counterpart of the threaded
    runner in ``repro_torch.serve.service``.

Everything is NumPy ``default_rng``-seeded; no wall clock, no global
state. The generators yield plain arrays/floats so both the threaded
runner (which sleeps the gaps) and the deterministic runner (which
ignores them) consume the same schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["LoadConfig", "QueryLoad", "mixed_schedule"]

_ARRIVALS = ("poisson", "bursty", "closed")


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Shape of the synthetic query-side load (seeded, reproducible)."""

    n_users: int = 1024           # trained-user universe to sample from
    seed: int = 0
    query_batch: int = 16         # users per query batch (one serve() call)
    zipf_a: float = 1.1           # query-popularity skew (1.0 ≈ classic Zipf)
    unknown_frac: float = 0.05    # fraction of ids past the universe
    arrival: str = "poisson"      # "poisson" | "bursty" | "closed"
    rate_qps: float = 200.0       # target query batches/sec (open-loop)
    burst_factor: float = 8.0     # bursty: rate multiplier inside a burst
    burst_len: int = 20           # bursty: mean batches per burst episode
    quiet_len: int = 80           # bursty: mean batches between bursts

    def __post_init__(self):
        if self.arrival not in _ARRIVALS:
            raise ValueError(
                f"arrival must be one of {_ARRIVALS}, got {self.arrival!r}")
        if self.n_users < 1 or self.query_batch < 1:
            raise ValueError("n_users and query_batch must be positive")
        if not 0.0 <= self.unknown_frac <= 1.0:
            raise ValueError("unknown_frac must be in [0, 1]")
        if self.arrival != "closed" and self.rate_qps <= 0:
            raise ValueError("open-loop arrival needs rate_qps > 0")


class QueryLoad:
    """Seeded generator of (query batch, inter-arrival gap) pairs.

    One instance = one deterministic traffic trace: constructing two
    with the same ``LoadConfig`` yields identical batches and gaps.
    """

    def __init__(self, cfg: LoadConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.n_users + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self._rng.shuffle(w)     # detach popularity from id order
        self._user_w = w / w.sum()
        self._burst_left = 0     # bursty-arrival modulation state
        self._quiet_left = self._draw_len(cfg.quiet_len)

    def _draw_len(self, mean: int) -> int:
        return 1 + int(self._rng.exponential(max(1, mean)))

    # -- query content ----------------------------------------------------

    def batch(self) -> np.ndarray:
        """The next query batch: int64[query_batch] user ids."""
        cfg = self.cfg
        uids = self._rng.choice(cfg.n_users, size=cfg.query_batch,
                                p=self._user_w)
        if cfg.unknown_frac > 0:
            cold = self._rng.random(cfg.query_batch) < cfg.unknown_frac
            # Unknown users live past the trained universe; spread them so
            # they don't all collapse onto one replica column.
            uids = np.where(
                cold,
                cfg.n_users + self._rng.integers(
                    0, max(1, cfg.n_users), size=cfg.query_batch),
                uids)
        return uids.astype(np.int64)

    # -- arrival schedule --------------------------------------------------

    def gap(self) -> float:
        """Seconds until the next batch should be *issued* (open loop)."""
        cfg = self.cfg
        if cfg.arrival == "closed":
            return 0.0
        rate = cfg.rate_qps
        if cfg.arrival == "bursty":
            if self._burst_left > 0:
                self._burst_left -= 1
                rate *= cfg.burst_factor
            else:
                self._quiet_left -= 1
                if self._quiet_left <= 0:
                    self._burst_left = self._draw_len(cfg.burst_len)
                    self._quiet_left = self._draw_len(cfg.quiet_len)
        return float(self._rng.exponential(1.0 / rate))

    def batches(self, n: int) -> Iterator[tuple[np.ndarray, float]]:
        """Yield ``n`` (batch, gap) pairs — one deterministic trace."""
        for _ in range(n):
            yield self.batch(), self.gap()


def mixed_schedule(n_events: int, n_query_batches: int, *,
                   events_per_chunk: int,
                   seed: int = 0) -> list[tuple[str, int]]:
    """Deterministically interleave ingest chunks and query batches.

    Returns an op list ``[("ingest", n_chunk_events) | ("query", 1), ...]``
    whose ingest ops partition ``n_events`` into chunks of at most
    ``events_per_chunk`` and whose query ops total ``n_query_batches``,
    spread proportionally so the configured events:queries mix holds
    locally, not just in aggregate. The shuffle within each proportional
    slot is seeded, so the same arguments always produce the same
    schedule (what the deterministic service runner and its
    bit-reproducibility test rely on).
    """
    if events_per_chunk < 1:
        raise ValueError("events_per_chunk must be positive")
    n_chunks = max(1, -(-n_events // events_per_chunk)) if n_events else 0
    ops: list[tuple[str, int]] = []
    remaining = n_events
    chunks = []
    for _ in range(n_chunks):
        take = min(events_per_chunk, remaining)
        chunks.append(("ingest", take))
        remaining -= take
    queries = [("query", 1)] * n_query_batches
    # Proportional merge: walk both lists with an error accumulator
    # (Bresenham-style) so queries land evenly between ingest chunks.
    rng = np.random.default_rng(seed)
    total = len(chunks) + len(queries)
    ci = qi = 0
    for _ in range(total):
        # Pick whichever stream is further behind its proportional
        # position; break ties with the seeded rng.
        c_frac = ci / len(chunks) if chunks else 1.0
        q_frac = qi / len(queries) if queries else 1.0
        if ci < len(chunks) and (qi >= len(queries) or c_frac < q_frac or
                                 (c_frac == q_frac and rng.random() < 0.5)):
            ops.append(chunks[ci]); ci += 1
        else:
            ops.append(queries[qi]); qi += 1
    return ops
