"""Named, seeded concept-drift stream scenarios.

A numpy-only copy of ``repro/drift/scenarios.py`` (``DEFAULT_PROFILE``
:47, ``DriftStream`` :52, the six scenarios :136-227, ``SCENARIOS``
:230, ``list_scenarios``, ``make_scenario`` :244), over this package's copy
of ``repro/data/stream.py`` (``_zipf_weights``,
``segment_dedupe_mask``): importing the JAX package pulls in jax, which
this package never imports. Same name, seed and overrides, same stream,
bit for bit.

  ============== ======================================================
  ``abrupt``     popularity ranking re-drawn at one stream point
  ``gradual``    popularity linearly interpolated old->new over a window
  ``incremental`` ranking moves in several small (geometric) steps
  ``recurring``  popularity alternates A->B->A->B (seasonal shape)
  ``cluster-migration`` a fraction of users re-assigned to new taste
                 clusters mid-stream (item popularity unchanged)
  ``cold-start`` a flood of previously-unseen items captures most of the
                 rating mass after the drift point
  ============== ======================================================

Every scenario is generated by one segment-sampling core: user activity
is zipf, users belong to latent taste clusters, and each sampling
segment draws items from per-cluster weight vectors. Streams are
deduplicated per drift segment, and ``drift_events`` reports each drift
boundary as a post-dedupe stream index.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.data.stream import (MOVIELENS_25M, StreamProfile,
                                     _zipf_weights, scaled,
                                     segment_dedupe_mask)

__all__ = ["DriftStream", "SCENARIOS", "make_scenario", "list_scenarios",
           "DEFAULT_PROFILE"]

# Small-but-structured default. Wider catalog + steeper popularity than the
# throughput benchmarks' profile: recall then carries enough collaborative
# signal that a mid-stream concept change produces a *measurable* dip
# (flat-zipf tiny catalogs re-learn within one micro-batch and show none).
DEFAULT_PROFILE = dataclasses.replace(
    scaled(MOVIELENS_25M, 0.003, n_items=128), item_zipf=1.3)


@dataclasses.dataclass(frozen=True)
class DriftStream:
    """A generated drift stream plus its ground-truth drift positions."""

    name: str
    seed: int
    users: np.ndarray          # i64[n] stream order
    items: np.ndarray          # i64[n]
    ts: np.ndarray             # i64[n] ascending
    drift_events: tuple        # post-dedupe stream indices of each drift
    n_users: int
    n_items: int

    @property
    def n(self) -> int:
        return self.users.shape[0]


def _n_clusters(n_items: int) -> int:
    return max(2, min(16, n_items // 32 or 2))


def _cluster_weights(n_items: int, n_clusters: int, zipf: float,
                     rng: np.random.Generator) -> np.ndarray:
    """[n_clusters, n_items] fresh per-cluster popularity rankings."""
    return np.stack(
        [_zipf_weights(n_items, zipf, rng) for _ in range(n_clusters)])


def _generate(name: str, profile: StreamProfile, events: int, seed: int,
              sub_bounds: list, sub_weights: list, sub_clusters: list,
              drift_fracs: tuple) -> DriftStream:
    """Segment-sampling core shared by every scenario.

    Args:
      sub_bounds: fractions splitting the raw stream into sampling
        segments (len == len(sub_weights) - 1).
      sub_weights: per sampling segment, [n_clusters, n_items] weights.
      sub_clusters: per sampling segment, i64[n_users] cluster assignment.
      drift_fracs: fractions where a drift boundary is reported (must be a
        subset of the sampling boundaries); these also bound the dedupe
        segments.
    """
    rng = np.random.default_rng(seed)
    n = events
    user_w = _zipf_weights(profile.n_users, profile.user_zipf, rng)
    users = rng.choice(profile.n_users, size=n, p=user_w)
    items = np.empty(n, dtype=np.int64)

    cuts = [int(round(f * n)) for f in sub_bounds]
    starts = [0] + cuts
    stops = cuts + [n]
    for w, clusters, lo, hi in zip(sub_weights, sub_clusters, starts, stops):
        seg = np.arange(lo, hi)
        seg_c = clusters[users[seg]]
        for c in range(w.shape[0]):
            sel = seg[seg_c == c]
            if sel.size:
                items[sel] = rng.choice(profile.n_items, size=sel.size,
                                        p=w[c])

    # Dedupe within drift segments (re-ratings across a drift survive).
    drift_raw = [int(round(f * n)) for f in drift_fracs]
    bounds = [0] + drift_raw + [n]
    keep = segment_dedupe_mask(
        users, items, profile.n_items,
        [np.arange(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])])
    kept_before = np.cumsum(keep)
    drift_events = tuple(int(kept_before[r - 1]) if r > 0 else 0
                         for r in drift_raw)
    users, items = users[keep], items[keep]
    ts = np.arange(users.shape[0], dtype=np.int64)
    return DriftStream(name=name, seed=seed, users=users.astype(np.int64),
                       items=items, ts=ts, drift_events=drift_events,
                       n_users=profile.n_users, n_items=profile.n_items)


def _two_concepts(profile: StreamProfile, rng: np.random.Generator):
    n_c = _n_clusters(profile.n_items)
    w0 = _cluster_weights(profile.n_items, n_c, profile.item_zipf, rng)
    w1 = _cluster_weights(profile.n_items, n_c, profile.item_zipf, rng)
    clusters = rng.integers(0, n_c, size=profile.n_users)
    return w0, w1, clusters


def abrupt(profile: StreamProfile, events: int, seed: int,
           at: float = 0.5, remap_users: bool = True) -> DriftStream:
    """One hard concept re-draw at fraction ``at``: every cluster's
    popularity ranking is re-drawn and (by default) users are re-assigned
    to clusters — the full "yesterday's model describes nobody" break."""
    rng = np.random.default_rng(seed + 10_001)
    w0, w1, clusters = _two_concepts(profile, rng)
    post = (rng.integers(0, w0.shape[0], size=profile.n_users)
            if remap_users else clusters)
    return _generate("abrupt", profile, events, seed,
                     [at], [w0, w1], [clusters, post], (at,))


def gradual(profile: StreamProfile, events: int, seed: int,
            start: float = 0.45, end: float = 0.75,
            steps: int = 12) -> DriftStream:
    """Popularity interpolates linearly old->new across ``[start, end]``."""
    rng = np.random.default_rng(seed + 10_002)
    w0, w1, clusters = _two_concepts(profile, rng)
    bounds = [start + (end - start) * j / steps for j in range(steps + 1)]
    weights = [w0]
    for j in range(steps):
        q = (j + 0.5) / steps
        weights.append((1 - q) * w0 + q * w1)
    weights.append(w1)
    return _generate("gradual", profile, events, seed,
                     bounds, weights, [clusters] * len(weights), (start,))


def incremental(profile: StreamProfile, events: int, seed: int,
                start: float = 0.35, end: float = 0.85,
                steps: int = 5) -> DriftStream:
    """The ranking itself moves in ``steps`` small geometric steps, each
    held for a plateau (many small drifts rather than one blend)."""
    rng = np.random.default_rng(seed + 10_003)
    w0, w1, clusters = _two_concepts(profile, rng)
    bounds = [start + (end - start) * j / steps for j in range(steps)]
    weights = [w0]
    for j in range(1, steps + 1):
        q = j / steps
        w = np.power(w0, 1 - q) * np.power(w1, q)
        weights.append(w / w.sum(axis=1, keepdims=True))
    return _generate("incremental", profile, events, seed,
                     bounds, weights, [clusters] * len(weights), (start,))


def recurring(profile: StreamProfile, events: int, seed: int,
              periods: int = 4) -> DriftStream:
    """Popularity alternates A->B->A->B (seasonal recurrence)."""
    rng = np.random.default_rng(seed + 10_004)
    w0, w1, clusters = _two_concepts(profile, rng)
    bounds = [j / periods for j in range(1, periods)]
    weights = [w0 if j % 2 == 0 else w1 for j in range(periods)]
    return _generate("recurring", profile, events, seed,
                     bounds, weights, [clusters] * periods, tuple(bounds))


def cluster_migration(profile: StreamProfile, events: int, seed: int,
                      at: float = 0.5, frac: float = 0.6) -> DriftStream:
    """A fraction of users migrates to different taste clusters mid-stream;
    aggregate item popularity barely moves but individual taste does."""
    rng = np.random.default_rng(seed + 10_005)
    n_c = _n_clusters(profile.n_items)
    w0 = _cluster_weights(profile.n_items, n_c, profile.item_zipf, rng)
    clusters = rng.integers(0, n_c, size=profile.n_users)
    migrated = clusters.copy()
    movers = rng.random(profile.n_users) < frac
    # Shift movers to a different cluster (offset by a nonzero amount).
    shift = rng.integers(1, n_c, size=profile.n_users)
    migrated[movers] = (clusters[movers] + shift[movers]) % n_c
    return _generate("cluster-migration", profile, events, seed,
                     [at], [w0, w0], [clusters, migrated], (at,))


def cold_start(profile: StreamProfile, events: int, seed: int,
               at: float = 0.5, flood_frac: float = 0.25,
               flood_mass: float = 0.6) -> DriftStream:
    """Post-drift, a flood of previously-unseen items takes
    ``flood_mass`` of the rating mass (new-catalog launch)."""
    rng = np.random.default_rng(seed + 10_006)
    n_c = _n_clusters(profile.n_items)
    n_flood = max(1, int(round(flood_frac * profile.n_items)))
    flood = rng.choice(profile.n_items, size=n_flood, replace=False)
    clusters = rng.integers(0, n_c, size=profile.n_users)
    w0 = _cluster_weights(profile.n_items, n_c, profile.item_zipf, rng)
    w0[:, flood] = 0.0                       # unseen before the drift
    w0 /= w0.sum(axis=1, keepdims=True)
    flood_w = _cluster_weights(n_flood, n_c, profile.item_zipf, rng)
    w1 = (1 - flood_mass) * w0
    w1[:, flood] += flood_mass * flood_w
    return _generate("cold-start", profile, events, seed,
                     [at], [w0, w1], [clusters, clusters], (at,))


SCENARIOS: dict[str, Callable] = {
    "abrupt": abrupt,
    "gradual": gradual,
    "incremental": incremental,
    "recurring": recurring,
    "cluster-migration": cluster_migration,
    "cold-start": cold_start,
}


def list_scenarios() -> tuple:
    return tuple(SCENARIOS)


def make_scenario(name: str, events: int = 8192, seed: int = 0,
                  profile: StreamProfile | None = None,
                  **overrides) -> DriftStream:
    """Build a named scenario stream (bit-reproducible from ``seed``)."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; choose from {sorted(SCENARIOS)}")
    return SCENARIOS[name](profile or DEFAULT_PROFILE, events, seed,
                           **overrides)
