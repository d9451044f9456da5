"""Synthetic rating-stream generation (paper Section 5.2, Table 1).

A numpy-only copy of ``repro/data/stream.py`` (``synth_stream`` :93,
``scaled`` :52, ``MOVIELENS_25M`` :48): importing the JAX package pulls
in jax, which this package never imports. Same seed, same stream.

MovieLens-25M / Netflix cannot be shipped offline, so benchmark streams are
generated to match Table 1's post-filtering statistics *shape-wise*:

  * long-tailed (zipf) item popularity — Netflix: 3001 items averaging
    1361.5 ratings/item; MovieLens: 27133 items averaging 133;
  * long-tailed user activity — 10.6 / 23.3 ratings per user;
  * timestamps ascending (the paper sorts by timestamp to emulate a stream);
  * positive-only boolean feedback (the paper filters to >= 5 stars);
  * optional **concept drift**: at given fractions of the stream the item
    popularity ranking is re-drawn, shifting user taste mid-stream — the
    phenomenon the paper's forgetting techniques target.

Streams are deduplicated per (user, item) pair, matching the filtered
explicit-feedback datasets. Dedupe scope matters under drift: a global
first-occurrence dedupe would silently delete post-drift re-ratings of
pre-drift pairs, thinning the later segments and muting the very drift
signal ``drift_points`` exists to create. The ``dedupe`` knob therefore
defaults to *per-drift-segment* dedupe whenever ``drift_points`` is set
(and global otherwise); pass ``"global"``/``"segment"`` to force a scope,
or ``False`` to keep duplicates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StreamProfile", "MOVIELENS_25M", "NETFLIX", "synth_stream",
           "scaled", "segment_dedupe_mask"]


@dataclasses.dataclass(frozen=True)
class StreamProfile:
    """Dataset statistics to match (paper Table 1)."""

    name: str
    n_users: int
    n_items: int
    n_ratings: int
    user_zipf: float = 1.1   # activity skew
    item_zipf: float = 1.05  # popularity skew
    drift_points: tuple = () # fractions of stream where taste shifts


MOVIELENS_25M = StreamProfile("movielens25m", 155_002, 27_133, 3_612_474)
NETFLIX = StreamProfile("netflix", 394_106, 3_001, 4_086_048)


def scaled(profile: StreamProfile, factor: float, **overrides) -> StreamProfile:
    """Shrink a profile by ``factor`` keeping its shape statistics.

    ``overrides`` replace individual scaled fields (e.g. an item floor so
    top-N recall does not become trivial on very item-dense profiles).
    """
    fields = dict(
        name=f"{profile.name}-x{factor:g}",
        n_users=max(8, int(profile.n_users * factor)),
        n_items=max(8, int(profile.n_items * factor)),
        n_ratings=max(64, int(profile.n_ratings * factor)),
    )
    fields.update(overrides)
    return dataclasses.replace(profile, **fields)


def segment_dedupe_mask(users: np.ndarray, items: np.ndarray, n_items: int,
                        segments) -> np.ndarray:
    """Keep-mask of first (u, i) occurrences within each index segment.

    Explicit feedback is unique *per concept*: a post-drift re-rating of
    a pre-drift pair is fresh evidence, not a duplicate, so dedupe scopes
    are the drift segments (one full-stream segment = global dedupe).
    Used by ``synth_stream``.
    """
    pair = users.astype(np.int64) * n_items + items
    keep = np.zeros(users.shape[0], dtype=bool)
    for seg in segments:
        _, first = np.unique(pair[seg], return_index=True)
        keep[seg[first]] = True
    return keep


def _zipf_weights(n: int, a: float, rng: np.random.Generator) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-a)
    rng.shuffle(w)  # detach popularity from id order (ids are hash keys!)
    return w / w.sum()


def synth_stream(profile: StreamProfile, seed: int = 0,
                 dedupe: bool | str = True):
    """Generate a (users, items, timestamps) stream matching ``profile``.

    Returns int64 arrays sorted by timestamp. User taste is modeled by a
    small latent mixture so collaborative structure exists for the
    recommenders to learn (pure independence would cap recall at the
    popularity baseline).

    ``dedupe``: ``True`` (default) dedupes (u, i) pairs per drift segment
    when ``profile.drift_points`` is set and globally otherwise;
    ``"global"``/``"segment"`` force a scope; ``False`` keeps duplicates.
    """
    rng = np.random.default_rng(seed)
    n = profile.n_ratings

    user_w = _zipf_weights(profile.n_users, profile.user_zipf, rng)
    users = rng.choice(profile.n_users, size=n, p=user_w)

    # Latent taste clusters: each user belongs to one of C clusters; each
    # cluster has its own zipf item distribution over a preferred slice.
    n_clusters = max(2, min(16, profile.n_items // 64 or 2))
    user_cluster = rng.integers(0, n_clusters, size=profile.n_users)

    drift_at = sorted(int(f * n) for f in profile.drift_points)
    segments = np.split(np.arange(n), drift_at) if drift_at else [np.arange(n)]

    items = np.empty(n, dtype=np.int64)
    for seg_idx, seg in enumerate(segments):
        # Fresh popularity ranking per drift segment.
        seg_rng = np.random.default_rng(seed + 1000 * (seg_idx + 1))
        cluster_weights = [
            _zipf_weights(profile.n_items, profile.item_zipf, seg_rng)
            for _ in range(n_clusters)
        ]
        for c in range(n_clusters):
            sel = seg[user_cluster[users[seg]] == c]
            if sel.size:
                items[sel] = seg_rng.choice(
                    profile.n_items, size=sel.size, p=cluster_weights[c]
                )

    if dedupe:
        if dedupe is True:
            mode = "segment" if drift_at else "global"
        elif dedupe in ("global", "segment"):
            mode = dedupe
        else:
            raise ValueError(f"dedupe must be bool/'global'/'segment', "
                             f"got {dedupe!r}")
        scopes = segments if mode == "segment" else [np.arange(n)]
        keep = segment_dedupe_mask(users, items, profile.n_items, scopes)
        users, items = users[keep], items[keep]

    ts = np.arange(users.shape[0], dtype=np.int64)
    return users, items, ts
