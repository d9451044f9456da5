"""EnsembleSession — concurrent multi-algorithm training + blended serving.

Port of ``repro/ensemble/members.py``. One ingest call fans out to N
member :class:`~repro_torch.session.StreamSession` objects — one per
registered algorithm — training {DISGD, DICS, BPR-MF} (any registered
subset of size >= 2) on the SAME event stream, one after the other on
the members' device. Every member keeps its own serve plane
(``SnapshotStore`` + ``QueryFrontend`` + per-member publish policy) and
its own states (no tensor is shared between members, which matters on
the ``host`` backend: it updates states in place); all of them share ONE
:class:`~repro_torch.obs.metrics.MetricsRegistry` through member-tagged
:class:`~repro_torch.obs.metrics.ScopedRegistry` views, so one scrape
covers the whole ensemble with a ``member`` label on every family.

Between segments the prequential weigher (``ensemble.weights``) folds
each member's reward head — the recall or precision@N aggregates of the
member's telemetry vector, read once per member per segment after the
member's ingest has synchronised on its final publish — into exp3-style
softmax weights; a drift flag from ANY member's detector flattens the
weights back to uniform (exploration re-opens, ``resets`` counted in the
registry). ``recommend`` then serves either a weighted rank fusion of
the member top-N lists (``ensemble.blend``, on the host) or
hard-switches each query to the argmax-weight member.

Checkpoints are JAX's ``sr-ensemble-v1``: member directories in
``sr-logical-v1`` and an ``ensemble.json`` written with the same bytes
from the same weigher and counts, so either package restores the
other's ensemble.

Algorithm dispatch stays inside ``core/algorithm.py``: this module only
ever passes registry keys through ``StreamConfig`` — it never compares
algorithm names.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Sequence

import numpy as np

from repro_torch.core.pipeline import StreamConfig, StreamResult
from repro_torch.core.routing import GridSpec
from repro_torch.ensemble.blend import BlendPolicy, fuse_topn, switch_choice
from repro_torch.ensemble.weights import (WeigherConfig, WeigherState,
                                          popularity_stratum,
                                          weigher_from_dict, weigher_init,
                                          weigher_to_dict, weigher_update)
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.serve import PublishPolicy, ServeResponse
from repro_torch.session import StreamSession

__all__ = ["EnsembleSession", "EnsembleResult", "ENSEMBLE_FORMAT"]

# Version tag of the ensemble checkpoint manifest (ensemble.json).
ENSEMBLE_FORMAT = "sr-ensemble-v1"

# The scope label the ensemble reserves for its own (non-member) spans.
_ENSEMBLE_SCOPE = "ensemble"

# Weight-trail histogram buckets: weights live in [0, 1], so linear
# 0.05-wide buckets read directly as a weight distribution.
_WEIGHT_BUCKETS = tuple(i / 20 for i in range(1, 21))


@dataclasses.dataclass
class EnsembleResult:
    """What one ``EnsembleSession.ingest`` call produced."""

    members: dict            # name -> StreamResult for this segment
    weights: dict            # name -> f64[strata] post-update weights
    drift: bool              # any member's detector fired this segment
    events_processed: int    # segment events (identical across members)
    resets: int              # cumulative exploration re-openings

    def weight(self, name: str) -> float:
        """Mean (over strata) post-update weight of one member."""
        return float(np.mean(self.weights[name]))


class EnsembleSession:
    """Adaptive ensemble runtime over the ``Algorithm`` registry.

    ``configs``: one :class:`StreamConfig` per member; the member name IS
    its registry key (``cfg.algorithm``), so names are unique and the
    fan-out order is name-sorted — deterministic regardless of the order
    configs were passed in. All members see every ingested event; their
    serve planes publish independently under the shared ``publish``
    policy.
    """

    def __init__(self, configs: Sequence[StreamConfig], *,
                 weigher: WeigherConfig | None = None,
                 blend: BlendPolicy | None = None,
                 publish: PublishPolicy | None = None,
                 snapshot_slots: int = 2,
                 metrics: metrics_lib.MetricsRegistry | None = None):
        names = [cfg.algorithm for cfg in configs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate ensemble members: {names}")
        if len(names) < 2:
            raise ValueError(
                "an ensemble needs >= 2 members (one member is just a "
                "StreamSession)")
        if _ENSEMBLE_SCOPE in names:
            raise ValueError(
                f"member name {_ENSEMBLE_SCOPE!r} is reserved for "
                "ensemble-level spans")
        self.metrics = (metrics if metrics is not None
                        else metrics_lib.MetricsRegistry())
        self._scope = metrics_lib.ScopedRegistry(self.metrics,
                                                 member=_ENSEMBLE_SCOPE)
        # Name-sorted fan-out: same stream, same order, every run.
        self.members: dict[str, StreamSession] = {}
        for cfg in sorted(configs, key=lambda c: c.algorithm):
            scoped = metrics_lib.ScopedRegistry(self.metrics,
                                                member=cfg.algorithm)
            self.members[cfg.algorithm] = StreamSession(
                cfg, publish=publish, snapshot_slots=snapshot_slots,
                metrics=scoped)
        self.weigher_config = weigher if weigher is not None else WeigherConfig()
        self.blend = blend if blend is not None else BlendPolicy()
        # The weigher's tensors live on the first member's device.
        self.device = next(iter(self.members.values())).cfg.device
        self._weigher: WeigherState = weigher_init(
            len(self.members), self.weigher_config, device=self.device)
        # User-popularity counts drive the per-stratum reward and the
        # serve-time stratum lookup; unused (and unmaintained) at S = 1.
        self._user_seen: defaultdict[int, int] = defaultdict(int)
        self.events_processed = 0

        self._w_gauge = self.metrics.gauge(
            "ensemble_member_weight", "Current mean ensemble weight of a "
            "member (post-update)", labels=("member",))
        self._w_trail = self.metrics.histogram(
            "ensemble_member_weight_trail", "Per-segment trail of a "
            "member's mean ensemble weight (retained samples = the "
            "weight trajectory)", labels=("member",),
            buckets=_WEIGHT_BUCKETS)
        self._resets_c = self.metrics.counter(
            "ensemble_exploration_resets_total", "Drift flags that "
            "flattened the ensemble weights back to uniform")
        self._drift_c = self.metrics.counter(
            "ensemble_drift_flags_total", "Member drift-detector firings "
            "observed at segment boundaries", labels=("member",))
        self._switch_c = self.metrics.counter(
            "ensemble_switch_total", "Queries hard-switch-routed to a "
            "member", labels=("member",))

    @classmethod
    def for_algorithms(cls, algorithms: Sequence[str],
                       base: StreamConfig | None = None,
                       **kwargs) -> "EnsembleSession":
        """Build an ensemble of registry keys sharing one base config.

        ``base.hyper`` is dropped — hyper tuples are algorithm-specific,
        so every member resolves its own registry default (capacities
        and all); pass per-member ``configs`` to the constructor when
        members need tuned hypers.
        """
        if base is None:
            base = StreamConfig()
        configs = [dataclasses.replace(base, algorithm=a, hyper=None)
                   for a in algorithms]
        return cls(configs, **kwargs)

    # -- introspection ----------------------------------------------------

    @property
    def member_names(self) -> tuple[str, ...]:
        return tuple(self.members)

    @property
    def weights(self) -> dict[str, float]:
        """Current mean (over strata) weight per member."""
        w = self._host_weights()
        return {name: float(np.mean(w[i]))
                for i, name in enumerate(self.members)}

    def _host_weights(self) -> np.ndarray:
        """The weights as float64 ``[M, S]`` on the host."""
        return self._weigher.weights.cpu().numpy().astype(np.float64)

    @property
    def weigher_state(self) -> WeigherState:
        return self._weigher

    @property
    def exploration_resets(self) -> int:
        return int(self._weigher.resets)

    # -- train ------------------------------------------------------------

    def ingest(self, users, items, *,
               verbose: bool = False) -> EnsembleResult:
        """Stream one segment through EVERY member, then re-weigh.

        Each member trains on the full segment (its own states, carry,
        detector); afterwards the weigher folds per-member rewards read
        from the members' telemetry vectors. Weight updates are
        per-segment by construction — chunk long streams into several
        ingest calls to let the weights adapt mid-stream.
        """
        users = np.asarray(users)
        items = np.asarray(items)
        s = max(int(self.weigher_config.strata), 1)
        strat_idx = self._event_strata(users, s) if s > 1 else None

        results: dict[str, StreamResult] = {}
        hits = np.zeros((len(self.members), s), np.float64)
        evals = np.zeros((len(self.members), s), np.float64)
        drift_any = False
        with trace_lib.span("ingest", self._scope):
            for mi, (name, member) in enumerate(self.members.items()):
                res = member.ingest(users, items, verbose=verbose)
                results[name] = res
                fired = (res.drift_flags is not None
                         and int(np.sum(res.drift_flags)) > 0)
                if fired:
                    self._drift_c.labels(member=name).inc(
                        int(np.sum(res.drift_flags)))
                drift_any = drift_any or fired
                hits[mi], evals[mi] = self._member_reward(
                    res, member.cfg, strat_idx, s)

        self._weigher = weigher_update(self._weigher, hits, evals,
                                       drift_any, self.weigher_config)
        if s > 1:
            uniq, counts = np.unique(users, return_counts=True)
            for u, c in zip(uniq, counts):
                self._user_seen[int(u)] += int(c)
        self.events_processed += next(iter(results.values())).events_processed

        w = self._host_weights()
        for mi, name in enumerate(self.members):
            mean_w = float(np.mean(w[mi]))
            self._w_gauge.labels(member=name).set(mean_w)
            self._w_trail.labels(member=name).observe(mean_w)
        if drift_any and self.weigher_config.drift_reset:
            self._resets_c.inc()
        return EnsembleResult(
            members=results,
            weights={name: w[mi].copy()
                     for mi, name in enumerate(self.members)},
            drift=drift_any,
            events_processed=next(iter(results.values())).events_processed,
            resets=int(self._weigher.resets))

    def _member_reward(self, res: StreamResult, cfg: StreamConfig,
                       strat_idx, s: int):
        """One member's per-stratum (hits, evals) reward counts.

        Global mode (``strata = 1``) reads the telemetry vector's
        aggregates directly — the recall head (hits/evals) or the
        precision@N head (hits/list_len) — exact and device-computed
        (``StreamResult.telemetry`` holds them as host arrays, read when
        the member's ingest ended).
        Stratified mode scatters the stream-order recall bits onto the
        per-event popularity strata; events whose stream position was
        shifted by overflow re-queues fall back to the global aggregate
        (re-queue-free streams stratify exactly).
        """
        tel = res.telemetry
        if tel is not None:
            h = float(np.asarray(tel.hits))
            if self.weigher_config.reward == "precision":
                d = float(np.asarray(tel.list_len))
            else:
                d = float(np.asarray(tel.evals))
        else:
            bits = res.recall.bits()
            bits = bits[~np.isnan(bits)]
            h, d = float(bits.sum()), float(bits.size)
        if s == 1 or strat_idx is None:
            return np.full(s, h), np.full(s, d)

        bits = _aligned_bits(res, cfg, len(strat_idx))
        if bits is None:
            # Alignment unavailable: every stratum sees the global rate.
            return np.full(s, h), np.full(s, d)
        mask = ~np.isnan(bits)
        sh = np.bincount(strat_idx[mask], weights=bits[mask], minlength=s)
        se = np.bincount(strat_idx[mask], minlength=s).astype(np.float64)
        return sh, se

    def _event_strata(self, users: np.ndarray, s: int) -> np.ndarray:
        """Prequential per-event stratum: popularity BEFORE each event."""
        uniq, inv = np.unique(users, return_inverse=True)
        prior = np.asarray([self._user_seen.get(int(u), 0) for u in uniq],
                           np.int64)[inv]
        # Within-segment cumulative count per user (stable order).
        order = np.argsort(inv, kind="stable")
        sorted_inv = inv[order]
        starts = np.r_[0, np.flatnonzero(np.diff(sorted_inv)) + 1]
        lengths = np.diff(np.r_[starts, sorted_inv.size])
        within = np.arange(sorted_inv.size) - np.repeat(starts, lengths)
        cum = np.empty_like(within)
        cum[order] = within
        return np.asarray(popularity_stratum(prior + cum, s))

    def _user_stratum(self, uid: int, s: int) -> int:
        return int(popularity_stratum(self._user_seen.get(int(uid), 0), s))

    # -- serve ------------------------------------------------------------

    def recommend(self, user_ids, n: int | None = None,
                  mode: str | None = None) -> ServeResponse:
        """Blended (or switched) grid-wide top-N for a batch of users.

        ``"blend"``: every member serves the batch from its own snapshot
        plane; lists are merged by weighted rank fusion
        (:func:`repro_torch.ensemble.blend.fuse_topn`) under the serve plane's
        deterministic (score desc, id asc) tie-break. Rows no member
        knows fall back to the argmax-weight member's popularity head.
        ``"switch"``: each query routes whole to its argmax-weight
        member (per-stratum weights route per user). ``mode`` overrides
        the session's :class:`BlendPolicy` for this call.
        """
        mode = mode if mode is not None else self.blend.mode
        if mode not in ("blend", "switch"):
            raise ValueError(f"unknown ensemble serve mode {mode!r}")
        uids = np.asarray(user_ids, np.int64).reshape(-1)
        names = list(self.members)
        s = self._weigher.weights.shape[1]
        w = self._host_weights()                          # [M, S]
        if s == 1:
            w_rows = np.broadcast_to(w[:, 0], (uids.size, len(names)))
        else:
            strat = np.asarray([self._user_stratum(u, s) for u in uids])
            w_rows = w[:, strat].T                          # [Q, M]

        with trace_lib.span("serve", self._scope):
            if mode == "switch":
                return self._serve_switch(uids, w_rows, names, n)
            return self._serve_blend(uids, w_rows, names, n)

    def _serve_switch(self, uids, w_rows, names, n) -> ServeResponse:
        choice = np.asarray([switch_choice(w_rows[q], names)
                             for q in range(uids.size)])
        responses: dict[int, ServeResponse] = {}
        for mi in np.unique(choice):
            sub = uids[choice == mi]
            responses[int(mi)] = self.members[names[int(mi)]].recommend(
                sub, n=n)
            self._switch_c.labels(member=names[int(mi)]).inc(int(sub.size))
        top_n = next(iter(responses.values())).ids.shape[1]
        ids = np.full((uids.size, top_n), -1, np.int32)
        scores = np.zeros((uids.size, top_n), np.float32)
        known = np.zeros((uids.size,), bool)
        for mi, resp in responses.items():
            rows = np.flatnonzero(choice == mi)
            ids[rows] = resp.ids
            scores[rows] = resp.scores
            known[rows] = resp.known
        return ServeResponse(
            ids=ids, scores=scores, known=known,
            snapshot_version=max(r.snapshot_version
                                 for r in responses.values()),
            cache_hits=sum(r.cache_hits for r in responses.values()),
            fallbacks=sum(r.fallbacks for r in responses.values()),
            staleness_events=max(r.staleness_events
                                 for r in responses.values()),
            snapshot_forgets=max(r.snapshot_forgets
                                 for r in responses.values()))

    def _serve_blend(self, uids, w_rows, names, n) -> ServeResponse:
        responses = [self.members[name].recommend(uids, n=n)
                     for name in names]
        top_n = responses[0].ids.shape[1]
        ids, scores, known = fuse_topn(
            [r.ids for r in responses],
            [r.scores for r in responses],
            [r.known for r in responses],
            w_rows, top_n=top_n, method=self.blend.method,
            rrf_k=self.blend.rrf_k)
        # Unknown-everywhere rows: hand over the argmax-weight member's
        # popularity-fallback row verbatim (scores are that head's mass).
        fallbacks = 0
        for q in np.flatnonzero(~known):
            mi = switch_choice(w_rows[q], names)
            ids[q] = responses[mi].ids[q]
            scores[q] = responses[mi].scores[q]
            fallbacks += 1
        return ServeResponse(
            ids=ids, scores=scores, known=known,
            snapshot_version=max(r.snapshot_version for r in responses),
            cache_hits=sum(r.cache_hits for r in responses),
            fallbacks=fallbacks,
            staleness_events=max(r.staleness_events for r in responses),
            snapshot_forgets=max(r.snapshot_forgets for r in responses))

    # -- checkpoint / restore ---------------------------------------------

    def checkpoint(self, directory: str) -> str:
        """Persist every member + the weigher: survives restart AND
        rescale (member checkpoints are grid-portable; the weigher is
        grid-agnostic)."""
        os.makedirs(directory, exist_ok=True)
        for name, member in self.members.items():
            member.checkpoint(os.path.join(directory, name))
        manifest = {
            "format": ENSEMBLE_FORMAT,
            "members": list(self.members),
            "events_processed": self.events_processed,
            "weigher_config": self.weigher_config._asdict(),
            "weigher": weigher_to_dict(self._weigher),
            "blend": self.blend._asdict(),
            "user_seen": sorted((int(u), int(c))
                                for u, c in self._user_seen.items()),
        }
        path = os.path.join(directory, "ensemble.json")
        with open(path, "w") as f:
            json.dump(manifest, f, indent=2)
            f.write("\n")
        return directory

    @classmethod
    def restore(cls, directory: str, configs: Sequence[StreamConfig], *,
                publish: PublishPolicy | None = None,
                snapshot_slots: int = 2,
                metrics: metrics_lib.MetricsRegistry | None = None,
                ) -> "EnsembleSession":
        """Resume from :meth:`checkpoint` output.

        ``configs`` may target a DIFFERENT grid than the save — member
        checkpoints regrid on restore (``StreamSession.restore``), and
        the weigher state carries over untouched, so an ensemble
        survives a rescale-through-restart round trip.
        """
        with open(os.path.join(directory, "ensemble.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != ENSEMBLE_FORMAT:
            raise ValueError(
                f"unknown ensemble checkpoint format "
                f"{manifest.get('format')!r}")
        saved = set(manifest["members"])
        asked = {cfg.algorithm for cfg in configs}
        if saved != asked:
            raise ValueError(
                f"checkpoint holds members {sorted(saved)} but configs "
                f"ask for {sorted(asked)}")
        session = cls(
            configs,
            weigher=WeigherConfig(**manifest["weigher_config"]),
            blend=BlendPolicy(**manifest["blend"]),
            publish=publish, snapshot_slots=snapshot_slots,
            metrics=metrics)
        by_name = {cfg.algorithm: cfg for cfg in configs}
        for name in session.members:
            session.members[name] = StreamSession.restore(
                os.path.join(directory, name), by_name[name],
                publish=publish, snapshot_slots=snapshot_slots,
                metrics=metrics_lib.ScopedRegistry(session.metrics,
                                                   member=name))
        session._weigher = weigher_from_dict(manifest["weigher"],
                                             device=session.device)
        session._user_seen = defaultdict(
            int, {int(u): int(c) for u, c in manifest["user_seen"]})
        session.events_processed = int(manifest["events_processed"])
        return session

    # -- elasticity -------------------------------------------------------

    def rescale(self, grid: GridSpec, **kwargs) -> None:
        """Reshape every member's worker grid; the weigher is untouched
        (weights are grid-agnostic, like the members' drift detectors)."""
        with trace_lib.span("regrid", self._scope):
            for member in self.members.values():
                member.rescale(grid, **kwargs)


def _aligned_bits(res: StreamResult, cfg: StreamConfig,
                  n: int) -> np.ndarray | None:
    """Stream-order recall bits aligned to the n submitted events.

    The host loop emits one bit row per micro-batch laid out
    ``[carried..., fresh...]``; the device loop (``cuda`` and ``scan``)
    emits fixed ``[carry_cap + micro_batch]`` rows. With no overflow
    re-queues the fresh positions ARE submission order; re-queued events
    land in carry slots whose user is unknown here, so they are excluded
    from the stratified reward (the global head still counts them).
    Returns ``None`` when the layout cannot be aligned.
    """
    bits = res.recall.bits()
    if bits.size == n:
        return bits
    mb = cfg.micro_batch
    carry_cap = cfg.carry_slots or mb
    layout = carry_cap + mb
    if bits.size and bits.size % layout == 0:
        fresh = bits.reshape(-1, layout)[:, carry_cap:].reshape(-1)
        if fresh.size >= n:
            return fresh[:n]
    return None
