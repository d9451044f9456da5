"""Shared CLI plumbing for the launch drivers.

Port of ``repro/launch/common.py``. Every runtime driver (``serve_rs``,
``drift_rs``, ``rescale_rs``, ``service_rs``, ``quickstart``) takes the
same core flags — algorithm (registry-backed choices), grid shape, event
count, micro-batch, per-worker capacities, backend, device, seed. This
module is the single source:

  * :func:`base_parser` — an ``ArgumentParser`` pre-loaded with the
    common flags; per-driver defaults are keyword overrides, and the
    grid / capacity groups can be switched off for drivers that manage
    those themselves;
  * :func:`parse_grid` — ``"NxG"`` → ``GridSpec.rect`` (the rescale
    driver's grid syntax, now shared);
  * :func:`stream_config` — parsed args → ``StreamConfig`` with the
    algorithm's default hyper resolved and capacity/top-N overrides
    applied;
  * :func:`demo_stream` — the drivers' standard synthetic stream (a
    MovieLens-25M-shaped profile scaled to laptop size), truncated to
    ``--events``;
  * :func:`obs_capture` / :func:`export_metrics` — the observability
    side of the shared flags: ``--profile-dir`` wraps the driver's hot
    section in a ``torch.profiler`` trace, ``--metrics-json`` /
    ``--prom-out`` export the run's :class:`~repro_torch.obs.metrics.
    MetricsRegistry` on exit.

Beside JAX's flags: ``--backend`` takes ``cuda`` (the default, the
port's kernel loop), its alias ``pallas``, ``scan`` and ``host``, and
``--device`` (default ``cuda``) places the states; ``--device cpu`` runs
every kernel's plain version.
"""

from __future__ import annotations

import argparse
import contextlib

from repro_torch.core.algorithm import get_algorithm, registered
from repro_torch.core.pipeline import StreamConfig
from repro_torch.core.routing import GridSpec
from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream

__all__ = ["base_parser", "parse_grid", "stream_config", "demo_stream",
           "obs_capture", "export_metrics", "DEMO_SCALE"]

#: The drivers' shared synthetic-stream scale (of MOVIELENS_25M).
DEMO_SCALE = 0.003


def parse_grid(spec: str) -> GridSpec:
    """"NxG" -> ``GridSpec.rect(n_i=N, g=G)`` (e.g. "2x2", "4x2", "1x4")."""
    n_i, g = (int(x) for x in spec.lower().split("x"))
    return GridSpec.rect(n_i, g)


def base_parser(description: str, *, grid: bool = True, caps: bool = True,
                algorithm: str = "disgd", events: int = 8192,
                micro_batch: int = 256, n_i: int = 2, u_cap: int = 512,
                i_cap: int = 64, top_n: int = 10,
                seed: int = 0) -> argparse.ArgumentParser:
    """The common driver flags; keyword arguments set per-driver defaults.

    ``grid=False`` omits ``--n-i`` (drivers with their own grid syntax,
    e.g. rescale's ``--from-grid/--to-grid``, or quickstart's sweep);
    ``caps=False`` omits ``--u-cap/--i-cap/--top-n`` likewise.
    """
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--algorithm", default=algorithm, choices=registered())
    ap.add_argument("--events", type=int, default=events)
    ap.add_argument("--micro-batch", type=int, default=micro_batch)
    if grid:
        ap.add_argument("--n-i", type=int, default=n_i,
                        help="item splits (grid)")
    if caps:
        ap.add_argument("--u-cap", type=int, default=u_cap)
        ap.add_argument("--i-cap", type=int, default=i_cap)
        ap.add_argument("--top-n", type=int, default=top_n)
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "pallas", "scan", "host"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the states (cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=seed)
    obs = ap.add_argument_group("observability")
    obs.add_argument("--metrics-json", default=None, metavar="PATH",
                     help="write the run's metrics registry as JSON on exit")
    obs.add_argument("--prom-out", default=None, metavar="PATH",
                     help="write Prometheus text exposition on exit")
    obs.add_argument("--profile-dir", default=None, metavar="DIR",
                     help="capture a torch.profiler trace of the run "
                          "(view with Perfetto / chrome://tracing)")
    return ap


def obs_capture(args):
    """Context manager for the driver's hot section: a ``torch.profiler``
    trace into ``--profile-dir`` when given, else a no-op."""
    if getattr(args, "profile_dir", None):
        from repro_torch.obs import trace as trace_lib
        return trace_lib.profile(args.profile_dir)
    return contextlib.nullcontext()


def export_metrics(args, registry) -> None:
    """Honor ``--metrics-json`` / ``--prom-out`` for ``registry``
    (quietly a no-op when neither flag was passed or it is ``None``)."""
    if registry is None:
        return
    if getattr(args, "metrics_json", None):
        registry.write_json(args.metrics_json)
        print(f"[obs] metrics json -> {args.metrics_json}")
    if getattr(args, "prom_out", None):
        registry.write_prometheus(args.prom_out)
        print(f"[obs] prometheus exposition -> {args.prom_out}")


def stream_config(args, grid: GridSpec | None = None) -> StreamConfig:
    """Build the ``StreamConfig`` a ``base_parser`` namespace describes."""
    if grid is None:
        grid = GridSpec(args.n_i)
    hyper = get_algorithm(args.algorithm).default_hyper()
    over = {}
    for field in ("u_cap", "i_cap", "top_n"):
        v = getattr(args, field, None)
        if v is not None:
            over[field] = v
    if over:
        hyper = hyper._replace(**over)
    return StreamConfig(algorithm=args.algorithm, grid=grid,
                        micro_batch=args.micro_batch, hyper=hyper,
                        backend=args.backend, device=args.device)


def demo_stream(events: int, seed: int = 0):
    """The drivers' standard synthetic (users, items) stream."""
    profile = scaled(MOVIELENS_25M, DEMO_SCALE)
    users, items, _ = synth_stream(profile, seed=seed)
    if events:
        users, items = users[:events], items[:events]
    return users, items
