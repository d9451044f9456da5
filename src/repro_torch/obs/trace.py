"""Span tracing: nestable timed stages + PyTorch profiler hooks.

Port of ``repro/obs/trace.py:23-67``: ``span``, ``current_span`` and
``profile``. ``span("ingest")`` times a runtime stage with
``time.perf_counter`` and marks its dynamic extent with
``torch.profiler.record_function`` (plus an NVTX range when CUDA is
available), so the same stage names land in traces captured with
:func:`profile`. Spans nest per-thread: a span opened inside another
records under the joined path (``"ingest/publish"``), which is also the
``stage`` label of the ``span_seconds`` histogram when a registry is
passed.

    reg = MetricsRegistry()
    with span("ingest", reg):
        ...
    reg.get("span_seconds").labels(stage="ingest").percentile(99)

One-call profiler capture (a Chrome trace, viewable in perfetto)::

    with obs.profile("/tmp/torch-trace"):
        session.ingest(users, items)
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

__all__ = ["span", "profile", "current_span"]

_tls = threading.local()


def current_span() -> str:
    """The calling thread's open span path ("" outside any span)."""
    return "/".join(getattr(_tls, "stack", ()))


def _nvtx(path: str):
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(path)
    return contextlib.nullcontext()


@contextlib.contextmanager
def span(name: str, registry=None):
    """Time a stage; optionally record into ``registry``'s
    ``span_seconds{stage=...}`` histogram. Yields the full span path."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(name)
    path = "/".join(stack)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(path), _nvtx(path):
            yield path
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        if registry is not None:
            registry.histogram(
                "span_seconds", "Wall time of runtime stages",
                labels=("stage",)).labels(stage=path).observe(dt)


@contextlib.contextmanager
def profile(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity,
    and the card's when CUDA is available) into ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
