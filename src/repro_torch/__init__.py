"""PyTorch/CUDA port of the S&R streaming recommender (paper 2204.04633).

A second package beside the JAX reference ``repro``: it imports torch
and numpy, never jax and nothing of ``repro``. Its hot path runs on an
NVIDIA H100 through hand-written kernels (``repro_torch/kernels``); CPU
tensors take the plain PyTorch versions of those kernels.

Ported so far: DISGD (Alg. 2), DICS (Alg. 3) and BPR-MF
(``repro_torch.algos.bpr``) trained prequentially over the Splitting &
Replication grid (``run_stream``, ``algorithm="disgd"``, ``"dics"`` or
``"bpr"``; backends ``cuda``, ``scan`` and the ``host`` reference loop)
and grid top-N serving (``grid_topn``); forgetting (``ForgettingConfig``:
LRU, LFU, gradual decay), closed-loop drift control (``DriftPolicy``,
``repro_torch.drift``) and the loop's telemetry vector
(``repro_torch.obs.telemetry``) on every backend; the session and
serving runtime (``StreamSession`` ingest / recommend over a
``SnapshotStore`` of copies published at micro-batch boundaries, the
``QueryFrontend`` and its ``PublishPolicy``, the ``MetricsRegistry``
with the folded ``stream_*`` counters); storage policies
(``StoragePolicy``: packed ``rated``, quantized ``co``, bf16 factors)
through every loop and serve leaf, regrid (``repro_torch.core.regrid``)
and grid-portable checkpoints that either package reads
(``save_stream_checkpoint`` / ``restore_stream_checkpoint``, the
session's ``checkpoint`` / ``restore`` / ``rescale``); the elastic
autoscaler (``Autoscaler``, ``AutoscalePolicy``) and the mixed-load
service runner (``repro_torch.serve.service``); the ensemble runtime
(``EnsembleSession`` over any registered algorithms, ``WeigherConfig``,
``BlendPolicy``); the launch drivers (``repro_torch.launch.serve_rs``,
``drift_rs``, ``rescale_rs``, ``service_rs``, ``quickstart``); and the
LLM zoo's serving path for h2o-danube-1.8b (``repro_torch.launch.serve``,
``repro_torch.models.factory.build``). ``__all__`` is ``repro.__all__``
plus ``recommend_topn``.
"""

# Registers the plugins (BPR-MF) before anything looks an algorithm up.
from repro_torch import algos  # noqa: F401
from repro_torch.algos import BprHyper

from repro_torch.core.algorithm import (Algorithm, get_algorithm, register,
                                        registered)
from repro_torch.core.dics import DicsHyper
from repro_torch.core.disgd import DisgdHyper
from repro_torch.core.forgetting import ForgettingConfig
from repro_torch.core.pipeline import (RestoredCheckpoint, StreamConfig,
                                       StreamResult,
                                       restore_stream_checkpoint, run_stream,
                                       save_stream_checkpoint)
from repro_torch.core.routing import GridSpec
from repro_torch.core.storage import StoragePolicy, StoragePolicyError
from repro_torch.core.serve import recommend_topn
from repro_torch.drift import DriftPolicy
from repro_torch.ensemble import (BlendPolicy, EnsembleResult,
                                  EnsembleSession, WeigherConfig)
from repro_torch.obs import MetricsRegistry, ScopedRegistry
from repro_torch.serve import (AutoscalePolicy, Autoscaler, PublishPolicy,
                               QueryFrontend, ServeConfig, ServeResponse,
                               SnapshotStore, StaleSnapshotError, grid_topn)
from repro_torch.session import StreamSession

__all__ = ["StreamConfig", "StreamResult", "run_stream", "GridSpec",
           "ForgettingConfig", "DriftPolicy",
           "DisgdHyper", "DicsHyper", "BprHyper", "grid_topn",
           "recommend_topn", "StreamSession", "PublishPolicy",
           "ServeConfig", "ServeResponse", "QueryFrontend", "SnapshotStore",
           "StaleSnapshotError", "MetricsRegistry", "ScopedRegistry",
           "register", "get_algorithm", "registered", "StoragePolicy",
           "StoragePolicyError", "RestoredCheckpoint",
           "save_stream_checkpoint", "restore_stream_checkpoint",
           "Algorithm", "Autoscaler", "AutoscalePolicy", "EnsembleSession",
           "EnsembleResult", "WeigherConfig", "BlendPolicy"]
