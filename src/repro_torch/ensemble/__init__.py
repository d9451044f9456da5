"""Adaptive ensemble runtime over the ``Algorithm`` registry.

Port of ``repro/ensemble/__init__.py``, the same public names. Trains
several registered algorithms ({DISGD, DICS, BPR-MF}, or any subset) on
one event stream and serves a blended or hard-switched per-user top-N
from their snapshot planes:

  * ``members`` — :class:`EnsembleSession`: the fan-out facade (ingest /
    recommend / checkpoint / restore / rescale over N member
    ``StreamSession``\\ s sharing one metrics registry);
  * ``weights`` — the prequential weigher (exp3/softmax over each
    member's telemetry recall or precision@N head; drift flags re-open
    exploration), float32 tensors on the members' device;
  * ``blend``   — serve-plane rank fusion on the host (weighted RRF /
    Borda with the deterministic score-desc/id-asc tie-break) and switch
    routing.
"""

from repro_torch.ensemble.blend import BlendPolicy, fuse_topn, switch_choice
from repro_torch.ensemble.members import (ENSEMBLE_FORMAT, EnsembleResult,
                                          EnsembleSession)
from repro_torch.ensemble.weights import (WeigherConfig, WeigherState,
                                          popularity_stratum, weigher_init,
                                          weigher_update)

__all__ = [
    "EnsembleSession", "EnsembleResult", "ENSEMBLE_FORMAT",
    "WeigherConfig", "WeigherState", "weigher_init", "weigher_update",
    "popularity_stratum",
    "BlendPolicy", "fuse_topn", "switch_choice",
]
