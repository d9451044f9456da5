"""Closed-loop concept-drift runtime for the streaming recommender.

Port of ``repro/drift/__init__.py``, the same public names:

  * ``scenarios`` — named, seeded drift stream shapes (abrupt, gradual,
    incremental, recurring, cluster-migration, cold-start), numpy only;
  * ``detector`` — the two-window / Page–Hinkley-style recall-drop
    detector, carried in the device loop (no host sync);
  * ``controller`` — detector firings to forgetting actions (an eviction
    pass and an optional gradual-decay boost), replacing the fixed
    ``trigger_every`` cadence when ``StreamConfig.drift`` opts in;
  * ``metrics`` — ``recovery_report`` over a run's recall bits.
"""

from repro_torch.drift.controller import (DriftPolicy, controller_init,
                                          make_controller)
from repro_torch.drift.detector import (DetectorConfig, DetectorState,
                                        detector_init, detector_update)
from repro_torch.drift.metrics import DriftReport, recovery_report
from repro_torch.drift.scenarios import (DEFAULT_PROFILE, SCENARIOS,
                                         DriftStream, list_scenarios,
                                         make_scenario)

__all__ = [
    "DriftPolicy", "make_controller", "controller_init",
    "DetectorConfig", "DetectorState", "detector_init", "detector_update",
    "DriftReport", "recovery_report",
    "DriftStream", "SCENARIOS", "make_scenario", "list_scenarios",
    "DEFAULT_PROFILE",
]
