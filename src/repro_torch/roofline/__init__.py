from repro_torch.roofline.analysis import (
    HW,
    RooflineReport,
    analyze,
    collective_bytes,
)

__all__ = ["HW", "RooflineReport", "analyze", "collective_bytes"]
