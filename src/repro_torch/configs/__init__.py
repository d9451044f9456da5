"""Architecture configs. ``get_config(arch_id)`` / ``get_smoke_config``."""

from repro_torch.configs.base import (
    ARCH_IDS,
    PORTED_ARCH_IDS,
    ArchConfig,
    get_config,
    get_smoke_config,
)
from repro_torch.configs.shapes import SHAPES, InputShape

__all__ = ["ArchConfig", "ARCH_IDS", "PORTED_ARCH_IDS", "get_config",
           "get_smoke_config", "SHAPES", "InputShape"]
