"""First-party algorithm plugins of the port (``repro/algos/__init__.py``).

Importing this package registers every plugin with
``repro_torch.core.algorithm``; ``repro_torch/__init__.py`` imports it
eagerly, so ``StreamConfig(algorithm="bpr")`` resolves without an
explicit import. Each module here is written against the registry's
protocol and the public state containers only.
"""

from repro_torch.algos import bpr  # noqa: F401  (registers "bpr")
from repro_torch.algos.bpr import BprHyper

__all__ = ["bpr", "BprHyper"]
