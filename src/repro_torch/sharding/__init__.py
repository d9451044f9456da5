"""Logical-axis sharding: the rules (``specs``), the active mesh and its
collectives (``ctx``) and the sharded program (``fsdp``)."""
