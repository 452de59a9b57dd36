"""Checkpointing (counterpart of ``repro.distributed``; its ``sharding``
and ``compress`` are not ported yet: ROADMAP.md, queue 1)."""
from . import checkpoint

__all__ = ["checkpoint"]
