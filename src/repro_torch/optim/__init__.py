"""Optimizer (counterpart of ``repro.optim``)."""
from . import adamw
from .adamw import AdamWConfig

__all__ = ["AdamWConfig", "adamw"]
