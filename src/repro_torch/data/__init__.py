"""Synthetic training data (counterpart of ``repro.data``)."""
from .pipeline import StepWatchdog, SyntheticLM

__all__ = ["StepWatchdog", "SyntheticLM"]
