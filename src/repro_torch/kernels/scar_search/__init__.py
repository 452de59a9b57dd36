"""Beam-screening kernel (counterpart of ``repro.kernels.scar_search``)."""
from .kernel import conflict_counts_plain, scar_search
from .ops import conflict_counts, masked_topk

__all__ = ["conflict_counts", "conflict_counts_plain", "masked_topk",
           "scar_search"]
