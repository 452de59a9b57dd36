"""Beam-screening kernel (counterpart of ``repro.kernels.scar_search``)."""
from .kernel import conflict_counts_plain, scar_search, scar_search_plain
from .ops import masked_topk, screen

__all__ = ["conflict_counts_plain", "masked_topk", "scar_search",
           "scar_search_plain", "screen"]
