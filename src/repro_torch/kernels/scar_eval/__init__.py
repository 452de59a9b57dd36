"""Candidate-scoring kernel (counterpart of ``repro.kernels.scar_eval``)."""
from .kernel import blocked_cumsum, scar_eval, scar_eval_plain
from .ops import PackedCandidates, evaluate, pack_candidates

__all__ = ["PackedCandidates", "blocked_cumsum", "evaluate",
           "pack_candidates", "scar_eval", "scar_eval_plain"]
