"""Candidate-scoring kernel (counterpart of ``repro.kernels.scar_eval``)."""
from .kernel import (WindowBatch, blocked_cumsum, scar_eval, scar_eval_plain,
                     scar_eval_window_plain)
from .ops import (ModelInputs, evaluate, model_inputs, pack_window,
                  window_arrays)

__all__ = ["ModelInputs", "WindowBatch", "blocked_cumsum", "evaluate",
           "model_inputs", "pack_window", "scar_eval", "scar_eval_plain",
           "scar_eval_window_plain", "window_arrays"]
