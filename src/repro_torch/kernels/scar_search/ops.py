"""Dispatch and selection ops around the ``scar_search`` kernel.

Counterpart of ``repro/kernels/scar_search/ops.py``:

* ``screen`` — one beam stage's masked score plane and counters (see
  ``kernel.py``).  ``use_kernel=True`` launches the CUDA kernel (and raises
  on a CPU device: there is no kernel to run there), ``use_kernel=False``
  runs the plain torch version on the inputs' device.
* ``masked_topk`` — smallest-``k`` selection over a validity mask with the
  lowest-index tie rule of the reference's ``lax.top_k`` on negated scores.
  ``torch.topk`` breaks ties in no fixed order, so this is a stable
  ascending sort.  Callers that need the quantised tie-break quantise
  scores (``core.quantize.quantize_scores_torch``) first.
"""
from __future__ import annotations

import torch

from .kernel import _check, scar_search, scar_search_plain

__all__ = ["masked_topk", "screen"]


def screen(beam_words: torch.Tensor, cand_words: torch.Tensor,
           valid: torch.Tensor, state: torch.Tensor, *, use_kernel: bool,
           **stage) -> tuple[torch.Tensor, torch.Tensor]:
    """``(score [Bm, N], state [4])`` of one beam stage.

    ``stage``: ``keep``, ``max_exp``, ``b_lat``, ``b_e``, ``c_lat``,
    ``c_e`` and ``metric``, as ``kernel.scar_search`` takes them.
    """
    if not use_kernel:
        _check(beam_words, cand_words, valid, state, stage["b_lat"],
               stage["b_e"], stage["c_lat"], stage["c_e"])
        return scar_search_plain(beam_words, cand_words, valid, state,
                                 **stage)
    if beam_words.device.type != "cuda":
        raise RuntimeError("the scar_search kernel needs a CUDA device; the "
                           f"words are on {beam_words.device}")
    return scar_search(beam_words, cand_words, valid, state, **stage)


def masked_topk(scores: torch.Tensor, valid: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values[k], indices[k])`` of the ``k`` smallest valid entries.

    Invalid entries never win; slots past the valid count return
    ``(+inf, -1)``.  Equal scores resolve to the lower index.
    """
    inf = scores.new_full((), float("inf"))
    s = torch.where(valid, scores, inf)
    vals, idx = torch.sort(s, stable=True)
    vals, idx = vals[:k], idx[:k]
    if vals.shape[0] < k:                     # k beyond the input's length
        pad = k - vals.shape[0]
        vals = torch.cat([vals, inf.expand(pad)])
        idx = torch.cat([idx, idx.new_full((pad,), -1)])
    empty = vals == float("inf")
    return vals, torch.where(empty, -1, idx)
