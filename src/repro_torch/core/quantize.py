"""Shared score quantisation for cross-backend ordering decisions.

Every place the pipeline turns scores into an *ordering* — the SEG top-k,
the ``build_candidates`` (tier, score) lexsort, the refine relocate screen,
and the device search path's on-device top-k — rounds scores to a fixed
number of significant digits first, so that

* structurally tied candidates (identical segments summed in a different
  order by a batched pass) compare exactly equal and fall back to stable
  enumeration order, and
* float32 device scores and float64 host scores land in the same bucket for
  anything but true near-ties at a quantisation boundary, so host and device
  tie-breaks cannot drift apart.

``quantize_scores`` is the numpy form (``segmentation`` re-exports it);
``quantize_scores_torch`` is the tensor form for device-side ordering (the
counterpart of the reference's ``quantize_scores_jax``) — the same rounding
rule expressed with ``where`` masks instead of boolean indexing.

``SCORE_SIG`` is the candidate-ordering parameter: ``sig = 5`` rounds to 6
significant digits — coarse enough to absorb float32 backend noise
(documented in ``sched.build_candidates``), fine enough that genuinely
different plans never collide.  The SEG stage keeps its finer default
(``sig = 11``) because it only ever compares float64 against float64.
"""
from __future__ import annotations

import numpy as np
import torch

# 6 significant digits: the shared host/device candidate-ordering grain.
SCORE_SIG = 5

# 10.0 ** k for k in [-_POW10_BIAS, 308]: every float64 decade, shifted
# by any sig the callers use.
_POW10_BIAS = 400
_POW10 = torch.from_numpy(
    10.0 ** np.arange(-_POW10_BIAS, 309, dtype=np.float64))
_POW10_ON: dict[tuple[torch.device, torch.dtype], torch.Tensor] = {}


def pow10_table(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The powers-of-ten table on ``device`` in ``dtype``, copied once.

    A host-to-device copy blocks the host, so the device search uploads
    the table before its window program runs and the program reuses it.
    """
    key = (torch.device(device), dtype)
    if key not in _POW10_ON:
        _POW10_ON[key] = _POW10.to(device=key[0], dtype=dtype)
    return _POW10_ON[key]


def pow10_table_clear() -> None:
    """Drop the device copies of the table (``scheduler.clear_caches``)."""
    _POW10_ON.clear()


def quantize_scores(scores: np.ndarray, sig: int = 11) -> np.ndarray:
    """Round to ``sig + 1`` significant digits (12 at the default).

    Non-finite and zero entries pass through unchanged, so +inf padding and
    empty-segment zeros keep their exact values and ordering.
    """
    out = np.asarray(scores, dtype=np.float64).copy()
    nz = np.isfinite(out) & (out != 0)
    exp = np.floor(np.log10(np.abs(out[nz])))
    scale = 10.0 ** (exp - sig)
    out[nz] = np.round(out[nz] / scale) * scale
    return out


def quantize_scores_torch(scores: torch.Tensor,
                          sig: int = SCORE_SIG) -> torch.Tensor:
    """Tensor form of ``quantize_scores``, computed in the input dtype.

    Same rounding rule (round to ``sig + 1`` significant digits; zeros and
    non-finite values pass through) on whatever device ``scores`` lives on.
    In float64 it divides by the scale, as numpy does, and agrees bitwise
    with the numpy form up to libm ``log10`` behaviour at exact powers of
    ten.  In float32 it multiplies by the inverse power of ten instead: the
    reference's compiled float32 program (``quantize_scores_jax`` under
    ``jax.jit``) turns ``x / 10**k`` into ``x * 10**-k``, and the two differ
    by one grain on about 1% of inputs.
    """
    x = scores
    nz = torch.isfinite(x) & (x != 0)
    ax = torch.where(nz, x.abs(), torch.ones_like(x))   # keeps log finite
    exp = torch.floor(torch.log10(ax))
    # 10 ** k from a table made by numpy's array power, as the numpy form
    # computes it: torch.pow rounds some powers of ten differently
    pow10 = pow10_table(x.device, x.dtype)
    k = (exp - sig).long()
    scale = pow10[k.clamp(-_POW10_BIAS, 308) + _POW10_BIAS]
    if x.dtype == torch.float32:
        inv = pow10[(-k).clamp(-_POW10_BIAS, 308) + _POW10_BIAS]
        return torch.where(nz, torch.round(x * inv) * scale, x)
    return torch.where(nz, torch.round(x / scale) * scale, x)
