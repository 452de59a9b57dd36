"""Public wrapper in the model layout (``[B, S, H, D]``).

Counterpart of ``repro/kernels/flash_attention/ops.py``.  ``use_kernel=True``
runs ``kernel.flash_attention`` (the CUDA kernel on CUDA tensors, the plain
version on the CPU), ``use_kernel=False`` the plain version on the inputs'
device.  The port reads the ``[B, S, H, D]`` tensors in place where the
reference transposes them to ``[BH, S, D]``.
"""
from __future__ import annotations

import torch

from .kernel import attention_plain, flash_attention

__all__ = ["mha"]


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, use_kernel: bool = True) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D]."""
    fn = flash_attention if use_kernel else attention_plain
    return fn(q, k, v, causal=causal)
