"""Public wrapper in the model layout (``[B, L, H, ...]``).

Counterpart of ``repro/kernels/ssd_scan/ops.py``.  ``use_kernel=True`` runs
``kernel.ssd_scan`` (the CUDA kernel on CUDA tensors, the plain version on
the CPU), ``use_kernel=False`` the plain version on the inputs' device.
The port reads the ``[B, L, H, ...]`` tensors in place where the reference
transposes them to ``[BH, L, ...]``.
"""
from __future__ import annotations

import torch

from .kernel import ssd_scan, ssd_scan_plain

__all__ = ["gla"]


def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
        *, chunk: int = 128, use_kernel: bool = True) -> torch.Tensor:
    """q,k: [B, L, H, N]; v: [B, L, H, P]; a: [B, L, H] -> [B, L, H, P]."""
    fn = ssd_scan if use_kernel else ssd_scan_plain
    return fn(q, k, v, a, chunk=chunk)
