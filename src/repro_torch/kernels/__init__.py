"""Hand-written CUDA kernels of the port, with their plain torch versions.

Sources live in ``csrc/``; ``build`` compiles them with ``nvcc`` at first
use.  Each kernel package exposes the wrapper (launch counter included) and
the plain version it is held against.  A kernel's output has no
``grad_fn``: where autograd would record a call (``needs_grad``), the
wrappers raise, and the LM kernels' ``grad`` modules hold the
``autograd.Function``s whose backward is a kernel too.  Packages:
``scar_eval`` and ``scar_search`` (the scheduler's), ``flash_attention``
(with ``flash_attention_bwd``), ``ssd_scan`` (with ``ssd_scan_bwd`` and,
for wide heads and the mLSTM's normaliser, ``ssd_wide_bwd``) and
``slstm`` (the sLSTM recurrence, with ``slstm_bwd``).

The LM kernels' wrappers take the plain version on the CPU and, inside a
cost trace, on ``meta`` (``trace_hooks.plain_device``); a CUDA tensor never
falls back.
"""
import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its pointer is 16 B aligned and its strides but the last are
    multiples of 8 elements (what bf16 16 B loads need), else a fresh
    contiguous copy that keeps broadcast (stride 0) dimensions broadcast."""
    if t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1]):
        return t
    base = t
    for d, s in enumerate(t.stride()):
        if s == 0:
            base = base.narrow(d, 0, 1)
    return base.clone(memory_format=torch.contiguous_format).expand(t.shape)
