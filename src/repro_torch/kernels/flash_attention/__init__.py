"""Attention kernel (counterpart of ``repro.kernels.flash_attention``)."""
from .kernel import attention_plain, flash_attention
from .ops import mha

__all__ = ["attention_plain", "flash_attention", "mha"]
