"""Attention kernel (counterpart of ``repro.kernels.flash_attention``)."""
from .grad import (FlashAttentionFn, attention, attention_bwd_plain,
                   flash_attention_bwd)
from .kernel import attention_plain, flash_attention, lse_buffer
from .ops import mha

__all__ = ["FlashAttentionFn", "attention", "attention_bwd_plain",
           "attention_plain", "flash_attention", "flash_attention_bwd",
           "lse_buffer", "mha"]
