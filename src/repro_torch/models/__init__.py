"""The LM stack of the port (counterpart of ``repro.models``): plain
functions over dictionaries of tensors.  Ported: attention (``ATTN``,
``SHARED_ATTN``), MoE, Mamba-2 and xLSTM (``MLSTM``, ``SLSTM``) blocks,
prefill and decode; cross-attention is not."""
from .config import (ArchConfig, BlockKind, MLPKind, MoEConfig, SSMConfig,
                     get_arch, list_archs)
from .steps import make_decode_step, make_forward, make_prefill_step
from .transformer import (ModelDims, decode_step, forward, init_cache,
                          init_params, prefill)

__all__ = ["ArchConfig", "BlockKind", "MLPKind", "MoEConfig", "ModelDims",
           "SSMConfig", "decode_step", "forward", "get_arch", "init_cache",
           "init_params", "list_archs", "make_decode_step", "make_forward",
           "make_prefill_step", "prefill"]
