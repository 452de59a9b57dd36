"""The LM stack of the port (counterpart of ``repro.models``): plain
functions over dictionaries of tensors.  Ported: attention (``ATTN``,
``SHARED_ATTN``), MoE, Mamba-2 and xLSTM (``MLSTM``, ``SLSTM``) blocks,
prefill, decode and training (``loss_fn``, ``make_train_step``);
cross-attention is not."""
from .config import (ArchConfig, BlockKind, MLPKind, MoEConfig, SSMConfig,
                     get_arch, list_archs)
from .steps import (make_decode_step, make_eval_step, make_forward,
                    make_prefill_step, make_train_step)
from .transformer import (ModelDims, decode_step, forward, init_cache,
                          init_params, loss_fn, prefill)

__all__ = ["ArchConfig", "BlockKind", "MLPKind", "MoEConfig", "ModelDims",
           "SSMConfig", "decode_step", "forward", "get_arch", "init_cache",
           "init_params", "list_archs", "loss_fn", "make_decode_step",
           "make_eval_step", "make_forward", "make_prefill_step",
           "make_train_step", "prefill"]
