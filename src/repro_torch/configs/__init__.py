"""Assigned-architecture configs (copies of ``repro.configs``); importing
this package registers them.  Blocks the port has not ported yet raise
``NotImplementedError`` when a model is built (``models.blocks``)."""
from . import (arctic_480b, command_r_35b, gemma_7b, hubert_xlarge,
               llama32_vision_90b, minitron_8b, qwen2_5_32b, qwen2_moe_a2_7b,
               xlstm_350m, zamba2_2_7b)

ASSIGNED = [
    "minitron-8b", "command-r-35b", "gemma-7b", "qwen2.5-32b", "arctic-480b",
    "qwen2-moe-a2.7b", "xlstm-350m", "hubert-xlarge", "zamba2-2.7b",
    "llama-3.2-vision-90b",
]
