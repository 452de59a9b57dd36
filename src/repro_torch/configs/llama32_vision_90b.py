"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision scaled].
100L d8192 64H kv8 ff28672 v128256; cross-attn image layers every 5th;
vision frontend stubbed: input_specs() provides patch embeddings."""
from repro_torch.models.config import ArchConfig, BlockKind, MLPKind, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, mlp=MLPKind.SWIGLU,
    pattern=(BlockKind.ATTN,) * 4 + (BlockKind.CROSS_ATTN,),
    frontend_stub=False, cross_ctx_len=4096,
))
