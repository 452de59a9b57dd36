"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B].
24L d2048 16H kv16, 60 routed top-4 + 4 shared experts (ff 1408), v151936."""
from repro_torch.models.config import ArchConfig, BlockKind, MLPKind, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151936,
    mlp=MLPKind.SWIGLU, qkv_bias=True, default_kind=BlockKind.MOE,
    moe=MoEConfig(n_experts=60, top_k=4, expert_d_ff=1408,
                  n_shared_experts=4),
))
