"""qwen2.5-32b [hf:Qwen]. 64L d5120 40H kv8 ff27648 v152064, QKV bias."""
from repro_torch.models.config import ArchConfig, MLPKind, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152064,
    mlp=MLPKind.SWIGLU, qkv_bias=True,
))
