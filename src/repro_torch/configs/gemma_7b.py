"""gemma-7b [arXiv:2403.08295]. 28L d3072 16H kv16 ff24576 v256000, GeGLU, head_dim 256."""
from repro_torch.models.config import ArchConfig, MLPKind, register

CONFIG = register(ArchConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072,
    n_heads=16, n_kv_heads=16, d_ff=24576, vocab=256000, head_dim=256,
    mlp=MLPKind.GEGLU, tie_embeddings=True,
))
