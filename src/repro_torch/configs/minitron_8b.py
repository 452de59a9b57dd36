"""minitron-8b: pruned Nemotron [arXiv:2407.14679]. 32L d4096 32H kv8 ff16384 v256000."""
from repro_torch.models.config import ArchConfig, MLPKind, register

CONFIG = register(ArchConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=16384, vocab=256000,
    mlp=MLPKind.GELU,  # Nemotron-4 uses squared-ReLU-class dense MLP
))
