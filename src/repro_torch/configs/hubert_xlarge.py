"""hubert-xlarge [arXiv:2106.07447]. 48L d1280 16H ff5120, encoder-only,
conv frontend stubbed: input_specs() provides frame embeddings [B,T,1280]."""
from repro_torch.models.config import ArchConfig, MLPKind, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, mlp=MLPKind.GELU,
    encoder_only=True, frontend_stub=True, rope_theta=10000.0,
))
