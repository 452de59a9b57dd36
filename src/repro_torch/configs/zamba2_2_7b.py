"""zamba2-2.7b [arXiv:2411.15242]. 54L d2560: Mamba2 backbone with a weight-
-shared attention block every 6th layer; ssm_state=64."""
from repro_torch.models.config import ArchConfig, BlockKind, MLPKind, SSMConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000, head_dim=80,
    mlp=MLPKind.GELU,
    pattern=(BlockKind.MAMBA2,) * 5 + (BlockKind.SHARED_ATTN,),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True,
))
