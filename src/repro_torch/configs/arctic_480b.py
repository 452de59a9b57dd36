"""arctic-480b [hf:Snowflake/snowflake-arctic-base].
35L d7168 56H kv8, MoE 128e top-2 (ff 4864) + dense residual, v32000."""
from repro_torch.models.config import ArchConfig, BlockKind, MLPKind, MoEConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000, head_dim=128,
    mlp=MLPKind.SWIGLU, default_kind=BlockKind.MOE,
    moe=MoEConfig(n_experts=128, top_k=2, expert_d_ff=4864,
                  dense_residual=True, dense_d_ff=4864),
))
