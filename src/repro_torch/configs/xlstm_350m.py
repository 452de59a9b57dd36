"""xlstm-350m [arXiv:2405.04517]. 24L d1024 4H, alternating mLSTM/sLSTM, no FFN."""
from repro_torch.models.config import ArchConfig, BlockKind, MLPKind, SSMConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, mlp=MLPKind.NONE,
    pattern=(BlockKind.MLSTM, BlockKind.SLSTM),
    ssm=SSMConfig(chunk=256), sub_quadratic=True, tie_embeddings=True,
))
