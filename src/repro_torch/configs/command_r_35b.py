"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01]. 40L d8192 64H kv8 ff22528 v256000, no bias."""
from repro_torch.models.config import ArchConfig, MLPKind, register

CONFIG = register(ArchConfig(
    name="command-r-35b", family="dense", n_layers=40, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22528, vocab=256000, mlp=MLPKind.SWIGLU,
))
