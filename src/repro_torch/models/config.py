"""Architecture configuration (a copy of ``repro.models.config``).

One declarative config drives model build, smoke tests and serving.  A
model is a stack of *super-blocks*: a repeating pattern of block types
(e.g. zamba2 repeats [mamba2 x5, shared_attn]).  The reference stacks each
pattern position's parameters over the repeat dimension and runs the stack
under ``jax.lax.scan``; the port keeps one set of weights per layer and
runs the super-blocks in a Python loop (``models.transformer``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class BlockKind(str, enum.Enum):
    ATTN = "attn"                # self-attention + dense MLP
    MOE = "moe"                  # self-attention + MoE (+optional dense resid)
    MAMBA2 = "mamba2"            # SSD state-space block
    SLSTM = "slstm"              # xLSTM scalar-memory cell
    MLSTM = "mlstm"              # xLSTM matrix-memory cell
    SHARED_ATTN = "shared_attn"  # weight-tied attention block (zamba2)
    CROSS_ATTN = "cross_attn"    # self-attn + cross-attn + MLP (VLM)


class MLPKind(str, enum.Enum):
    SWIGLU = "swiglu"
    GEGLU = "geglu"
    GELU = "gelu"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared_experts: int = 0     # always-on experts (qwen2-moe)
    dense_residual: bool = False  # parallel dense FFN (arctic)
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    group_size: int = 512         # dispatch group (dispatch-FLOP overhead)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # default d_model // n_heads
    mlp: MLPKind = MLPKind.SWIGLU
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # super-block pattern; None -> uniform [default_kind] * 1
    pattern: Optional[tuple[BlockKind, ...]] = None
    default_kind: BlockKind = BlockKind.ATTN
    encoder_only: bool = False            # bidirectional, no decode step
    frontend_stub: bool = False           # inputs are precomputed embeddings
    cross_ctx_len: int = 0                # VLM cross-attention context length
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention implementation knobs
    attn_q_chunk: int = 2048              # query chunking for long prefill
    sliding_window: int = 0               # 0 = full attention
    sub_quadratic: bool = False           # supports long_500k decode
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def block_pattern(self) -> tuple[BlockKind, ...]:
        if self.pattern is not None:
            return self.pattern
        return (self.default_kind,)

    @property
    def n_super_blocks(self) -> int:
        p = len(self.block_pattern)
        if self.n_layers % p:
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of pattern length {p}")
        return self.n_layers // p

    def validate(self) -> None:
        _ = self.n_super_blocks
        if self.moe is not None and not any(
                k in (BlockKind.MOE,) for k in self.block_pattern):
            raise ValueError(f"{self.name}: moe config without MOE blocks")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind in self.block_pattern:
            n = self.n_super_blocks
            if kind in (BlockKind.ATTN, BlockKind.CROSS_ATTN, BlockKind.MOE):
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
                proj = self.n_heads * hd * d
                total += n * (qkv + proj)
                if kind == BlockKind.CROSS_ATTN:
                    total += n * (qkv + proj)
            if kind == BlockKind.ATTN or kind == BlockKind.CROSS_ATTN:
                mult = 3 if self.mlp in (MLPKind.SWIGLU, MLPKind.GEGLU) else 2
                total += n * mult * d * self.d_ff
            if kind == BlockKind.MOE and self.moe is not None:
                m = self.moe
                total += n * (m.n_experts + m.n_shared_experts) * 3 * d * m.expert_d_ff
                if m.dense_residual:
                    total += n * 3 * d * m.dense_d_ff
                total += n * d * m.n_experts
            if kind == BlockKind.MAMBA2 and self.ssm is not None:
                di = self.ssm.expand * d
                total += n * (2 * d * di + d * di + di * self.ssm.d_conv)
            if kind in (BlockKind.SLSTM, BlockKind.MLSTM):
                total += n * 8 * d * d
            if kind == BlockKind.SHARED_ATTN:
                pass  # weight-tied: counted once below
        if BlockKind.SHARED_ATTN in self.block_pattern:
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
            total += qkv + self.n_heads * hd * d + 3 * d * max(self.d_ff, 4 * d)
        return total


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    # configs register on import
    from repro_torch import configs as _  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from repro_torch import configs as _  # noqa: F401
    return sorted(_REGISTRY)
