"""Workload IR for SCAR (paper Definitions 1, 4, 5).

A multi-model workload scenario ``Sc`` is a collection of layers from several
models (Definition 1).  Layers are the scheduling granularity: the cost model
(``repro_torch.core.maestro``) evaluates each layer on each chiplet *class* and the
engines partition layers into time windows and segments.

Layers carry either structured dims (CONV / GEMM) from which MACs and operand
sizes are derived, or explicit overrides for fused/irregular ops (e.g. the
attention score+context pair is modelled as one ATTN layer whose MACs are the
sum of both batched GEMMs, matching the 5-layers-per-transformer-block
decomposition implied by the paper's Table III layer counts).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

BYTES_PER_ELEM = 1  # int8 inference accelerator (Simba-style), as in the paper.


class OpType(enum.Enum):
    CONV = "conv"        # 2D convolution (K,C,Y,X,R,S,stride)
    DWCONV = "dwconv"    # depthwise conv (C,Y,X,R,S,stride)
    GEMM = "gemm"        # (B,M,N,K) batched matmul; FC is B=1
    ATTN = "attn"        # fused attention score+context (explicit macs)
    POOL = "pool"        # pooling (no MACs; memory movement only)
    ELEM = "elem"        # elementwise (residual add, norm); memory movement


@dataclasses.dataclass(frozen=True)
class Layer:
    """One schedulable layer (Definition 1's ``layer_{i,j}``)."""

    name: str
    op: OpType
    # CONV dims
    N: int = 1          # batch
    K: int = 1          # output channels
    C: int = 1          # input channels
    Y: int = 1          # output rows
    X: int = 1          # output cols
    R: int = 1          # filter rows
    S: int = 1          # filter cols
    stride: int = 1
    # GEMM dims (B batched): out[M,N] = in[M,Kdim] @ w[Kdim,N]
    B: int = 1
    M: int = 1
    Ndim: int = 1
    Kdim: int = 1
    # Explicit overrides (ATTN and exotic ops)
    macs_override: Optional[int] = None
    in_bytes_override: Optional[int] = None
    w_bytes_override: Optional[int] = None
    out_bytes_override: Optional[int] = None

    # ---- derived quantities -------------------------------------------------
    @property
    def macs(self) -> int:
        if self.macs_override is not None:
            return self.macs_override
        if self.op == OpType.CONV:
            return self.N * self.K * self.C * self.Y * self.X * self.R * self.S
        if self.op == OpType.DWCONV:
            return self.N * self.C * self.Y * self.X * self.R * self.S
        if self.op == OpType.GEMM:
            return self.B * self.M * self.Ndim * self.Kdim
        if self.op in (OpType.POOL, OpType.ELEM):
            return 0
        raise ValueError(f"macs undefined for {self.op}")

    @property
    def weight_bytes(self) -> int:
        if self.w_bytes_override is not None:
            return self.w_bytes_override
        if self.op == OpType.CONV:
            return self.K * self.C * self.R * self.S * BYTES_PER_ELEM
        if self.op == OpType.DWCONV:
            return self.C * self.R * self.S * BYTES_PER_ELEM
        if self.op == OpType.GEMM:
            return self.Kdim * self.Ndim * BYTES_PER_ELEM
        return 0

    @property
    def in_bytes(self) -> int:
        if self.in_bytes_override is not None:
            return self.in_bytes_override
        if self.op in (OpType.CONV, OpType.DWCONV):
            in_y = self.Y * self.stride + self.R - 1
            in_x = self.X * self.stride + self.S - 1
            return self.N * self.C * in_y * in_x * BYTES_PER_ELEM
        if self.op == OpType.GEMM:
            return self.B * self.M * self.Kdim * BYTES_PER_ELEM
        if self.op == OpType.POOL:
            return self.N * self.C * self.Y * self.X * self.stride * self.stride * BYTES_PER_ELEM
        if self.op == OpType.ELEM:
            return self.N * self.C * self.Y * self.X * BYTES_PER_ELEM
        return 0

    @property
    def out_bytes(self) -> int:
        if self.out_bytes_override is not None:
            return self.out_bytes_override
        if self.op in (OpType.CONV, OpType.POOL, OpType.ELEM):
            return self.N * self.K * self.Y * self.X * BYTES_PER_ELEM
        if self.op == OpType.DWCONV:
            return self.N * self.C * self.Y * self.X * BYTES_PER_ELEM
        if self.op == OpType.GEMM:
            return self.B * self.M * self.Ndim * BYTES_PER_ELEM
        return 0

    # Spatial-parallelism extents used by the dataflow model: how much
    # parallelism each dataflow style can exploit on this layer.
    @property
    def par_channels(self) -> int:
        """K*C-style parallelism (NVDLA / weight-stationary affinity)."""
        if self.op == OpType.CONV:
            return self.K * self.C
        if self.op == OpType.DWCONV:
            return self.C
        if self.op in (OpType.GEMM, OpType.ATTN):
            return self.Ndim * min(self.Kdim, 64) * self.B
        return 1

    @property
    def par_spatial(self) -> int:
        """Y*X-style parallelism (Shi-diannao / output-stationary affinity)."""
        if self.op in (OpType.CONV, OpType.DWCONV):
            return self.N * self.Y * self.X
        if self.op in (OpType.GEMM, OpType.ATTN):
            return self.B * self.M
        return 1


@dataclasses.dataclass(frozen=True)
class Model:
    """A model instance in a scenario (batch size folded into its layers)."""

    name: str
    layers: tuple[Layer, ...]
    batch: int = 1

    def __len__(self) -> int:
        return len(self.layers)

    @property
    def total_macs(self) -> int:
        return sum(lyr.macs for lyr in self.layers)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Definition 1: a multi-model workload scenario."""

    name: str
    models: tuple[Model, ...]

    @property
    def n_layers(self) -> int:
        return sum(len(m) for m in self.models)

    def layer_table(self) -> list[tuple[int, int, Layer]]:
        """Flat [(model_idx, layer_idx, layer)] enumeration of Sc."""
        out = []
        for i, m in enumerate(self.models):
            for j, l in enumerate(m.layers):
                out.append((i, j, l))
        return out


# ---------------------------------------------------------------------------
# Layer-graph builders (shared by the paper model zoo and the assigned archs)
# ---------------------------------------------------------------------------

def conv(name: str, N: int, C: int, K: int, Y: int, X: int, R: int = 3,
         S: Optional[int] = None, stride: int = 1) -> Layer:
    return Layer(name=name, op=OpType.CONV, N=N, K=K, C=C, Y=Y, X=X, R=R,
                 S=S if S is not None else R, stride=stride)


def dwconv(name: str, N: int, C: int, Y: int, X: int, R: int = 3,
           stride: int = 1) -> Layer:
    return Layer(name=name, op=OpType.DWCONV, N=N, C=C, K=C, Y=Y, X=X, R=R,
                 S=R, stride=stride)


def gemm(name: str, M: int, N: int, K: int, B: int = 1) -> Layer:
    return Layer(name=name, op=OpType.GEMM, B=B, M=M, Ndim=N, Kdim=K)


def attn_layer(name: str, batch: int, heads: int, sl_q: int, sl_kv: int,
               head_dim: int) -> Layer:
    """Fused score (QK^T) + context (PV) batched GEMMs as one ATTN layer."""
    macs = batch * heads * sl_q * sl_kv * head_dim * 2
    q_bytes = batch * heads * sl_q * head_dim * BYTES_PER_ELEM
    kv_bytes = 2 * batch * heads * sl_kv * head_dim * BYTES_PER_ELEM
    out_bytes = batch * heads * sl_q * head_dim * BYTES_PER_ELEM
    return Layer(name=name, op=OpType.ATTN,
                 B=batch * heads, M=sl_q, Ndim=sl_kv, Kdim=head_dim,
                 macs_override=macs,
                 in_bytes_override=q_bytes + kv_bytes,
                 w_bytes_override=0,
                 out_bytes_override=out_bytes)


def transformer_layers(prefix: str, n_blocks: int, d_model: int, n_heads: int,
                       d_ff: int, seq: int, batch: int,
                       n_kv_heads: Optional[int] = None,
                       head_dim: Optional[int] = None) -> list[Layer]:
    """5 layers per block: QKV, ATTN (fused score+ctx), PROJ, FFN1, FFN2.

    This matches the per-block layer accounting implied by the paper's
    Table III (GPT-L: 24 blocks -> 120 layers, BERT(-L): 12 blocks -> 60).
    """
    n_kv = n_kv_heads if n_kv_heads is not None else n_heads
    hd = head_dim if head_dim is not None else d_model // n_heads
    q_out = n_heads * hd
    kv_out = 2 * n_kv * hd
    layers: list[Layer] = []
    for b in range(n_blocks):
        p = f"{prefix}.b{b}"
        layers.append(gemm(f"{p}.qkv", M=seq, N=q_out + kv_out, K=d_model, B=batch))
        layers.append(attn_layer(f"{p}.attn", batch=batch, heads=n_heads,
                                 sl_q=seq, sl_kv=seq, head_dim=hd))
        layers.append(gemm(f"{p}.proj", M=seq, N=d_model, K=q_out, B=batch))
        layers.append(gemm(f"{p}.ffn1", M=seq, N=d_ff, K=d_model, B=batch))
        layers.append(gemm(f"{p}.ffn2", M=seq, N=d_model, K=d_ff, B=batch))
    return layers
