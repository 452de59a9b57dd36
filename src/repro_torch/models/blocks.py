"""Block-level init/apply and cache initialisation (counterpart of
``repro.models.blocks``).

Blocks are uniform functions ``apply(params, x, ctx, cache) -> (y, cache)``.
Ported: ``ATTN``, ``SHARED_ATTN`` (the weight-tied attention block of
zamba2, whose weights live at the model level) and ``MAMBA2``.  ``MOE``,
``MLSTM``, ``SLSTM`` and ``CROSS_ATTN`` raise ``NotImplementedError`` when a
model holding them is built (ROADMAP.md, open item 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.scar_eval.kernel import blocked_cumsum
from .config import ArchConfig, BlockKind, MLPKind
from .layers import (AttnDims, attn_apply, attn_init, dense, dense_init,
                     gla_chunked, gla_step, mlp_apply, mlp_init, rmsnorm,
                     rmsnorm_init, silu, softplus)

Params = dict

NOT_PORTED = (BlockKind.MOE, BlockKind.MLSTM, BlockKind.SLSTM,
              BlockKind.CROSS_ATTN)


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    """Per-call context threaded through blocks."""
    cfg: ArchConfig
    mode: str                         # "full" (prefill) | "decode"
    positions: torch.Tensor           # [B, S] or [1, S]
    cache_index: Optional[int] = None  # first cache position written
    n_q_pad: int = 0
    n_kv_pad: int = 0
    max_cache_len: int = 0


def _not_ported(kind: BlockKind):
    return NotImplementedError(
        f"block kind {kind.value!r} is not ported yet (ROADMAP.md, open "
        "item 13: MoE, xLSTM and cross-attention blocks)")


def _attn_dims(cfg: ArchConfig, ctx: BlockCtx) -> AttnDims:
    return AttnDims(d_model=cfg.d_model, n_q=ctx.n_q_pad, n_kv=ctx.n_kv_pad,
                    hd=cfg.hd, bias=cfg.qkv_bias)


# ---------------------------------------------------------------------------
# ATTN (and SHARED_ATTN, which applies the model's shared ATTN weights)
# ---------------------------------------------------------------------------

def attn_block_init(gen: torch.Generator, cfg: ArchConfig, ctx: BlockCtx,
                    dtype) -> Params:
    dev = gen.device
    p: Params = {
        "ln1": rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": attn_init(gen, _attn_dims(cfg, ctx), dtype),
        "ln2": rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if cfg.mlp != MLPKind.NONE:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp.value, dtype)
    return p


def attn_block_apply(p: Params, x: torch.Tensor, ctx: BlockCtx,
                     cache: Optional[Params]
                     ) -> tuple[torch.Tensor, Optional[Params]]:
    cfg = ctx.cfg
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    self_cache = cache.get("self") if cache else None
    out, new_self = attn_apply(
        p["attn"], h, _attn_dims(cfg, ctx), causal=not cfg.encoder_only,
        theta=cfg.rope_theta, positions=ctx.positions,
        q_chunk=cfg.attn_q_chunk, cache=self_cache,
        cache_index=ctx.cache_index)
    x = x + out
    new_cache = {"self": new_self} if new_self is not None else None
    if cfg.mlp != MLPKind.NONE:
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                          cfg.mlp.value)
    return x, new_cache


def attn_block_cache(cfg: ArchConfig, ctx: BlockCtx, batch: int, dtype,
                     device) -> Params:
    shape = (batch, ctx.max_cache_len, ctx.n_kv_pad, cfg.hd)
    return {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}


# ---------------------------------------------------------------------------
# MAMBA2 (SSD)
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.d_state, s.head_dim, s.d_conv


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    d_inner, H, N, P, K = _mamba_dims(cfg)
    d = cfg.d_model
    dev = gen.device
    conv_dim = d_inner + 2 * N
    return {
        "ln": rmsnorm_init(d, dtype, dev),
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * N + H, dtype),
        "conv_w": (torch.randn((K, conv_dim), generator=gen, device=dev)
                   / math.sqrt(K)).to(dtype),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_inner, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d: x [B, L, C], w [K, C].

    K shifted products, as the reference writes it: no cuDNN convolution
    (which would run a float32 convolution in TF32 on the card).
    """
    K = w.shape[0]
    L = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + L, :] * w[i][None, None, :].to(x.dtype)
               for i in range(K))


def mamba2_apply(p: Params, x: torch.Tensor, ctx: BlockCtx,
                 cache: Optional[Params]
                 ) -> tuple[torch.Tensor, Optional[Params]]:
    cfg = ctx.cfg
    d_inner, H, N, P, K = _mamba_dims(cfg)
    Bsz, L, _ = x.shape
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    zxbcdt = dense(p["in_proj"], h)
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, H],
                                     dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    new_cache: Optional[Params] = None
    decode = ctx.mode == "decode" and cache is not None
    if decode:
        window = torch.cat([cache["conv"], conv_in], dim=1)       # [B,K,C]
        conv = (window * p["conv_w"].to(x.dtype)[None]).sum(dim=1,
                                                            keepdim=True)
        new_conv = window[:, 1:, :]
    else:
        conv = _causal_conv(conv_in, p["conv_w"])
        new_conv = conv_in[:, -(K - 1):, :] if cache is not None else None
    conv = silu(conv)
    xin, Bc, Cc = torch.split(conv, [d_inner, N, N], dim=-1)

    dt = softplus(dt.float() + p["dt_bias"])                       # [B,L,H]
    A = -torch.exp(p["A_log"])                                     # [H] < 0
    log_decay = dt * A[None, None, :]
    xh = xin.reshape(Bsz, L, H, P)
    v = xh * dt[..., None].to(xh.dtype)                            # fold dt
    k = Bc[:, :, None, :].expand(Bsz, L, H, N)    # broadcast, no copy
    q = Cc[:, :, None, :].expand(Bsz, L, H, N)

    if decode:
        new_state, out = gla_step(cache["state"], q[:, 0], k[:, 0], v[:, 0],
                                  log_decay[:, 0])
        y = out[:, None]
        new_cache = {"state": new_state, "conv": new_conv}
    else:
        y = gla_chunked(q, k, v, log_decay, cfg.ssm.chunk)
        if cache is not None:
            # final state for the decode handoff (prefill): one more sum,
            # with the reference's association of the prefix sums
            cum = blocked_cumsum(log_decay.movedim(1, 0)).movedim(0, 1)
            tail = torch.exp(cum[:, -1:, :] - cum)
            state = torch.einsum("blhn,blhp->bhnp",
                                 k.float() * tail[..., None], v.float())
            new_cache = {"state": state, "conv": new_conv}
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, L, d_inner) * silu(z)
    return x + dense(p["out_proj"], y), new_cache


def mamba2_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    d_inner, H, N, P, K = _mamba_dims(cfg)
    return {"state": torch.zeros((batch, H, N, P), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, K - 1, d_inner + 2 * N), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# dispatch tables
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ArchConfig, ctx: BlockCtx, dtype,
               kind: BlockKind) -> Params:
    if kind == BlockKind.ATTN:
        return attn_block_init(gen, cfg, ctx, dtype)
    if kind == BlockKind.MAMBA2:
        return mamba2_init(gen, cfg, dtype)
    if kind == BlockKind.SHARED_ATTN:
        return {}  # weight-tied; params live at model level
    if kind in NOT_PORTED:
        raise _not_ported(kind)
    raise KeyError(kind)


def block_apply(p: Params, x: torch.Tensor, ctx: BlockCtx,
                cache: Optional[Params], kind: BlockKind,
                shared: Optional[Params] = None
                ) -> tuple[torch.Tensor, Optional[Params]]:
    if kind == BlockKind.ATTN:
        return attn_block_apply(p, x, ctx, cache)
    if kind == BlockKind.SHARED_ATTN:
        return attn_block_apply(shared, x, ctx, cache)
    if kind == BlockKind.MAMBA2:
        return mamba2_apply(p, x, ctx, cache)
    if kind in NOT_PORTED:
        raise _not_ported(kind)
    raise KeyError(kind)


def block_cache(cfg: ArchConfig, ctx: BlockCtx, batch: int, dtype,
                kind: BlockKind, device) -> Params:
    if kind in (BlockKind.ATTN, BlockKind.SHARED_ATTN):
        return attn_block_cache(cfg, ctx, batch, dtype, device)
    if kind == BlockKind.MAMBA2:
        return mamba2_cache(cfg, batch, dtype, device)
    if kind in NOT_PORTED:
        raise _not_ported(kind)
    raise KeyError(kind)
