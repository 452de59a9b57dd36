"""Block-level init/apply and cache initialisation (counterpart of
``repro.models.blocks``).

Blocks are uniform functions ``apply(params, x, ctx, cache) -> (y, cache)``.
Every block kind of the reference: ``ATTN``, ``MOE`` (attention + the MoE
layer, with arctic's parallel dense residual), ``CROSS_ATTN`` (attention,
then a tanh-gated attention over the VLM's context ``ctx.cross_ctx``, then
the MLP), ``SHARED_ATTN`` (the weight-tied attention block of zamba2,
whose weights live at the model level), ``MAMBA2`` and xLSTM's ``MLSTM``
and ``SLSTM``.

The sLSTM recurrence is a ``lax.scan`` over positions in the reference,
with no kernel; here it is one ``slstm`` kernel launch over the sequence
on the card (``kernels/slstm``), its plain loop on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels.scar_eval.kernel import blocked_cumsum
from repro_torch.kernels.slstm import scan as slstm_scan
from .config import ArchConfig, BlockKind, MLPKind
from .layers import (AttnDims, MoEDims, attn_apply, attn_init, dense,
                     dense_init, gla_chunked, gla_step, mlp_apply, mlp_init,
                     moe_apply, moe_init, rmsnorm, rmsnorm_init, silu,
                     softplus)

Params = dict

NOT_PORTED = ()          # every block kind of the reference is ported


@dataclasses.dataclass(frozen=True)
class BlockCtx:
    """Per-call context threaded through blocks."""
    cfg: ArchConfig
    mode: str                         # "full" (prefill) | "decode"
    positions: torch.Tensor           # [B, S] or [1, S]
    cache_index: Optional[int] = None  # first cache position written
    cross_ctx: Optional[torch.Tensor] = None   # [B, Tctx, d] (VLM)
    n_q_pad: int = 0
    n_kv_pad: int = 0
    expert_pad: int = 1
    max_cache_len: int = 0
    # the tensor-parallel axis (``launch.mesh.Axis``) at tp > 1: the
    # counts above are then the rank's, its weights the rank's shards
    tp: Optional[object] = None
    # an FSDP arch's data axis above 1 (``tensor_parallel.FSDP``): the
    # stack gathers each super-block's weights over it before it runs
    fsdp: Optional[object] = None


def _attn_dims(cfg: ArchConfig, ctx: BlockCtx) -> AttnDims:
    return AttnDims(d_model=cfg.d_model, n_q=ctx.n_q_pad, n_kv=ctx.n_kv_pad,
                    hd=cfg.hd, bias=cfg.qkv_bias)


def _moe_dims(cfg: ArchConfig, ctx: BlockCtx) -> MoEDims:
    m = cfg.moe
    return MoEDims(d_model=cfg.d_model, n_experts=ctx.expert_pad,
                   n_routed=m.n_experts, top_k=m.top_k, d_ff=m.expert_d_ff,
                   n_shared=m.n_shared_experts,
                   capacity_factor=m.capacity_factor,
                   group_size=m.group_size)


# ---------------------------------------------------------------------------
# ATTN / MOE / CROSS_ATTN (and SHARED_ATTN, which applies the model's shared
# ATTN weights)
# ---------------------------------------------------------------------------

def attn_block_init(gen: torch.Generator, cfg: ArchConfig, ctx: BlockCtx,
                    dtype, kind: BlockKind = BlockKind.ATTN) -> Params:
    p: Params = {
        "ln1": rmsnorm_init(cfg.d_model, dtype),
        "attn": attn_init(gen, _attn_dims(cfg, ctx), dtype),
        "ln2": rmsnorm_init(cfg.d_model, dtype),
    }
    if kind == BlockKind.MOE:
        p["moe"] = moe_init(gen, _moe_dims(cfg, ctx), dtype)
        if cfg.moe.dense_residual:
            p["dense_mlp"] = mlp_init(gen, cfg.d_model, cfg.moe.dense_d_ff,
                                      "swiglu", dtype)
    elif cfg.mlp != MLPKind.NONE:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp.value, dtype)
    if kind == BlockKind.CROSS_ATTN:
        p["ln_x"] = rmsnorm_init(cfg.d_model, dtype)
        p["xattn"] = attn_init(gen, _attn_dims(cfg, ctx), dtype)
        # float32 whatever the model's type; tanh(0) = 0: at init the cross
        # branch adds nothing, as in the reference
        p["xgate"] = torch.zeros((), dtype=torch.float32)
    return p


def attn_block_apply(p: Params, x: torch.Tensor, ctx: BlockCtx,
                     cache: Optional[Params],
                     kind: BlockKind = BlockKind.ATTN
                     ) -> tuple[torch.Tensor, Optional[Params]]:
    cfg = ctx.cfg
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    self_cache = cache.get("self") if cache else None
    out, new_self = attn_apply(
        p["attn"], h, _attn_dims(cfg, ctx), causal=not cfg.encoder_only,
        theta=cfg.rope_theta, positions=ctx.positions,
        q_chunk=cfg.attn_q_chunk, cache=self_cache,
        cache_index=ctx.cache_index, tp=ctx.tp)
    x = x + out
    new_cache = {"self": new_self} if new_self is not None else None
    if kind == BlockKind.CROSS_ATTN:
        x = _cross_attn(p, x, ctx, cache, new_cache)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind == BlockKind.MOE:
        y = moe_apply(p["moe"], h, _moe_dims(cfg, ctx), tp=ctx.tp)
        if cfg.moe.dense_residual:
            y = y + mlp_apply(p["dense_mlp"], h, "swiglu", tp=ctx.tp)
        x = x + y
    elif cfg.mlp != MLPKind.NONE:
        x = x + mlp_apply(p["mlp"], h, cfg.mlp.value, tp=ctx.tp)
    return x, new_cache


def _cross_attn(p: Params, x: torch.Tensor, ctx: BlockCtx,
                cache: Optional[Params], new_cache: Optional[Params]
                ) -> torch.Tensor:
    """The cross block's gated attention over the context: ``x +
    tanh(xgate) * attn(ln_x(x), K, V)``, non-causal, no RoPE.  K and V are
    the context projected by ``xattn``'s ``wk`` / ``wv`` (prefill), or, in
    decode, ``cache["cross"]`` as prefill left it.  A call that returns a
    cache (``new_cache``) stores the projections there as they come, in
    their own type: a bf16 context gives a bf16 cross cache in a float32
    model, as the reference's does.

    Raises ``TypeError`` where the branch's output would promote the
    residual stream (a bf16 model given a float32 context): the
    reference's ``lax.scan`` over super-blocks refuses a carry whose type
    changes, and a Python loop would carry on in float32 instead."""
    cfg = ctx.cfg
    dims = _attn_dims(cfg, ctx)
    h = rmsnorm(p["ln_x"], x, cfg.norm_eps)
    if ctx.mode == "decode" and cache is not None and "cross" in cache:
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
    else:
        if ctx.cross_ctx is None:
            raise ValueError(f"{cfg.name}: a cross-attention block needs "
                             "the batch's cross_ctx [B, Tctx, d_model]")
        B, T, _ = ctx.cross_ctx.shape
        ck = dense(p["xattn"]["wk"], ctx.cross_ctx).reshape(B, T, dims.n_kv,
                                                            dims.hd)
        cv = dense(p["xattn"]["wv"], ctx.cross_ctx).reshape(B, T, dims.n_kv,
                                                            dims.hd)
    xout, _ = attn_apply(p["xattn"], h, dims, causal=False, theta=0.0,
                         positions=ctx.positions, q_chunk=cfg.attn_q_chunk,
                         kv=(ck, cv), tp=ctx.tp)
    promoted = torch.promote_types(x.dtype, xout.dtype)
    if promoted != x.dtype:
        raise TypeError(
            f"{cfg.name}: the cross-attention branch is {xout.dtype} (the "
            f"context's type) and would turn the {x.dtype} residual stream "
            f"into {promoted}; the reference's scan refuses this carry too")
    if new_cache is not None:
        new_cache["cross"] = {"k": ck, "v": cv}
    # the gate times the branch in x's type: torch would round a 0-dim
    # float32 gate times a bf16 branch to bf16, JAX promotes to float32
    return x + torch.tanh(p["xgate"]).to(x.dtype) * xout.to(x.dtype)


def attn_block_cache(cfg: ArchConfig, ctx: BlockCtx, batch: int, dtype,
                     device, kind: BlockKind) -> Params:
    """Zeroed caches: ``self`` of ``max_cache_len`` positions, and for a
    cross block ``cross`` of the context's length (prefill replaces it
    with the projections themselves)."""
    def zeros(length):
        shape = (batch, length, ctx.n_kv_pad, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    c = {"self": zeros(ctx.max_cache_len)}
    if kind == BlockKind.CROSS_ATTN:
        c["cross"] = zeros(cfg.cross_ctx_len)
    return c


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
    conv_dim = d_inner + 2 * N
    return {
        "ln": rmsnorm_init(d, dtype),
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * N + H, dtype),
        "conv_w": (torch.randn((K, conv_dim), generator=gen)
                   / math.sqrt(K)).to(dtype),
        "A_log": torch.zeros((H,), dtype=torch.float32),
        "D": torch.ones((H,), dtype=torch.float32),
        "dt_bias": torch.zeros((H,), dtype=torch.float32),
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
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

def _chunk_of(cfg: ArchConfig) -> int:
    return cfg.ssm.chunk if cfg.ssm else 256


def mlstm_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    d = cfg.d_model
    return {
        "ln": rmsnorm_init(d, dtype),
        "wq": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wif": dense_init(gen, d, 2 * cfg.n_heads, dtype, bias=True),
        "wo_gate": dense_init(gen, d, d, dtype),
        "out": dense_init(gen, d, d, dtype),
    }


def mlstm_apply(p: Params, x: torch.Tensor, ctx: BlockCtx,
                cache: Optional[Params]
                ) -> tuple[torch.Tensor, Optional[Params]]:
    """The matrix-memory cell: gated linear attention with input gate
    ``exp(min(i, 8))`` folded into k, forget gate ``log sigmoid(f)`` as
    the log-decay, and the output divided by ``max(|q . n|, 1)``, n the
    normaliser state (the scan of ``v = 1``).  Prefill takes numerator and
    normaliser from ``gla_chunked(..., norm=True)`` (one ``ssd_scan``
    launch on the card; with a gradient, ``ssd_wide_bwd`` in the
    backward); decode steps the state with ``gla_step``."""
    cfg = ctx.cfg
    B, L, d = x.shape
    H = cfg.n_heads
    P = d // H
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    q = dense(p["wq"], h).reshape(B, L, H, P) / math.sqrt(P)
    k = dense(p["wk"], h).reshape(B, L, H, P)
    v = dense(p["wv"], h).reshape(B, L, H, P)
    gif = dense(p["wif"], h).float()
    i_gate, f_gate = torch.split(gif, H, dim=-1)                 # [B,L,H]
    log_f = -softplus(-f_gate)                                   # log sigmoid
    i_w = torch.exp(torch.clamp_max(i_gate, 8.0))
    k_in = k * i_w[..., None].to(k.dtype)
    new_cache: Optional[Params] = None
    if ctx.mode == "decode" and cache is not None:
        state2, out = gla_step(cache["state"], q[:, 0], k_in[:, 0], v[:, 0],
                               log_f[:, 0])
        nstate2 = cache["norm"] * torch.exp(log_f[:, 0])[..., None] + \
            k_in[:, 0].float()
        denom = torch.einsum("bhn,bhn->bh", q[:, 0].float(), nstate2).abs()
        out = out / torch.clamp_min(denom, 1.0)[..., None].to(out.dtype)
        y = out[:, None]
        new_cache = {"state": state2, "norm": nstate2}
    else:
        num, den = gla_chunked(q, k_in, v, log_f, _chunk_of(cfg), norm=True)
        y = num / torch.clamp_min(den.abs(), 1.0)[..., None]
        if cache is not None:
            # final states for the decode handoff, with the reference's
            # association of the prefix sums
            cum = blocked_cumsum(log_f.movedim(1, 0)).movedim(0, 1)
            tail = torch.exp(cum[:, -1:, :] - cum)
            kf = k_in.float() * tail[..., None]
            state = torch.einsum("blhn,blhp->bhnp", kf, v.float())
            new_cache = {"state": state, "norm": kf.sum(dim=1)}
    y = y.reshape(B, L, d) * silu(dense(p["wo_gate"], h))
    return x + dense(p["out"], y), new_cache


def mlstm_cache(cfg: ArchConfig, batch: int, device) -> Params:
    H = cfg.n_heads
    P = cfg.d_model // H
    return {"state": torch.zeros((batch, H, P, P), dtype=torch.float32,
                                 device=device),
            "norm": torch.zeros((batch, H, P), dtype=torch.float32,
                                device=device)}


def slstm_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "ln": rmsnorm_init(d, dtype),
        "wx": dense_init(gen, d, 4 * d, dtype, bias=True),
        "r": (torch.randn((H, dh, 4 * dh), generator=gen)
              / math.sqrt(dh)).to(dtype),
        "out": dense_init(gen, d, d, dtype),
    }


def slstm_apply(p: Params, x: torch.Tensor, ctx: BlockCtx,
                cache: Optional[Params]
                ) -> tuple[torch.Tensor, Optional[Params]]:
    """The scalar-memory cell with exponential gating and its stabiliser
    m over every position (the reference's ``lax.scan`` of
    ``_slstm_cell``): one ``slstm`` kernel launch on the card for a
    prefill, a decode step (L = 1, the cache's carry in and out) or a
    training forward (``kernels.slstm.scan``, with the backward kernel
    when a gradient is required); the plain loop on the CPU."""
    cfg = ctx.cfg
    B, L, d = x.shape
    H = cfg.n_heads
    dh = d // H
    h_in = rmsnorm(p["ln"], x, cfg.norm_eps)
    gx = dense(p["wx"], h_in).reshape(B, L, H, 4 * dh)
    if cache is not None and ctx.mode == "decode":
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        zeros = torch.zeros((B, H, dh), dtype=torch.float32,
                            device=x.device)
        carry = (zeros, zeros, zeros.to(x.dtype), zeros)
    r = p["r"].to(carry[2].dtype)
    ys, carry = slstm_scan(gx, r, carry)
    new_cache = None
    if cache is not None:
        c, n, h, m = carry
        new_cache = {"c": c, "n": n, "h": h, "m": m}
    y = dense(p["out"], ys.reshape(B, L, d))
    return x + y, new_cache


def slstm_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.to(dtype), "m": z.clone()}


# ---------------------------------------------------------------------------
# dispatch tables
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ArchConfig, ctx: BlockCtx, dtype,
               kind: BlockKind) -> Params:
    if kind in (BlockKind.ATTN, BlockKind.MOE, BlockKind.CROSS_ATTN):
        return attn_block_init(gen, cfg, ctx, dtype, kind)
    if kind == BlockKind.MAMBA2:
        return mamba2_init(gen, cfg, dtype)
    if kind == BlockKind.MLSTM:
        return mlstm_init(gen, cfg, dtype)
    if kind == BlockKind.SLSTM:
        return slstm_init(gen, cfg, dtype)
    if kind == BlockKind.SHARED_ATTN:
        return {}  # weight-tied; params live at model level
    raise KeyError(kind)


def block_apply(p: Params, x: torch.Tensor, ctx: BlockCtx,
                cache: Optional[Params], kind: BlockKind,
                shared: Optional[Params] = None
                ) -> tuple[torch.Tensor, Optional[Params]]:
    if kind in (BlockKind.ATTN, BlockKind.MOE, BlockKind.CROSS_ATTN):
        return attn_block_apply(p, x, ctx, cache, kind)
    if kind == BlockKind.SHARED_ATTN:
        return attn_block_apply(shared, x, ctx, cache)
    if kind == BlockKind.MAMBA2:
        return mamba2_apply(p, x, ctx, cache)
    if kind == BlockKind.MLSTM:
        return mlstm_apply(p, x, ctx, cache)
    if kind == BlockKind.SLSTM:
        return slstm_apply(p, x, ctx, cache)
    raise KeyError(kind)


def block_cache(cfg: ArchConfig, ctx: BlockCtx, batch: int, dtype,
                kind: BlockKind, device) -> Params:
    if kind in (BlockKind.ATTN, BlockKind.MOE, BlockKind.CROSS_ATTN,
                BlockKind.SHARED_ATTN):
        return attn_block_cache(cfg, ctx, batch, dtype, device, kind)
    if kind == BlockKind.MAMBA2:
        return mamba2_cache(cfg, batch, dtype, device)
    if kind == BlockKind.MLSTM:
        return mlstm_cache(cfg, batch, device)
    if kind == BlockKind.SLSTM:
        return slstm_cache(cfg, batch, dtype, device)
    raise KeyError(kind)
