"""Model-layer primitives (counterpart of ``repro.models.layers``).

Plain functions over dictionaries of tensors, in the reference's layouts
(dense weights ``[d_in, d_out]``, activations ``[B, S, H, hd]``), so weights
carry over from the JAX package as they are (``models.convert``).  Every
``*_init`` draws from an explicit ``torch.Generator`` on the target device.

Two layer functions run the port's CUDA kernels on CUDA tensors:

* ``sdpa_chunked`` (prefill attention) launches ``flash_attention``; a
  single query row (decode) stays plain torch, as in the reference, where
  decode attention is plain XLA ops outside any kernel;
* ``gla_chunked`` (the Mamba-2 SSD scan) launches ``ssd_scan``.

On CPU tensors both take the plain versions.  ``attn_apply`` updates the
KV cache in place where the reference returns an updated copy
(``dynamic_update_slice_in_dim``).  The MoE layer is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import NEG_INF
from repro_torch.kernels.ssd_scan import ssd_scan

Params = dict


def _init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device)
            * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False) -> Params:
    p = {"w": _init_dense(gen, d_in, d_out, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, ``max(x, 0) + log1p(exp(-|x|))`` (torch's
    own is ``log1p(exp(x))`` below its threshold)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s form, ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs              # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, query-chunked for long prefill)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_q: int
    n_kv: int
    hd: int
    bias: bool = False


def attn_init(gen: torch.Generator, dims: AttnDims, dtype) -> Params:
    return {
        "wq": dense_init(gen, dims.d_model, dims.n_q * dims.hd, dtype,
                         dims.bias),
        "wk": dense_init(gen, dims.d_model, dims.n_kv * dims.hd, dtype,
                         dims.bias),
        "wv": dense_init(gen, dims.d_model, dims.n_kv * dims.hd, dtype,
                         dims.bias),
        "wo": dense_init(gen, dims.n_q * dims.hd, dims.d_model, dtype),
    }


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_offset: int = 0, kv_len: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,Hq,hd]; k,v: [B,Skv,Hkv,hd] with Hq = G*Hkv.  Full softmax.

    ``kv_len``: number of valid cache entries; positions beyond are masked.
    ``q_offset``: absolute position of q[0] for causal masking.  The
    probabilities are cast to v's type before the product, as in the
    reference.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1:3]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = None
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        mask = kv_pos[None, :] <= q_pos[:, None]
    if kv_len is not None:
        valid = kv_pos[None, :] < kv_len
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, hd)


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, q_chunk: int, q_offset: int = 0,
                 kv_len: Optional[int] = None) -> torch.Tensor:
    """Attention over query chunks of ``q_chunk`` rows.

    CUDA tensors with more than one query row go to the ``flash_attention``
    kernel in one launch (it tiles the queries itself, so the score memory
    stays on chip); CPU tensors, and the one-row decode step, run
    ``_sdpa`` chunk by chunk as the reference does.
    """
    B, Sq, Hq, hd = q.shape
    if Sq > q_chunk and Sq % q_chunk:
        raise ValueError("seq len must be a multiple of q_chunk")
    if q.is_cuda and Sq > 1:
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    if Sq <= q_chunk:
        return _sdpa(q, k, v, causal, q_offset, kv_len)
    return torch.cat([_sdpa(q[:, i:i + q_chunk], k, v, causal, q_offset + i,
                            kv_len) for i in range(0, Sq, q_chunk)], dim=1)


def attn_apply(p: Params, x: torch.Tensor, dims: AttnDims, *, causal: bool,
               theta: float, positions: torch.Tensor, q_chunk: int = 0,
               cache: Optional[Params] = None,
               cache_index: Optional[int] = None
               ) -> tuple[torch.Tensor, Optional[Params]]:
    """Self-attention with an optional KV cache.

    * prefill/train: ``cache=None`` -> self-attention over x.
    * with ``cache={'k','v'}`` and ``cache_index`` (a Python int): the new
      keys and values are written into the cache in place at
      ``cache_index``, and x attends over the cache up to
      ``cache_index + S``.
    Returns (out, the cache or None).
    """
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, dims.n_q, dims.hd)
    k = dense(p["wk"], x).reshape(B, S, dims.n_kv, dims.hd)
    v = dense(p["wv"], x).reshape(B, S, dims.n_kv, dims.hd)
    if theta > 0:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
        out = sdpa_chunked(q, ck.to(q.dtype), cv.to(q.dtype), causal=causal,
                           q_chunk=q_chunk or S, q_offset=cache_index,
                           kv_len=cache_index + S)
    else:
        out = sdpa_chunked(q, k, v, causal=causal, q_chunk=q_chunk or S)
    out = out.reshape(B, S, dims.n_q * dims.hd)
    return dense(p["wo"], out), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, kind: str,
             dtype) -> Params:
    if kind in ("swiglu", "geglu"):
        return {"wi": dense_init(gen, d, d_ff, dtype),
                "wg": dense_init(gen, d, d_ff, dtype),
                "wo": dense_init(gen, d_ff, d, dtype)}
    return {"wi": dense_init(gen, d, d_ff, dtype),
            "wo": dense_init(gen, d_ff, d, dtype)}


def mlp_apply(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = dense(p["wi"], x)
    if kind == "swiglu":
        h = silu(dense(p["wg"], x)) * h
    elif kind == "geglu":
        h = gelu(dense(p["wg"], x)) * h
    elif kind == "gelu":
        h = gelu(h)
    else:
        raise KeyError(kind)
    return dense(p["wo"], h)


# ---------------------------------------------------------------------------
# MoE: not ported yet
# ---------------------------------------------------------------------------

def moe_init(*args, **kwargs):
    raise NotImplementedError("MoE layers are not ported yet "
                              "(ROADMAP.md, open item 13)")


def moe_apply(*args, **kwargs):
    raise NotImplementedError("MoE layers are not ported yet "
                              "(ROADMAP.md, open item 13)")


# ---------------------------------------------------------------------------
# Gated linear recurrence (Mamba-2 SSD)
# ---------------------------------------------------------------------------

def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked gated linear attention:  o_t = q_t @ S_t,
    S_t = exp(a_t) * S_{t-1} + k_t^T v_t  with per-(position, head) log-decay.

    q,k: [B, L, H, N] (may be broadcast over H); v: [B, L, H, P];
    log_decay: [B, L, H] (<= 0).  Returns o: [B, L, H, P] in v's type.
    CUDA tensors launch the ``ssd_scan`` kernel, CPU tensors run its plain
    version; both carry the state across chunks in order where the
    reference combines chunk states with an associative scan.
    """
    L = q.shape[1]
    c = min(chunk, L)
    if L % c:
        raise ValueError("seq len must divide chunk size")
    return ssd_scan(q, k, v, log_decay.float(), chunk=c)


def gla_step(state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, log_decay: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  state: [B, H, N, P]; q,k: [B,H,N];
    v: [B,H,P]; log_decay: [B,H].  Returns (new_state, out [B,H,P])."""
    decay = torch.exp(log_decay.float())[..., None, None]
    new_state = state * decay + torch.einsum(
        "bhn,bhp->bhnp", k.float(), v.float())
    out = torch.einsum("bhn,bhnp->bhp", q.float(), new_state)
    return new_state, out.to(v.dtype)
