"""Model-layer primitives (counterpart of ``repro.models.layers``).

Plain functions over dictionaries of tensors, in the reference's layouts
(dense weights ``[d_in, d_out]``, activations ``[B, S, H, hd]``), so weights
carry over from the JAX package as they are (``models.convert``).  Every
``*_init`` draws from an explicit ``torch.Generator`` on the target device.

Under tensor parallelism (``tp``, a ``launch.mesh.Axis``; None at tp =
1) attention, the MLP and the MoE take the rank's shards of their weights
(heads, ``d_ff`` columns, experts) and run between the Megatron
operators of ``distributed.tensor_parallel``: ``copy_to`` on the input of
the column-parallel products, ``reduce_from`` on the row-parallel
output, where the reference's sharding constraint returns to replicated.
Under sequence parallelism (``sp``: the lengths of the ranks' blocks of
the sequence) a layer takes and returns the rank's block: ``gather_seq``
on the input and ``scatter_seq`` on the output take the two operators'
places, and everything between them (RoPE positions, the causal mask,
the MoE router and its dispatch groups) sees the gathered sequence.

Two layer functions run the port's CUDA kernels on CUDA tensors:

* ``sdpa_chunked`` (prefill and training attention) launches
  ``flash_attention``; a single query row (decode) stays plain torch, as in
  the reference, where decode attention is plain XLA ops outside any
  kernel;
* ``gla_chunked`` (the Mamba-2 SSD scan) launches ``ssd_scan``.

On CPU tensors both take the plain versions.  With a gradient required
both go through the kernels' ``autograd.Function``s, whose backward is a
kernel too (``flash_attention_bwd``, ``ssd_scan_bwd``; their plain
versions on the CPU); under ``torch.no_grad`` / ``inference_mode`` they
launch what serving always launched.  ``attn_apply`` updates the
KV cache in place where the reference returns an updated copy
(``dynamic_update_slice_in_dim``).  The MoE layer's expert GEMMs are
plain einsums, as in the reference, where they sit outside any kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import needs_grad
from repro_torch.kernels.flash_attention import attention, flash_attention
from repro_torch.kernels.flash_attention.kernel import NEG_INF
from repro_torch.kernels.ssd_scan import scan, ssd_scan

Params = dict


# The init functions put their leaves on torch's default device, which
# ``init_params`` sets to its own ``device`` while it draws.
def _init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen) * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False) -> Params:
    p = {"w": _init_dense(gen, d_in, d_out, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d: int, dtype) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype)}


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
    ``_sdpa`` chunk by chunk as the reference does.  With a gradient
    required, every call goes through ``FlashAttentionFn`` (on the CPU its
    forward is the plain version and its backward ``attention_bwd_plain``).
    """
    B, Sq, Hq, hd = q.shape
    if Sq > q_chunk and Sq % q_chunk:
        raise ValueError("seq len must be a multiple of q_chunk")
    if needs_grad(q, k, v):
        return attention(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)
    if q.is_cuda and Sq > 1:
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    if Sq <= q_chunk:
        return _sdpa(q, k, v, causal, q_offset, kv_len)
    return torch.cat([_sdpa(q[:, i:i + q_chunk], k, v, causal, q_offset + i,
                            kv_len) for i in range(0, Sq, q_chunk)], dim=1)


def attn_apply(p: Params, x: torch.Tensor, dims: AttnDims, *, causal: bool,
               theta: float, positions: torch.Tensor, q_chunk: int = 0,
               kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
               cache: Optional[Params] = None,
               cache_index: Optional[int] = None, tp=None,
               sp: Optional[tuple] = None
               ) -> tuple[torch.Tensor, Optional[Params]]:
    """Self- or cross-attention with an optional KV cache.

    * prefill/train: ``kv=None, cache=None`` -> self-attention over x.
    * cross-attention: ``kv=(k_ctx, v_ctx)``, the context's keys and values
      already projected (``[B, T, n_kv, hd]``): x attends over all of them
      (``causal`` is not read), with RoPE on q only if ``theta > 0``; no
      cache.
    * with ``cache={'k','v'}`` and ``cache_index`` (a Python int): the new
      keys and values are written into the cache in place at
      ``cache_index``, and x attends over the cache up to
      ``cache_index + S``.
    Returns (out, the cache or None).  Under ``tp``, ``dims`` holds the
    rank's head counts (and ``kv`` its heads); under ``sp`` x and out are
    the rank's block of the sequence, ``positions`` the whole sequence's.
    """
    x = _col_in(x, tp, sp)
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, dims.n_q, dims.hd)
    if kv is not None:
        q = rope(q, positions, theta) if theta > 0 else q
        out = sdpa_chunked(q, *kv, causal=False, q_chunk=q_chunk or S)
        return _row_out(p["wo"], out.reshape(B, S, dims.n_q * dims.hd),
                        tp, sp), None
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
    return _row_out(p["wo"], out, tp, sp), cache


def _tp():
    from repro_torch.distributed import tensor_parallel
    return tensor_parallel


def _col_in(x: torch.Tensor, tp, sp: Optional[tuple]) -> torch.Tensor:
    """The input of column-parallel products: under ``tp`` through
    ``copy_to``, under ``sp`` the whole sequence gathered."""
    if tp is None:
        return x
    return _tp().gather_seq(x, tp, sp) if sp else _tp().copy_to(x, tp)


def _row_sum(y: torch.Tensor, tp, sp: Optional[tuple]) -> torch.Tensor:
    """Partial sums of a row-parallel product added up over ``tp``; under
    ``sp`` only the rank's block of the sequence is kept."""
    if tp is None:
        return y
    return _tp().scatter_seq(y, tp, sp) if sp else _tp().reduce_from(y, tp)


def _row_out(p: Params, h: torch.Tensor, tp,
             sp: Optional[tuple] = None) -> torch.Tensor:
    """A row-parallel product; under ``tp`` the partial sums added up."""
    return _row_sum(dense(p, h), tp, sp)


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


def mlp_apply(p: Params, x: torch.Tensor, kind: str, tp=None,
              sp: Optional[tuple] = None) -> torch.Tensor:
    """The MLP; under ``tp`` on the rank's ``d_ff`` columns (under ``sp``
    over the gathered sequence, returning the rank's block)."""
    return _row_sum(_mlp_partial(p, _col_in(x, tp, sp), kind), tp, sp)


def _mlp_partial(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
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
# MoE: GShard-style grouped one-hot dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int         # experts held (the reference pads to its model
                           # axis; the port at tp=1 holds n_routed)
    n_routed: int          # real (routable) experts
    top_k: int
    d_ff: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 512  # dispatch group (controls dispatch-FLOP overhead)


def moe_init(gen: torch.Generator, dims: MoEDims, dtype) -> Params:
    E, d, f = dims.n_experts, dims.d_model, dims.d_ff
    p = {
        "router": _init_dense(gen, d, dims.n_routed, torch.float32),
        "wi": (torch.randn((E, d, f), generator=gen)
               / math.sqrt(d)).to(dtype),
        "wg": (torch.randn((E, d, f), generator=gen)
               / math.sqrt(d)).to(dtype),
        "wo": (torch.randn((E, f, d), generator=gen)
               / math.sqrt(f)).to(dtype),
    }
    if dims.n_shared:
        p["shared"] = mlp_init(gen, d, dims.n_shared * f, "swiglu", dtype)
    return p


def moe_capacity(dims: MoEDims, g: int) -> int:
    """Slots per expert in a dispatch group of ``g`` tokens: the
    reference's ``ceil(g k / n_routed * capacity_factor)``, rounded up to a
    multiple of 4, at least 4 and at most ``g``."""
    cap = int(math.ceil(g * dims.top_k / dims.n_routed
                        * dims.capacity_factor))
    return max(4, min(cap + (-cap) % 4, g))


def router_top_k(logits: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest float32 router logits of each token and their
    experts, largest first, the lower expert first on a tie (as
    ``jax.lax.top_k``; ``torch.topk`` does not promise it): a stable
    descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: Params, x: torch.Tensor, dims: MoEDims, tp=None,
              sp: Optional[tuple] = None, model_major: bool = False
              ) -> torch.Tensor:
    """Top-k capacity-based MoE over flattened tokens.

    Tokens go in groups of ``group_size``; each group one-hot dispatches
    into per-expert capacity buffers (the GShard einsums), the experts run
    as stacked GEMMs, and results combine back with the routing weights.
    A (token, choice) past its expert's capacity in the group (counted in
    token order, choices in rank order) is dropped: the token falls
    through to the residual for it.  The shared experts see every token.

    Under ``tp`` the router runs whole on every rank (replicated, as in
    the reference); the rank runs its block of the experts (the experts
    over the model axis) or every expert on its ``d_ff`` columns (the FSDP
    layout at a data axis of 1), and its shared experts' columns; the
    partial outputs are added up once.  The routing weights enter the
    rank's share through ``copy_to``, so the router's gradient sums every
    rank's experts.  ``model_major`` (the FSDP arch's
    ``expert_axes="model_major"``) brings the rank's experts whole out of
    the every-expert, ``d_ff``-column layout
    (``tensor_parallel.expert_major``) and runs those.  Under ``sp`` the
    router and the dispatch groups see the gathered sequence; nothing
    passes ``copy_to`` (the gathered input's backward sums the ranks'
    parts, the router's gradient included, which ``reduce_grads`` then
    sums over the ranks).
    """
    if sp:
        x = _tp().gather_seq(x, tp, sp)
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    T = xt.shape[0]
    g = min(dims.group_size, T)
    G = T // g
    if T % g:
        raise ValueError("token count must divide dispatch group size")
    E, k = dims.n_experts, dims.top_k
    cap = moe_capacity(dims, g)

    logits = xt.float() @ p["router"].float()                 # [T, n_routed]
    weights, sel = router_top_k(logits, k)                    # [T, k]
    weights = torch.softmax(weights, dim=-1)

    if tp is not None and not sp:
        xt = _tp().copy_to(xt, tp)
        weights = _tp().copy_to(weights, tp)
    sel_g = sel.reshape(G, g, k)
    w_g = weights.reshape(G, g, k)
    x_g = xt.reshape(G, g, d)

    # position of each (token, choice) within its expert's capacity buffer
    onehot = F.one_hot(sel_g, E).float()                      # [G, g, k, E]
    pos = torch.cumsum(onehot.reshape(G, g * k, E), dim=1).reshape(
        G, g, k, E) * onehot - 1.0
    in_cap = (pos >= 0) & (pos < cap)
    slot_idx = torch.where(in_cap, pos, torch.full_like(pos, -1.0)).long()
    # one_hot of -1 is all zeros (jax.nn.one_hot's rule): one extra class
    slot = F.one_hot(slot_idx + 1, cap + 1)[..., 1:].float()  # [.., E, cap]
    dispatch = (onehot[..., None] * slot).sum(dim=2)          # [G, g, E, cap]
    combine = (w_g[..., None, None] * onehot[..., None] * slot).sum(dim=2)
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if model_major:
        em = _tp().expert_major
        f = dims.d_ff
        wi, wg, wo = em(wi, tp, 2, f), em(wg, tp, 2, f), em(wo, tp, 1, f)
    e_local = wi.shape[0]
    if e_local != E:          # this rank's block of the experts
        lo = tp.rank * e_local
        dispatch = dispatch[:, :, lo:lo + e_local]
        combine = combine[:, :, lo:lo + e_local]

    xs = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), x_g)
    h = torch.einsum("gecd,edf->gecf", xs, wi.to(x.dtype))
    hg = torch.einsum("gecd,edf->gecf", xs, wg.to(x.dtype))
    h = silu(hg) * h
    ys = torch.einsum("gecf,efd->gecd", h, wo.to(x.dtype))
    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), ys)
    out = out.reshape(B, S, d)
    if dims.n_shared:
        out = out + _mlp_partial(p["shared"], xt.reshape(B, S, d),
                                 "swiglu")
    return _row_sum(out, tp, sp)


# ---------------------------------------------------------------------------
# Gated linear recurrence (Mamba-2 SSD)
# ---------------------------------------------------------------------------

def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, chunk: int, norm: bool = False):
    """Chunked gated linear attention:  o_t = q_t @ S_t,
    S_t = exp(a_t) * S_{t-1} + k_t^T v_t  with per-(position, head) log-decay.

    q,k: [B, L, H, N] (may be broadcast over H); v: [B, L, H, P];
    log_decay: [B, L, H] (<= 0).  Returns o: [B, L, H, P] in v's type.
    CUDA tensors launch the ``ssd_scan`` kernel, CPU tensors run its plain
    version; both carry the state across chunks in order where the
    reference combines chunk states with an associative scan.
    ``norm=True`` returns ``(o, den)``, den the normaliser the reference's
    mLSTM takes from a second call with ``v = ones[..., :1]`` ([B, L, H]):
    on CUDA bf16 the one ``ssd_scan`` launch computes both.  With a
    gradient required the call goes through ``SSDScanFn`` (``SSDScanNormFn``
    with the normaliser, its backward given ``(do, dden)``), whose backward
    is ``ssd_scan_bwd`` for N, P <= 64 and ``ssd_wide_bwd`` for wider heads
    or the normaliser; on the card, calls beyond both kernels (bf16 N or P
    over 256 or off multiples of 16, float32 over 128, chunks over 256)
    raise (``kernels.ssd_scan.grad.scan``).
    """
    L = q.shape[1]
    c = min(chunk, L)
    if L % c:
        raise ValueError("seq len must divide chunk size")
    a = log_decay.float()
    if needs_grad(q, k, v, a):
        return scan(q, k, v, a, chunk=c, norm=norm)
    return ssd_scan(q, k, v, a, chunk=c, norm=norm)


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
