"""Gradients of ``flash_attention``: the backward kernel's wrapper, its
plain torch version and the ``autograd.Function`` that joins them to the
forward kernel.

The JAX package has no backward Pallas kernel: it differentiates the model
layer's ``_sdpa`` (``repro/models/layers.py:94``) with ``jax.grad``.  The
port runs its forward kernel on the card, whose output has no ``grad_fn``,
so training needs a backward of its own: ``FlashAttentionFn`` runs the
forward kernel (``kernel.flash_attention``) and, in its backward, the
hand-written ``flash_attention_bwd`` kernel
(``kernels/csrc/flash_attention_bwd.cu``) on CUDA tensors, or
``attention_bwd_plain`` on CPU tensors.  Both compute, per query head, with
the forward's mask, ``_sdpa``'s (query row ``i`` sees kv position ``j``
when ``j < kv_len`` and, if causal, ``j <= i + q_offset``: the training
mask at ``q_offset = 0, kv_len = Skv``, a KV cache's otherwise):

    P   = softmax(q k^T * scale)           (recomputed, float32)
    dV  = P^T dO        dP = dO V^T        delta = rowsum(dO * O)
    dS  = P * (dP - delta)
    dQ  = dS K * scale  dK = dS^T Q * scale

summing dK and dV over the query heads of a GQA group; keys at ``kv_len``
and beyond get zero dK and dV.  The Function saves
q, k, v and o and, for bf16 on the card, the rows' log-sum-exp that the
forward kernel wrote beside o (``lse_buffer``), which the bf16 backward
kernel reads instead of recomputing it; the float32 kernel recomputes it.
Gradients come back in the inputs' type.

``attention`` is what the model layer calls: with a gradient required it
takes the Function, at any ``q_offset`` and ``kv_len``; otherwise it calls
``flash_attention`` exactly as serving always has.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...trace_hooks import plain_device
from .. import aligned16, needs_grad
from ..build import load_library
from .kernel import (_DTYPES, _ERR_TENSOR_MAP, LSE_ROWS, NEG_INF, _as_4d,
                     _check, flash_attention, lse_buffer, mixed)

__all__ = ["FlashAttentionFn", "attention", "attention_bwd_plain",
           "flash_attention_bwd"]


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[int] = None,
                        sm_scale: Optional[float] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the backward kernel, in float32, in either
    layout, under the forward's mask (``attention_plain``'s): ``(dq, dk,
    dv)`` in the inputs' type."""
    q4, k4, v4, o4, do4 = (_as_4d(t) for t in (q, k, v, o, do))
    B, Sq, Hq, D = q4.shape
    Skv, Hkv = k4.shape[1:3]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf, of, dof = (t.float().transpose(1, 2) for t in (q4, o4, do4))
    kf = k4.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v4.float().transpose(1, 2).repeat_interleave(group, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale                  # [B, Hq, Sq, Skv]
    kv_pos = torch.arange(Skv, device=q.device)
    mask = kv_pos[None, :] < (Skv if kv_len is None else kv_len)
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    delta = (dof * of).sum(dim=-1, keepdim=True)             # [B, Hq, Sq, 1]
    dv = p.transpose(-1, -2) @ dof                           # [B, Hq, Skv, D]
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    if group > 1:                         # sum over each group's q heads
        dk = dk.reshape(B, Hkv, group, Skv, D).sum(dim=2)
        dv = dv.reshape(B, Hkv, group, Skv, D).sum(dim=2)
    dq, dk, dv = (t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))
    if q.dim() == 3:
        return tuple(t[0].transpose(0, 1) for t in (dq, dk, dv))
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        lse: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of ``flash_attention``'s output ``o`` under the
    same mask (``q_offset``, ``kv_len``: Python ints, as the forward takes
    them): the CUDA kernel on CUDA tensors, the plain version on the CPU.
    ``lse`` is the forward's ``lse_buffer`` as ``flash_attention(...,
    lse=)`` filled it under that mask; bf16 on the card reads it,
    and without it runs the forward kernel once more to fill one (the
    float32 kernel and the plain version recompute it and ignore it).
    ``flash_attention_bwd.launches`` counts the kernel's launches (one per
    call: the dQ kernel, which also forms delta, then dK / dV)."""
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else min(int(kv_len), Skv)
    q_offset = int(q_offset)
    _check(q, k, v, kv_len, q_offset)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be shaped like q "
                         f"{tuple(q.shape)}")
    dev = q.device
    if plain_device(q):
        return attention_bwd_plain(q, k, v, o, do, causal=causal,
                                   q_offset=q_offset, kv_len=kv_len,
                                   sm_scale=sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {dev}")
    lib = _lib()
    q4, k4, v4, o4, do4 = (_as_4d(t.contiguous() if t.stride(-1) != 1
                                  else t) for t in (q, k, v, o, do))
    B, Sq, Hq, D = q4.shape
    Hkv = k4.shape[2]
    if D % 8 or D > lib.flash_attention_bwd_max_d():
        raise ValueError(f"flash_attention_bwd: head_dim {D} must be a "
                         "multiple of 8 up to "
                         f"{lib.flash_attention_bwd_max_d()}")
    ld = 0
    if q.dtype == torch.bfloat16:
        q4, k4, v4, o4, do4 = (aligned16(t) for t in (q4, k4, v4, o4, do4))
        ld = -(-Sq // LSE_ROWS) * LSE_ROWS
        if lse is None:
            lse = lse_buffer(q)
            with torch.no_grad():
                flash_attention(q.detach(), k.detach(), v.detach(),
                                causal=causal, q_offset=q_offset,
                                kv_len=kv_len, sm_scale=sm_scale, lse=lse)
        elif (lse.dtype != torch.float32 or lse.device != dev
              or tuple(lse.shape) != (B, Hq, ld)
              or not lse.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                             f"{lse.dtype} is not the forward's lse_buffer "
                             f"(float32 [{B}, {Hq}, {ld}], contiguous)")
        stats = torch.empty((B, Hq, ld), dtype=torch.float32, device=dev)
    else:
        lse = None
        stats = torch.empty((2, B, Hq, Sq), dtype=torch.float32, device=dev)
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    def strides(t):                  # batch, head, sequence (elements)
        return (ctypes.c_longlong * 3)(t.stride(0), t.stride(2), t.stride(1))

    tensors = (q4, k4, v4, o4, do4, _as_4d(dq), _as_4d(dk), _as_4d(dv))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in tensors), stats.data_ptr(),
            None if lse is None else lse.data_ptr(), ld,
            _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D,
            *(strides(t) for t in tensors), int(causal), q_offset, kv_len,
            float(scale), stream)
    if err == _ERR_TENSOR_MAP:
        raise RuntimeError("flash_attention_bwd: cuTensorMapEncodeTiled "
                           "refused the TMA maps of q, k, v or dO")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward kernel, under one mask
    (``q_offset``, ``kv_len``) in both.  Saves q, k, v and o, and for bf16
    off the CPU the forward's row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float],
                q_offset: int = 0, kv_len: Optional[int] = None):
        lse = (lse_buffer(q) if q.dtype == torch.bfloat16
               and not plain_device(q) else None)
        o = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len, sm_scale=sm_scale, lse=lse)
        ctx.save_for_backward(q, k, v, o)
        ctx.lse = lse
        ctx.mask = (causal, q_offset, kv_len)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, q_offset, kv_len = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                         q_offset=q_offset, kv_len=kv_len,
                                         sm_scale=ctx.sm_scale, lse=ctx.lse)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              kv_len: Optional[int] = None,
              sm_scale: Optional[float] = None) -> torch.Tensor:
    """``flash_attention`` that autograd can differentiate.

    With a gradient required the call goes through ``FlashAttentionFn``
    (the backward kernel on the card, its plain version on the CPU) under
    the same mask: the training one, or a KV cache's ``q_offset`` and
    ``kv_len``.  Without one it is ``flash_attention`` itself, launch for
    launch.  Mixed float32 / bf16 inputs go through the Function upcast to
    float32, the output cast to v's type.
    """
    if not needs_grad(q, k, v):
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, sm_scale=sm_scale)
    if mixed(q, k, v):         # the casts' backward rounds each gradient
        return FlashAttentionFn.apply(q.float(), k.float(), v.float(),
                                      causal, sm_scale, q_offset,
                                      kv_len).to(v.dtype)
    return FlashAttentionFn.apply(q, k, v, causal, sm_scale, q_offset,
                                  kv_len)


_LIB = None


def _lib() -> ctypes.CDLL:
    """The backward kernel's library, built at first use."""
    global _LIB
    if _LIB is None:
        lib = load_library("flash_attention_bwd")
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_longlong)
        lib.flash_attention_bwd_launch.argtypes = (
            [p] * 10 + [i] * 8 + [s] * 8 + [i, i, i, ctypes.c_float, p])
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_bwd_max_d.argtypes = []
        lib.flash_attention_bwd_max_d.restype = i
        _LIB = lib
    return _LIB
