"""The ``flash_attention`` CUDA kernel's wrapper and its plain torch version.

Counterpart of the Pallas kernel ``repro/kernels/flash_attention/kernel.py``.
Both functions here compute softmax attention with the model layer's mask
(``repro/models/layers.py::_sdpa``): query row ``i`` sees kv position ``j``
when ``j < kv_len`` and, if causal, ``j <= i + q_offset``.  The TPU kernel
is the case ``q_offset = 0, kv_len = Skv``.  Its oracle
(``flash_attention/ref.py``) aligns the causal mask bottom-right, which
agrees only when ``Sq == Skv``.

Layouts: ``[BH, S, D]`` (the TPU kernel's; query head ``b`` reads kv head
``b // group``) or ``[B, S, H, D]`` (the model's; query head ``h`` reads kv
head ``h // group``).  bf16 or float32 in, the same type out (mixed types:
below).  bf16 runs on the tensor cores (``wgmma``, TMA loads) with float32
sums, softmax and accumulator; it splits the probabilities into two bf16
terms for the product with v, so they keep about 16 bits where ``_sdpa``
casts them to ``v``'s type.  float32 runs on the CUDA cores in float32
throughout.  The plain version computes in float32.

``flash_attention`` launches the kernel for CUDA tensors and takes the
plain version only for tensors on the CPU or ``meta`` (a trace); a CUDA
tensor never falls back.  The kernel reads any batch, head and sequence
strides (last dimension contiguous), so the model's activations and its
KV cache go in as views; for bf16 (TMA) the pointers must be 16-byte
aligned and head_dim and the strides multiples of 8 elements, else the
wrapper raises.

Mixed types (``mixed``): float32 queries over bf16 keys and values, or the
other way round, are what a float32 model's cross-attention over a bf16
context gives (the reference's ``_sdpa`` forms float32 scores and returns
v's type).  Both functions upcast the bf16 side (exact), run in float32,
the kernel on its float32 path, and return v's type.  The probabilities
stay float32 for the product with v where ``_sdpa`` casts them to v's
type, as on the bf16 path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...trace_hooks import plain_device
from .. import needs_grad
from ..build import load_library

__all__ = ["LSE_ROWS", "NEG_INF", "attention_plain", "flash_attention",
           "lse_buffer", "mixed"]

NEG_INF = -1e30                # finite: exp(-inf - -inf) would be NaN
_SMEM_LIMIT = 232448           # dynamic shared memory a block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ERR_TENSOR_MAP = 10000        # the launcher's code for refused TMA maps
LSE_ROWS = 64                  # lse_buffer's rows round up to this


def _as_4d(t: torch.Tensor) -> torch.Tensor:
    """``[BH, S, D]`` as the ``[1, S, BH, D]`` view the kernel reads."""
    return t.unsqueeze(0).transpose(1, 2) if t.dim() == 3 else t


def lse_buffer(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised float32 ``[B, Hq, Sq']`` for the rows' log-sum-exp
    of a call with these queries, ``Sq`` rounded up to ``LSE_ROWS`` (the
    bf16 backward kernel reads it 64 rows at a time)."""
    q4 = _as_4d(q)
    B, Sq, Hq = q4.shape[:3]
    rows = -(-Sq // LSE_ROWS) * LSE_ROWS
    return torch.empty((B, Hq, rows), dtype=torch.float32, device=q.device)


def mixed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether q is float32 over bf16 k and v, or bf16 over float32."""
    return (k.dtype == v.dtype != q.dtype
            and {q.dtype, k.dtype} == {torch.float32, torch.bfloat16})


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of the kernel, in float32, in either layout;
    the output in v's type.  ``lse`` (as in ``flash_attention``) receives
    the rows' log-sum-exp."""
    three = q.dim() == 3
    q4, k4, v4 = _as_4d(q), _as_4d(k), _as_4d(v)
    Sq, Hq, D = q4.shape[1:]
    Skv, Hkv = k4.shape[1:3]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf = q4.float().transpose(1, 2)                          # [B, Hq, Sq, D]
    kf = k4.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v4.float().transpose(1, 2).repeat_interleave(group, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale                  # [B, Hq, Sq, Skv]
    kv_pos = torch.arange(Skv, device=q.device)
    mask = kv_pos[None, :] < (Skv if kv_len is None else kv_len)
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if lse is not None:
        lse[:, :, :Sq] = torch.logsumexp(s, dim=-1)
    out = (torch.softmax(s, dim=-1) @ vf).transpose(1, 2).to(v.dtype)
    return out[0].transpose(0, 1) if three else out


def _check_lse(q: torch.Tensor, lse: torch.Tensor) -> None:
    q4 = _as_4d(q)
    B, Sq, Hq = q4.shape[:3]
    if (lse.dtype != torch.float32 or lse.device != q.device
            or lse.dim() != 3 or tuple(lse.shape[:2]) != (B, Hq)
            or lse.shape[2] < Sq or lse.stride(2) != 1):
        raise ValueError(f"flash_attention: lse {tuple(lse.shape)} "
                         f"{lse.dtype} must be float32 [{B}, {Hq}, >= {Sq}] "
                         "with contiguous rows on q's device")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: int, q_offset: int) -> None:
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                         "[BH, S, D] or [B, S, H, D] with v like k")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want all float32 or all bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    q4, k4 = _as_4d(q), _as_4d(k)
    if q4.shape[0] != k4.shape[0] or q4.shape[3] != k4.shape[3]:
        raise ValueError("flash_attention: batch or head_dim of q and k "
                         "differ")
    if q4.shape[2] % k4.shape[2]:
        raise ValueError(f"flash_attention: {q4.shape[2]} query heads are "
                         f"not a multiple of {k4.shape[2]} kv heads")
    if not 1 <= kv_len or q_offset < 0:
        raise ValueError(f"flash_attention: kv_len {kv_len} must be >= 1 "
                         f"and q_offset {q_offset} >= 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention ``[.., Sq, .., D]`` out: the CUDA kernel on CUDA tensors.

    ``q_offset`` and ``kv_len`` are Python ints (no device read).  ``lse``,
    a float32 ``[B, Hq, >= Sq]`` (``lse_buffer``; the TPU layout is B = 1),
    receives each query row's log-sum-exp of the scaled, masked scores
    (the training forward keeps it for the backward kernel); serving
    passes none, and the kernel then writes nothing more.  Tensors on the
    CPU take ``attention_plain``.  Mixed float32 / bf16 inputs
    (``mixed``) take the float32 path on the upcast inputs and return v's
    type.  ``flash_attention.launches`` counts kernel launches.  Other
    tensors that require grad (with grad mode on) raise
    ``NotImplementedError``: the kernel's output is invisible to autograd,
    and ``grad.attention`` is the differentiable call.
    """
    if mixed(q, k, v):
        return flash_attention(q.float(), k.float(), v.float(),
                               causal=causal, q_offset=q_offset,
                               kv_len=kv_len, sm_scale=sm_scale,
                               lse=lse).to(v.dtype)
    Skv = k.shape[1]
    kv_len = Skv if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len, q_offset)
    if lse is not None:
        _check_lse(q, lse)
    dev = q.device
    if plain_device(q):
        return attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, sm_scale=sm_scale, lse=lse)
    if needs_grad(q, k, v):
        # the kernel's output has no grad_fn: a gradient would be lost
        raise NotImplementedError(
            "flash_attention: the inputs require grad, and the kernel's "
            "output would carry none; call grad.attention (the backward "
            "kernel's autograd.Function) instead")
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {dev}")
    q4, k4, v4 = _as_4d(q), _as_4d(k), _as_4d(v)
    B, Sq, Hq, D = q4.shape
    Hkv = k4.shape[2]
    lib = _lib()
    if D > lib.flash_attention_max_d():
        raise ValueError(f"flash_attention: head_dim {D} > "
                         f"{lib.flash_attention_max_d()}")
    smem = lib.flash_attention_smem_bytes(D, _DTYPES[q.dtype])
    if smem > _SMEM_LIMIT:
        raise ValueError(f"flash_attention: head_dim {D} needs {smem} B "
                         f"of shared memory (limit {_SMEM_LIMIT})")
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension is "
                             "not contiguous")
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or D % 8
                or any(t.stride(i) % 8 for i in range(3))):
            raise ValueError(f"flash_attention: bf16 {name} is loaded by "
                             "TMA, which needs a 16-byte aligned pointer "
                             "and head_dim and strides that are multiples "
                             f"of 8 (head_dim {D}, strides {t.stride()})")
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    o4 = _as_4d(out)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)

    def strides(t):                  # batch, head, sequence (elements)
        return (ctypes.c_longlong * 3)(t.stride(0), t.stride(2), t.stride(1))

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, Sq, Skv, D, strides(q4),
            strides(k4), strides(v4), strides(o4), int(causal),
            int(q_offset), min(Skv, kv_len), float(scale),
            None if lse is None else lse.data_ptr(),
            0 if lse is None else lse.stride(0),
            0 if lse is None else lse.stride(1), stream)
    if err == _ERR_TENSOR_MAP:
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled refused "
                           "the TMA maps of q, k or v")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with typed entry points."""
    global _LIB
    if _LIB is None:
        lib = load_library("flash_attention")
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_longlong)
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, s, s, s, s, i, i, i,
            ctypes.c_float, p, ctypes.c_longlong, ctypes.c_longlong, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        lib.flash_attention_max_d.argtypes = []
        lib.flash_attention_max_d.restype = i
        _LIB = lib
    return _LIB
