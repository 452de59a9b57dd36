"""Gradients of ``ssd_scan``: the backward kernel's wrapper, its plain torch
version and the ``autograd.Function`` that joins them to the forward
kernel.

The JAX package has no backward Pallas kernel: it differentiates the model
layer's ``gla_chunked`` (``repro/models/layers.py:314``) with ``jax.grad``.
The port runs its forward kernel on the card, whose output has no
``grad_fn``, so training needs a backward of its own: ``SSDScanFn`` runs
the forward kernel (``kernel.ssd_scan``) and, in its backward, the
hand-written ``ssd_scan_bwd`` kernel (``kernels/csrc/ssd_scan_bwd.cu``) on
CUDA tensors, or ``ssd_scan_bwd_plain`` on CPU tensors.  Both compute, for
``o_t = q_t S_t`` with ``S_t = exp(a_t) S_{t-1} + k_t^T v_t`` in chunks
(the in-chunk gates in ``blocked_cumsum``'s association, as the forward):

* the states entering each chunk, forward, and the gradient of the state
  leaving each chunk, carried backward chunk by chunk;
* dq, dk, dv: the in-chunk quadratic terms plus the state terms;
* da, the reverse cumulative sum over the whole sequence of
  ``q_t . dq_t - k_t . dk_t``.

dq and dk come back per head, shaped like the q and k the call was given.
Mamba-2 hands in q and k broadcast over heads (an ``expand``, head stride
0): autograd's ``expand`` backward then sums the per-head gradients over
the heads.  Gradients come back in the inputs' type (da in float32).  The
Function saves q, k, v and a.

Heads wider than 64 (xLSTM's mLSTM, N = P = 256) and the normaliser the
mLSTM divides by go to the second backward kernel, ``ssd_wide_bwd``
(``kernels/csrc/ssd_wide_bwd.cu``): the normaliser is the scan of ``v =
1``, so its gradient is that of one more column of v, all ones, whose
output gradient is ``dden``; dq, dk and da take it in with the other
columns and dv of that column is dropped.  The bf16 kernels take it as a
rank-1 term instead: dden added to the score tile, and the N-vectors n
(the scan of the decayed k) and dn (of the decayed q times dden) carried
beside the states.  ``ssd_scan_bwd`` routes a call
to it (``ssd_scan_bwd.launches`` counts the narrow kernel,
``ssd_wide_bwd.launches`` the wide one); ``SSDScanNormFn`` is the
normalised scan's ``autograd.Function`` (backward ``(do, dden)``).

``scan`` is what the model layer calls: with a gradient required it takes
``SSDScanFn`` (or ``SSDScanNormFn`` with the normaliser) where the backward
kernels cover the call (bf16: N, P <= 256, multiples of 16; float32: N, P
<= 128; chunks up to 256 rows); on the card anything else raises
``NotImplementedError``.  On the CPU both Functions run the plain
versions.  Without a gradient it is ``ssd_scan`` itself, launch for
launch.
"""
from __future__ import annotations

import ctypes

import torch

from ...trace_hooks import plain_device, recurrence
from .. import aligned16, needs_grad
from ..build import load_library
from ..scar_eval.kernel import blocked_cumsum
from .kernel import _DTYPES, _as_4d, _check, ssd_scan

__all__ = ["SSDScanFn", "SSDScanNormFn", "scan", "ssd_scan_bwd",
           "ssd_scan_bwd_plain", "ssd_wide_bwd"]

_ERR_TENSOR_MAP = 10000        # the launcher's code for refused TMA maps
MAX_NP = 64                    # the narrow backward kernel's N and P
MAX_CHUNK = 256                # and rows of a chunk (both kernels)
# the wide kernel's N and P: the forward's range (ssd_wide_tc, ssd_f32)
MAX_WIDE_NP = {torch.bfloat16: 256, torch.float32: 128}


def ssd_scan_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       a: torch.Tensor, do: torch.Tensor, *,
                       chunk: int = 128, dden: torch.Tensor | None = None):
    """Plain torch version of the backward kernels, in float32, in either
    layout: ``(dq, dk, dv, da)``, dq and dk per head.  With ``dden`` (the
    normaliser's output gradient, shaped like ``a``) v gains a column of
    ones and do the column dden, and dv of that column is dropped."""
    if dden is not None:
        ones = torch.ones(v.shape[:-1] + (1,), dtype=torch.float32,
                          device=v.device)
        dq, dk, dv, da = ssd_scan_bwd_plain(
            q.float(), k.float(), torch.cat([v.float(), ones], -1), a,
            torch.cat([do.float(), dden.float()[..., None]], -1), chunk=chunk)
        return (dq.to(v.dtype), dk.to(v.dtype), dv[..., :-1].to(v.dtype),
                da)
    three = v.dim() == 3
    q4, k4, v4, a3, do4 = (_as_4d(t, three) for t in (q, k, v, a, do))
    L = v4.shape[1]
    c = min(chunk, L)
    nc = L // c
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q4, k4, v4, do4))
    af = a3.float().transpose(1, 2)                          # [B, H, L]
    B, H, _, N = qf.shape
    P = vf.shape[-1]

    def part(t, i):
        return t[:, :, i * c:(i + 1) * c]

    # every chunk's prefix sums of a at once, each in its own association
    cums = blocked_cumsum(af.reshape(B, H, nc, c).movedim(-1, 0)).movedim(
        0, -1)                                               # [B, H, nc, c]
    s_in = qf.new_empty((B, H, nc, N, P))    # the state entering each chunk

    def states(n):                           # chunks 0 .. n - 1
        state = qf.new_zeros((B, H, N, P))
        for i in range(n):
            s_in[:, :, i] = state
            cum = cums[:, :, i]
            total = cum[..., -1:]
            k_dec = part(kf, i) * torch.exp(total - cum)[..., None]
            state = (state * torch.exp(total)[..., None]
                     + k_dec.transpose(-1, -2) @ part(vf, i))
        return state
    recurrence(states, nc, v.device)
    ds_out = qf.new_empty((B, H, nc, N, P))  # that of the state leaving it

    def dstates(n):                          # chunks nc - 1 .. nc - n
        dstate = qf.new_zeros((B, H, N, P))
        for i in reversed(range(nc - n, nc)):
            ds_out[:, :, i] = dstate
            cum = cums[:, :, i]
            total = cum[..., -1:]
            q_dec = part(qf, i) * torch.exp(cum)[..., None]
            dstate = (dstate * torch.exp(total)[..., None]
                      + q_dec.transpose(-1, -2) @ part(dof, i))
        return dstate
    recurrence(dstates, nc, v.device)
    tril = torch.ones((c, c), dtype=torch.bool, device=v.device).tril()
    dq, dk = qf.new_empty((B, H, L, N)), qf.new_empty((B, H, L, N))
    dv = qf.new_empty((B, H, L, P))

    def grads(n):                            # chunks 0 .. n - 1
        for i in range(n):
            rows = slice(i * c, (i + 1) * c)
            qc, kc, vc, doc = (t[:, :, rows] for t in (qf, kf, vf, dof))
            cum = cums[:, :, i]
            total = cum[..., -1:]
            rel = cum[..., :, None] - cum[..., None, :]
            gate = torch.where(tril, torch.exp(torch.where(tril, rel, 0.0)),
                               0.0)
            g_do = (doc @ vc.transpose(-1, -2)) * gate        # [t, s]
            g_qk = (qc @ kc.transpose(-1, -2)) * gate
            tail = torch.exp(total - cum)[..., None]
            dq[:, :, rows] = (g_do @ kc + torch.exp(cum)[..., None]
                              * (doc @ s_in[:, :, i].transpose(-1, -2)))
            dk[:, :, rows] = (g_do.transpose(-1, -2) @ qc
                              + tail * (vc @ ds_out[:, :, i].transpose(-1,
                                                                      -2)))
            dv[:, :, rows] = (g_qk.transpose(-1, -2) @ doc
                              + tail * (kc @ ds_out[:, :, i]))
    recurrence(grads, nc, v.device)
    r = (qf * dq).sum(-1) - (kf * dk).sum(-1)                  # [B, H, L]
    da = torch.flip(torch.cumsum(torch.flip(r, [-1]), -1), [-1])
    dq, dk, dv = (t.transpose(1, 2).to(v.dtype) for t in (dq, dk, dv))
    da = da.transpose(1, 2).contiguous()
    if three:
        return dq[:, :, 0], dk[:, :, 0], dv[:, :, 0], da[:, :, 0]
    return dq, dk, dv, da


def _check_bwd(q, k, v, a, do, chunk, dden, what):
    _check(q, k, v, a, chunk)
    if do.shape != v.shape:
        raise ValueError(f"{what}: do {tuple(do.shape)} must be "
                         f"shaped like v {tuple(v.shape)}")
    if dden is not None and dden.shape != a.shape:
        raise ValueError(f"{what}: dden {tuple(dden.shape)} must be "
                         f"shaped like a {tuple(a.shape)}")


def _strides(t):                     # batch, sequence, head (elements)
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def ssd_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 a: torch.Tensor, do: torch.Tensor, *, chunk: int = 128,
                 dden: torch.Tensor | None = None):
    """``(dq, dk, dv, da)`` of ``ssd_scan``'s output (and of its
    normaliser, given ``dden``): the CUDA kernels on CUDA tensors, the
    plain version on the CPU.  Calls with the normaliser or N or P over
    64 go to ``ssd_wide_bwd``; ``ssd_scan_bwd.launches`` counts the narrow
    kernel's launches (one per call, which runs its kernels in order on
    the stream: bf16 the states, the fused dq / dk / dv and da; float32
    the states, dq, dk / dv and da)."""
    _check_bwd(q, k, v, a, do, chunk, dden, "ssd_scan_bwd")
    dev = v.device
    if plain_device(v):
        return ssd_scan_bwd_plain(q, k, v, a, do, chunk=chunk, dden=dden)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: no kernel for {dev}")
    N, P, c = q.shape[-1], v.shape[-1], min(chunk, v.shape[1])
    beyond = _beyond(N, P, c, v.dtype)
    if beyond:
        raise NotImplementedError(beyond)
    if dden is not None or N > MAX_NP or P > MAX_NP:
        return _wide_bwd_launch(q, k, v, a, do, c, dden)
    three = v.dim() == 3
    q4, k4, v4, a3, do4 = (
        _as_4d(t if t.stride(-1) == 1 else t.contiguous(), three)
        for t in (q, k, v, a, do))
    B, L, H, N = q4.shape
    if v.dtype == torch.bfloat16:
        q4, k4, v4, do4 = (aligned16(t) for t in (q4, k4, v4, do4))
    lib = _lib()
    dq = torch.empty((B, L, H, N), dtype=v.dtype, device=dev)
    dk = torch.empty((B, L, H, N), dtype=v.dtype, device=dev)
    dv = torch.empty((B, L, H, P), dtype=v.dtype, device=dev)
    da = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    ws = torch.empty((lib.ssd_scan_bwd_ws_floats(B, L, H, N, P, c,
                                                 _DTYPES[v.dtype]),),
                     dtype=torch.float32, device=dev)
    # bf16: the states launch's ticket counter and ready flags (zeroed)
    sync = (torch.zeros((lib.ssd_scan_bwd_sync_ints(B, L, H, c),),
                        dtype=torch.int32, device=dev)
            if v.dtype == torch.bfloat16 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_bwd_launch(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), do4.data_ptr(),
            a3.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            da.data_ptr(), ws.data_ptr(),
            None if sync is None else sync.data_ptr(), _DTYPES[v.dtype],
            B, L, H, N, P, c, _strides(q4), _strides(k4), _strides(v4),
            _strides(do4), _strides(a3), stream)
    if err == _ERR_TENSOR_MAP:
        raise RuntimeError("ssd_scan_bwd: cuTensorMapEncodeTiled refused "
                           "the TMA maps of q, k, v or dO")
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {err}")
    ssd_scan_bwd.launches += 1
    if three:
        return dq[:, :, 0], dk[:, :, 0], dv[:, :, 0], da[:, :, 0]
    return dq, dk, dv, da


ssd_scan_bwd.launches = 0


def ssd_wide_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 a: torch.Tensor, do: torch.Tensor, *, chunk: int = 128,
                 dden: torch.Tensor | None = None):
    """``(dq, dk, dv, da)`` from the wide backward kernel
    (``csrc/ssd_wide_bwd.cu``: N, P up to 256, the normaliser given
    ``dden``) on CUDA tensors, the plain version on the CPU.
    ``ssd_wide_bwd.launches`` counts its launches (one per call, which
    runs three kernels in order on the stream: the states, dq / dk / dv,
    da; bf16 on the tensor cores, float32 on the CUDA cores)."""
    _check_bwd(q, k, v, a, do, chunk, dden, "ssd_wide_bwd")
    dev = v.device
    if plain_device(v):
        return ssd_scan_bwd_plain(q, k, v, a, do, chunk=chunk, dden=dden)
    if dev.type != "cuda":
        raise ValueError(f"ssd_wide_bwd: no kernel for {dev}")
    c = min(chunk, v.shape[1])
    beyond = _beyond(q.shape[-1], v.shape[-1], c, v.dtype)
    if beyond:
        raise NotImplementedError(beyond)
    return _wide_bwd_launch(q, k, v, a, do, c, dden)


def _wide_bwd_launch(q, k, v, a, do, c, dden):
    """``ssd_wide_bwd``'s launch on CUDA tensors that its callers have
    checked (``_beyond``), with the chunk ``c`` already cut to the
    sequence; bf16 inputs TMA cannot read are copied by ``aligned16``."""
    dev = v.device
    three = v.dim() == 3
    q4, k4, v4, a3, do4 = (
        _as_4d(t if t.stride(-1) == 1 else t.contiguous(), three)
        for t in (q, k, v, a, do))
    d3 = None if dden is None else _as_4d(dden.to(v.dtype), three)
    B, L, H, N = q4.shape
    P = v4.shape[-1]
    bf16 = v.dtype == torch.bfloat16
    if bf16:                 # the tensor-core kernels read by TMA
        q4, k4, v4, do4 = (aligned16(t) for t in (q4, k4, v4, do4))
    lib = _wide_lib()
    dq = torch.empty((B, L, H, N), dtype=v.dtype, device=dev)
    dk = torch.empty((B, L, H, N), dtype=v.dtype, device=dev)
    dv = torch.empty((B, L, H, P), dtype=v.dtype, device=dev)
    da = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    ws = torch.empty((lib.ssd_wide_bwd_ws_floats(
        B, L, H, N, P, c, int(d3 is not None), _DTYPES[v.dtype]),),
        dtype=torch.float32, device=dev)
    # bf16: the states launch's ticket counter and ready flags (zeroed)
    sync = (torch.zeros((lib.ssd_wide_bwd_sync_ints(B, L, H, N, P, c),),
                        dtype=torch.int32, device=dev) if bf16 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_wide_bwd_launch(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), do4.data_ptr(),
            a3.data_ptr(), None if d3 is None else d3.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), da.data_ptr(),
            ws.data_ptr(), None if sync is None else sync.data_ptr(),
            _DTYPES[v.dtype], B, L, H, N, P, c,
            _strides(q4), _strides(k4), _strides(v4), _strides(do4),
            _strides(a3), None if d3 is None else _strides(d3), stream)
    if err == _ERR_TENSOR_MAP:
        raise RuntimeError("ssd_wide_bwd: cuTensorMapEncodeTiled refused "
                           "the TMA maps of q, k, v or dO")
    if err != 0:
        raise RuntimeError(f"ssd_wide_bwd launch failed: CUDA error {err}")
    ssd_wide_bwd.launches += 1
    if three:
        return dq[:, :, 0], dk[:, :, 0], dv[:, :, 0], da[:, :, 0]
    return dq, dk, dv, da


ssd_wide_bwd.launches = 0


def _beyond(N: int, P: int, c: int, dtype: torch.dtype) -> str:
    """Why no backward kernel takes this call ("" if one does)."""
    top = MAX_WIDE_NP.get(dtype, 0)
    if N > top or P > top or c > MAX_CHUNK:
        return (f"ssd_scan's backward kernels take bf16 N, P <= "
                f"{MAX_WIDE_NP[torch.bfloat16]} and float32 N, P <= "
                f"{MAX_WIDE_NP[torch.float32]}, chunks <= {MAX_CHUNK} rows, "
                f"with or without the normaliser (got {dtype} N {N}, P {P}, "
                f"chunk {c})")
    if dtype == torch.bfloat16 and (N % 16 or P % 16):
        return (f"ssd_scan's backward kernels take bf16 N and P multiples "
                f"of 16 only (got N {N}, P {P}); float32 takes any up to "
                f"{MAX_WIDE_NP[torch.float32]}")
    return ""


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` (no normaliser) with its backward kernel.  Saves q, k,
    v and a."""

    @staticmethod
    def forward(ctx, q, k, v, a, chunk: int):
        out = ssd_scan(q, k, v, a, chunk=chunk)
        ctx.save_for_backward(q, k, v, a)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, a = ctx.saved_tensors
        dq, dk, dv, da = ssd_scan_bwd(q, k, v, a, do, chunk=ctx.chunk)
        return dq, dk, dv, da, None


class SSDScanNormFn(torch.autograd.Function):
    """``ssd_scan(..., norm=True)``, ``(o, den)``, with the backward kernels
    (``ssd_scan_bwd`` given ``dden``).  Saves q, k, v and a."""

    @staticmethod
    def forward(ctx, q, k, v, a, chunk: int):
        out, den = ssd_scan(q, k, v, a, chunk=chunk, norm=True)
        ctx.save_for_backward(q, k, v, a)
        ctx.chunk = chunk
        return out, den

    @staticmethod
    def backward(ctx, do, dden):
        q, k, v, a = ctx.saved_tensors
        dq, dk, dv, da = ssd_scan_bwd(q, k, v, a, do, chunk=ctx.chunk,
                                      dden=dden)
        return dq, dk, dv, da, None


def scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
         *, chunk: int = 128, norm: bool = False):
    """``ssd_scan`` that autograd can differentiate (see the module note).
    """
    if not needs_grad(q, k, v, a):
        return ssd_scan(q, k, v, a, chunk=chunk, norm=norm)
    if not plain_device(v):
        N, P, c = q.shape[-1], v.shape[-1], min(chunk, v.shape[1])
        beyond = _beyond(N, P, c, v.dtype)
        if beyond:
            raise NotImplementedError(beyond)
    fn = SSDScanNormFn if norm else SSDScanFn
    return fn.apply(q, k, v, a, chunk)


_LIB = None


def _lib() -> ctypes.CDLL:
    """The backward kernel's library, built at first use."""
    global _LIB
    if _LIB is None:
        lib = load_library("ssd_scan_bwd")
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_longlong)
        lib.ssd_scan_bwd_launch.argtypes = (
            [p] * 11 + [i] * 7 + [s] * 5 + [p])
        lib.ssd_scan_bwd_launch.restype = i
        lib.ssd_scan_bwd_ws_floats.argtypes = [i] * 7
        lib.ssd_scan_bwd_ws_floats.restype = ctypes.c_longlong
        lib.ssd_scan_bwd_sync_ints.argtypes = [i] * 4
        lib.ssd_scan_bwd_sync_ints.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


_WIDE_LIB = None


def _wide_lib() -> ctypes.CDLL:
    """The wide backward kernel's library, built at first use."""
    global _WIDE_LIB
    if _WIDE_LIB is None:
        lib = load_library("ssd_wide_bwd")
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_longlong)
        lib.ssd_wide_bwd_launch.argtypes = (
            [p] * 12 + [i] * 7 + [s] * 6 + [p])
        lib.ssd_wide_bwd_launch.restype = i
        lib.ssd_wide_bwd_ws_floats.argtypes = [i] * 8
        lib.ssd_wide_bwd_ws_floats.restype = ctypes.c_longlong
        lib.ssd_wide_bwd_sync_ints.argtypes = [i] * 6
        lib.ssd_wide_bwd_sync_ints.restype = ctypes.c_longlong
        _WIDE_LIB = lib
    return _WIDE_LIB
