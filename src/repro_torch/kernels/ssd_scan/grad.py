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

``scan`` is what the model layer calls: with a gradient required it takes
the Function where the backward kernel covers the call (N and P up to 64,
multiples of 16 in bf16, chunks up to 256 rows, no normaliser); on the
card anything else raises
``NotImplementedError`` (xLSTM's wide heads and normaliser: ROADMAP.md,
queue 1, xLSTM training).  On the CPU the plain forward is ordinary torch
and autograd differentiates it where the Function does not apply.
Without a gradient it is ``ssd_scan`` itself, launch for launch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import aligned16, needs_grad
from ..build import load_library
from ..scar_eval.kernel import blocked_cumsum
from .kernel import _DTYPES, _as_4d, _check, ssd_scan, ssd_scan_plain

__all__ = ["SSDScanFn", "scan", "ssd_scan_bwd", "ssd_scan_bwd_plain"]

_ERR_TENSOR_MAP = 10000        # the launcher's code for refused TMA maps
MAX_NP = 64                    # the backward kernel's N and P
MAX_CHUNK = 256                # and rows of a chunk


def ssd_scan_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       a: torch.Tensor, do: torch.Tensor, *,
                       chunk: int = 128):
    """Plain torch version of the backward kernel, in float32, in either
    layout: ``(dq, dk, dv, da)``, dq and dk per head."""
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

    cums = [blocked_cumsum(part(af, i).movedim(-1, 0)).movedim(0, -1)
            for i in range(nc)]
    s_in, state = [], qf.new_zeros((B, H, N, P))
    for i in range(nc):                   # the state entering each chunk
        s_in.append(state)
        cum, total = cums[i], cums[i][..., -1:]
        k_dec = part(kf, i) * torch.exp(total - cum)[..., None]
        state = (state * torch.exp(total)[..., None]
                 + k_dec.transpose(-1, -2) @ part(vf, i))
    ds_out, dstate = [None] * nc, qf.new_zeros((B, H, N, P))
    for i in reversed(range(nc)):         # the gradient of the state leaving
        ds_out[i] = dstate
        cum, total = cums[i], cums[i][..., -1:]
        q_dec = part(qf, i) * torch.exp(cum)[..., None]
        dstate = (dstate * torch.exp(total)[..., None]
                  + q_dec.transpose(-1, -2) @ part(dof, i))
    tril = torch.ones((c, c), dtype=torch.bool, device=v.device).tril()
    dqs, dks, dvs = [], [], []
    for i in range(nc):
        qc, kc, vc, doc = (part(t, i) for t in (qf, kf, vf, dof))
        cum, total = cums[i], cums[i][..., -1:]
        rel = cum[..., :, None] - cum[..., None, :]
        gate = torch.where(tril, torch.exp(torch.where(tril, rel, 0.0)), 0.0)
        g_do = (doc @ vc.transpose(-1, -2)) * gate            # [t, s]
        g_qk = (qc @ kc.transpose(-1, -2)) * gate
        tail = torch.exp(total - cum)[..., None]
        dqs.append(g_do @ kc
                   + torch.exp(cum)[..., None] * (doc @ s_in[i].transpose(
                       -1, -2)))
        dks.append(g_do.transpose(-1, -2) @ qc
                   + tail * (vc @ ds_out[i].transpose(-1, -2)))
        dvs.append(g_qk.transpose(-1, -2) @ doc + tail * (kc @ ds_out[i]))
    dq, dk, dv = (torch.cat(t, dim=2) for t in (dqs, dks, dvs))
    r = (qf * dq).sum(-1) - (kf * dk).sum(-1)                  # [B, H, L]
    da = torch.flip(torch.cumsum(torch.flip(r, [-1]), -1), [-1])
    dq, dk, dv = (t.transpose(1, 2).to(v.dtype) for t in (dq, dk, dv))
    da = da.transpose(1, 2).contiguous()
    if three:
        return dq[:, :, 0], dk[:, :, 0], dv[:, :, 0], da[:, :, 0]
    return dq, dk, dv, da


def ssd_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 a: torch.Tensor, do: torch.Tensor, *, chunk: int = 128):
    """``(dq, dk, dv, da)`` of ``ssd_scan``'s output: the CUDA kernel on
    CUDA tensors, the plain version on the CPU.  ``ssd_scan_bwd.launches``
    counts the kernel's launches (one per call, which runs its kernels in
    order on the stream: bf16 the states, the fused dq / dk / dv and da;
    float32 the states, dq, dk / dv and da)."""
    _check(q, k, v, a, chunk)
    if do.shape != v.shape:
        raise ValueError(f"ssd_scan_bwd: do {tuple(do.shape)} must be "
                         f"shaped like v {tuple(v.shape)}")
    dev = v.device
    if dev.type == "cpu":
        return ssd_scan_bwd_plain(q, k, v, a, do, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: no kernel for {dev}")
    three = v.dim() == 3
    q4, k4, v4, a3, do4 = (
        _as_4d(t if t.stride(-1) == 1 else t.contiguous(), three)
        for t in (q, k, v, a, do))
    B, L, H, N = q4.shape
    P = v4.shape[-1]
    c = min(chunk, L)
    beyond = _beyond(N, P, c, v.dtype)
    if beyond:
        raise NotImplementedError(beyond)
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

    def strides(t):                  # batch, sequence, head (elements)
        return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_bwd_launch(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), do4.data_ptr(),
            a3.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            da.data_ptr(), ws.data_ptr(),
            None if sync is None else sync.data_ptr(), _DTYPES[v.dtype],
            B, L, H, N, P, c, strides(q4), strides(k4), strides(v4),
            strides(do4), strides(a3), stream)
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


def _beyond(N: int, P: int, c: int, dtype: torch.dtype,
            norm: bool = False) -> str:
    """Why the backward kernel does not take this call ("" if it does)."""
    if norm or N > MAX_NP or P > MAX_NP or c > MAX_CHUNK:
        return (f"ssd_scan's backward kernel takes N, P <= {MAX_NP} and "
                f"chunks <= {MAX_CHUNK} rows without the normaliser (got N "
                f"{N}, P {P}, chunk {c}{', the normaliser' if norm else ''})"
                "; xLSTM's wide heads wait for their own backward "
                "(ROADMAP.md, queue 1: xLSTM training)")
    if dtype == torch.bfloat16 and (N % 16 or P % 16):
        return (f"ssd_scan's backward kernel takes bf16 N and P multiples of "
                f"16 only (got N {N}, P {P}); float32 takes any up to "
                f"{MAX_NP}")
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


def scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, a: torch.Tensor,
         *, chunk: int = 128, norm: bool = False):
    """``ssd_scan`` that autograd can differentiate (see the module note).
    """
    if not needs_grad(q, k, v, a):
        return ssd_scan(q, k, v, a, chunk=chunk, norm=norm)
    if v.device.type == "cpu":
        if norm:                  # plain torch ops, differentiated as such
            return ssd_scan_plain(q, k, v, a, chunk=chunk, norm=True)
        return SSDScanFn.apply(q, k, v, a, chunk)
    N, P, c = q.shape[-1], v.shape[-1], min(chunk, v.shape[1])
    beyond = _beyond(N, P, c, v.dtype, norm)
    if beyond:
        raise NotImplementedError(beyond)
    return SSDScanFn.apply(q, k, v, a, chunk)


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
