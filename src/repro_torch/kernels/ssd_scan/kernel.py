"""The ``ssd_scan`` CUDA kernel's wrapper and its plain torch version.

Counterpart of the Pallas kernel ``repro/kernels/ssd_scan/kernel.py``.
Both functions here compute chunked gated linear attention (the Mamba-2 SSD
scan), ``o_t = q_t . S_t`` with ``S_t = exp(a_t) S_{t-1} + k_t^T v_t``:
per chunk an intra-chunk causal quadratic gated by ``exp(cum_i - cum_j)``,
plus ``q exp(cum)`` against the ``[N, P]`` float32 state carried from the
chunks before.  This is the function of the model layer ``gla_chunked``
(``repro/models/layers.py``), which the reference's oracle
(``ssd_scan/ref.py``) delegates to.

Layouts: ``[BH, L, N]`` (the TPU kernel's; ``a`` ``[BH, L]``) or
``[B, L, H, N]`` (the model's; ``a`` ``[B, L, H]``).  The in-chunk prefix
sums ``cum`` follow ``blocked_cumsum``'s association, which is that of
``jnp.cumsum`` on the CPU: the gates take differences of prefix sums that
reach -100 and more, so another association moves them by 1e-4 relative.
q, k and v are bf16 or float32, ``a`` (<= 0) is float32; the output has
v's type.  The plain version computes in float32, and so does the float32
kernel; the bf16 kernel multiplies on the tensor cores with float32 sums,
splitting every float32-held operand into three bf16 terms.

``ssd_scan`` launches the kernel for CUDA tensors (float32: one block per
(batch, head) that walks the chunks in order; bf16: one block per (batch,
head, chunk), each chunk handing its state on to the next, or, for heads
wider than 64 (xLSTM's N = P = 256), one block per (batch, head, chunk, 64
state columns); one count per launch) and takes the plain version only for
tensors on the CPU or ``meta`` (a trace); a CUDA tensor never falls back.
The kernels read any batch, sequence and head strides (last dimension
contiguous), so Mamba-2's q and k, broadcast over heads (head stride 0),
go in without a copy.  The bf16 kernels take N up to 256 and chunks up to
256 rows, and their ``cp.async`` loads need 16-byte aligned pointers and
N, P and strides that are multiples of 8 elements; the float32 kernel
takes N and P up to 128.
The wrapper raises otherwise.  For bf16 the wrapper allocates the float32
workspace of the states entering chunks ``1 .. L / chunk - 1`` and the
zeroed int32 ticket counter and ready flags.

``norm=True`` also returns the normaliser the reference's mLSTM takes from
a second call with ``v = ones[..., :1]`` (``[B, L, H]``, v's type): the
bf16 wide kernel computes it in the same launch from the gated scores and
a normaliser state handed on beside the state; the float32 kernel and the
plain version make the second call.
"""
from __future__ import annotations

import ctypes

import torch

from ...trace_hooks import plain_device, recurrence
from .. import needs_grad
from ..build import load_library
from ..scar_eval.kernel import blocked_cumsum

__all__ = ["ssd_scan", "ssd_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LIMITS = {0: "float32 takes N, P <= 128 and chunks <= 4096",
           1: "bfloat16 takes N <= 256 and chunks <= 256"}


def _as_4d(t: torch.Tensor, three: bool) -> torch.Tensor:
    """``[BH, L, X]`` as ``[BH, L, 1, X]`` (``a``: ``[BH, L]`` as
    ``[BH, L, 1]``); the model layout as it is."""
    return t.unsqueeze(2) if three else t


def ssd_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   a: torch.Tensor, *, chunk: int = 128, norm: bool = False):
    """Plain torch version of the kernel: the same chunk loop and carried
    state, in float32, in either layout.  ``norm=True`` returns ``(o,
    den)``, den the scan of ``v = ones[..., :1]`` without its last axis."""
    if norm:
        ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                          device=v.device)
        return (ssd_scan_plain(q, k, v, a, chunk=chunk),
                ssd_scan_plain(q, k, ones, a, chunk=chunk)[..., 0])
    three = v.dim() == 3
    q4, k4, v4, a3 = (_as_4d(t, three) for t in (q, k, v, a))
    L = q4.shape[1]
    c = min(chunk, L)
    if L % c:
        raise ValueError(f"ssd_scan: seq len {L} is not a multiple of the "
                         f"chunk {c}")
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q4, k4, v4))
    af = a3.float().transpose(1, 2)                          # [B, H, L]
    B, H, _, N = qf.shape
    P = vf.shape[-1]
    nc = L // c
    # every chunk's prefix sums of a at once, each in its own association
    cums = blocked_cumsum(af.reshape(B, H, nc, c).movedim(-1, 0)).movedim(
        0, -1)                                               # [B, H, nc, c]
    tril = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    out = qf.new_empty((B, H, L, P))

    def run(n):                 # chunks 0 .. n - 1, each its rows of out
        state = qf.new_zeros((B, H, N, P))
        for i in range(n):
            rows = slice(i * c, (i + 1) * c)
            qc, kc, vc = (t[:, :, rows] for t in (qf, kf, vf))
            cum = cums[:, :, i]
            total = cum[..., -1:]
            rel = cum[..., :, None] - cum[..., None, :]
            # exp only on the causal triangle: above it rel > 0 may overflow
            gate = torch.where(tril, torch.exp(torch.where(tril, rel, 0.0)),
                               0.0)
            intra = ((qc @ kc.transpose(-1, -2)) * gate) @ vc
            inter = (qc * torch.exp(cum)[..., None]) @ state
            out[:, :, rows] = intra + inter
            k_dec = kc * torch.exp(total - cum)[..., None]
            state = (state * torch.exp(total)[..., None]
                     + k_dec.transpose(-1, -2) @ vc)
        return state
    recurrence(run, nc, v.device)
    out = out.transpose(1, 2).to(v.dtype)                    # [B, L, H, P]
    return out[:, :, 0] if three else out


def _check(q, k, v, a, chunk: int) -> None:
    if v.dim() not in (3, 4) or q.shape != k.shape or \
            q.shape[:-1] != v.shape[:-1] or a.shape != v.shape[:-1]:
        raise ValueError(f"ssd_scan: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, a "
                         f"{tuple(a.shape)}; want [B, L, H, N] x2, "
                         "[B, L, H, P], [B, L, H] (or without H)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: q, k, v are {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want all float32 or all bfloat16")
    if a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: a is {a.dtype}, want float32")
    if not (q.device == k.device == v.device == a.device):
        raise ValueError("ssd_scan: inputs on different devices")
    L = v.shape[1]
    c = min(chunk, L)
    if c < 1 or L % c:
        raise ValueError(f"ssd_scan: seq len {L} is not a multiple of the "
                         f"chunk {c}")


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             a: torch.Tensor, *, chunk: int = 128, norm: bool = False):
    """SSD scan output (v's layout and type), and with ``norm=True`` the
    normaliser too: the CUDA kernel on CUDA tensors.

    Tensors on the CPU take ``ssd_scan_plain``.  ``ssd_scan.launches``
    counts the kernel's launches (one per call; two for a float32 call
    with ``norm``, which scans ``ones`` in a second launch).  Other tensors
    that require grad (with grad mode on) raise ``NotImplementedError``:
    the kernel's output is invisible to autograd, and ``grad.scan`` is the
    differentiable call.
    """
    _check(q, k, v, a, chunk)
    dev = v.device
    if plain_device(q):
        return ssd_scan_plain(q, k, v, a, chunk=chunk, norm=norm)
    if needs_grad(q, k, v, a):
        # the kernel's output has no grad_fn: a gradient would be lost
        raise NotImplementedError(
            "ssd_scan: the inputs require grad, and the kernel's output "
            "would carry none; call grad.scan (the backward kernel's "
            "autograd.Function) instead")
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for {dev}")
    if norm and v.dtype == torch.float32:
        ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=dev)
        return (ssd_scan(q, k, v, a, chunk=chunk),
                ssd_scan(q, k, ones, a, chunk=chunk)[..., 0])
    three = v.dim() == 3
    q4, k4, v4, a3 = (_as_4d(t, three) for t in (q, k, v, a))
    B, L, H, N = q4.shape
    P = v4.shape[-1]
    c = min(chunk, L)
    lib = _lib()
    dt = _DTYPES[v.dtype]
    route = lib.ssd_scan_route(N, P, c, dt, int(norm))
    if route < 0:
        raise ValueError(f"ssd_scan: no {v.dtype} kernel takes N {N}, P {P}, "
                         f"chunk {c}{' with the normaliser' if norm else ''}"
                         f" ({_LIMITS[dt]})")
    for name, t in (("q", q4), ("k", k4), ("v", v4)):
        if t.stride(3) != 1:
            raise ValueError(f"ssd_scan: {name}'s last dimension is not "
                             "contiguous")
        if v.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or t.shape[3] % 8
                or any(t.stride(i) % 8 for i in range(3))):
            raise ValueError(f"ssd_scan: bf16 {name} is loaded by cp.async, "
                             "which needs a 16-byte aligned pointer and a "
                             "last dimension and strides that are "
                             f"multiples of 8 (shape {tuple(t.shape)}, "
                             f"strides {t.stride()})")
    out = torch.empty((B, L, H, P), dtype=v.dtype, device=dev)
    den = torch.empty((B, L, H), dtype=v.dtype, device=dev) if norm else None
    ws = sync = None
    if v.dtype == torch.bfloat16:
        # the states entering chunks 1 .. nc - 1 (with the normaliser state
        # beside each); a ticket counter and one ready flag per state and
        # column tile (zeroed)
        nc = L // c
        tiles = lib.ssd_scan_col_tiles(P) if route == 2 else 1
        ws = torch.empty((B, nc - 1, H, N * P + (N if norm else 0)),
                         dtype=torch.float32, device=dev)
        sync = torch.zeros((1 + B * (nc - 1) * H * tiles,),
                           dtype=torch.int32, device=dev)

    def strides(t):                  # batch, sequence, head (elements)
        return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_launch(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), a3.data_ptr(),
            out.data_ptr(), ptr(den), ptr(ws), ptr(sync), dt, B, L, H, N, P,
            c, strides(q4), strides(k4), strides(v4), strides(a3), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    if three:
        out = out[:, :, 0]
        den = None if den is None else den[:, :, 0]
    return (out, den) if norm else out


ssd_scan.launches = 0


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with typed entry points."""
    global _LIB
    if _LIB is None:
        lib = load_library("ssd_scan")
        p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_longlong)
        lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                        i, i, i, i, s, s, s, s, p]
        lib.ssd_scan_launch.restype = i
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i, i, i]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_route.argtypes = [i, i, i, i, i]
        lib.ssd_scan_route.restype = i
        lib.ssd_scan_col_tiles.argtypes = [i]
        lib.ssd_scan_col_tiles.restype = i
        _LIB = lib
    return _LIB
