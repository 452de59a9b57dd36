"""The ``slstm`` CUDA kernel's wrapper and its plain torch version.

The xLSTM scalar-memory recurrence over a sequence.  The JAX package has
no Pallas kernel for it: its sLSTM block runs ``_slstm_cell``
(``repro/models/blocks.py:333``) under ``lax.scan`` (``:369``).  The port's
plain version, ``slstm_scan_plain``, is that loop in torch, one
``_slstm_cell`` a position; the kernel (``kernels/csrc/slstm.cu``) runs the
whole sequence in one launch: a cluster of up to 8 CTAs a head and tile of
8 batch rows, each holding its 32 units' columns of r (in registers, the
product on the tensor cores, in bf16), handing h on to every CTA of the
cluster point to point each position, gx streamed in and the outputs
stored by TMA off the chain.

Shapes (the model's layout): gx ``[B, L, H, 4 dh]`` in the model's type,
r ``[H, dh, 4 dh]`` in h's type, carry ``(c, n, h, m)`` each ``[B, H,
dh]`` (c, n and m float32, h in h's type).  Returns ``(ys, carry')``, ys
``[B, L, H, dh]`` in h's type.  The kernel takes gx, r and h of one type
(float32 or bf16) and dh up to 256, a multiple of 16 in bf16 and of 4 in
float32; the wrapper raises otherwise.  TMA reads gx with its own strides
where each is a multiple of 16 bytes and its base is 16-byte aligned; the
wrapper copies it otherwise (``_tma_ready``).

``save=True`` (the training path, ``grad.SLSTMScanFn``) also returns what
the backward reads: each position's gate inputs ``g = (gx + h r).float()``
in gx's type (exact: the reference rounds the sum to that type) and its
carry's c, n and m (float32, ``[B, L, H, dh]``).
"""
from __future__ import annotations

import ctypes

import torch

from ...trace_hooks import plain_device, recurrence
from .. import needs_grad
from ..build import load_library

__all__ = ["slstm_scan", "slstm_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "float32", torch.bfloat16: "bf16"}
MAX_DH = 256
# dh's step: bf16's tensor-core k-steps of 16; float32's 16-byte rows (TMA)
DH_STEP = {torch.bfloat16: 16, torch.float32: 4}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form (``models.layers.softplus``'s)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _cell_of_gates(carry: tuple, g: torch.Tensor
                   ) -> tuple[tuple, torch.Tensor]:
    """One sLSTM step from its gate inputs ``g = gx + h r``.  carry: (c, n,
    h, m), each [B, H, dh]; g: [B, H, 4 dh]."""
    c, n, h, m = carry
    zt, it, ft, ot = torch.chunk(g.float(), 4, dim=-1)
    log_f = -_softplus(-ft)
    m2 = torch.maximum(log_f + m, it)
    ip = torch.exp(it - m2)
    fp = torch.exp(log_f + m - m2)
    c2 = fp * c + ip * torch.tanh(zt)
    n2 = fp * n + ip
    h2 = (torch.sigmoid(ot) * c2 / torch.clamp_min(n2, 1.0)).to(h.dtype)
    return (c2, n2, h2, m2), h2


def slstm_scan_plain(gx: torch.Tensor, r: torch.Tensor, carry: tuple, *,
                     save: bool = False):
    """Plain torch version of the kernel: one step a position (the
    reference's ``lax.scan``).  ``(ys, carry')``, and with ``save`` the
    backward's ``(g, cs, ns, ms)``."""
    B, L = gx.shape[:2]
    c, n, h, m = carry
    f32 = torch.float32
    ys = gx.new_empty((B, L) + tuple(h.shape[1:]), dtype=h.dtype)
    if save:    # the cell's own gate inputs, and its c, n and m
        saved = (gx.new_empty(gx.shape, dtype=torch.promote_types(
            gx.dtype, h.dtype)),) + tuple(
            gx.new_empty((B, L) + tuple(x.shape[1:]),
                         dtype=torch.promote_types(f32, x.dtype))
            for x in (c, n, m))

    def run(steps):                     # positions 0 .. steps - 1
        cy = carry
        for t in range(steps):
            g = gx[:, t] + torch.einsum("bhd,hdk->bhk", cy[2], r)
            cy, y = _cell_of_gates(cy, g)
            ys[:, t] = y
            if save:
                for s, x in zip(saved, (g, cy[0], cy[1], cy[3])):
                    s[:, t] = x
        return cy
    carry = recurrence(run, L, gx.device)
    return (ys, carry, saved) if save else (ys, carry)


def _check(gx, r, carry) -> None:
    if gx.dim() != 4 or r.dim() != 3 or len(carry) != 4:
        raise ValueError(f"slstm: gx {tuple(gx.shape)}, r {tuple(r.shape)}; "
                         "want [B, L, H, 4 dh], [H, dh, 4 dh] and a carry "
                         "(c, n, h, m)")
    B, _, H, four_dh = gx.shape
    dh = four_dh // 4
    if four_dh % 4 or tuple(r.shape) != (H, dh, four_dh) or any(
            tuple(t.shape) != (B, H, dh) for t in carry):
        raise ValueError(f"slstm: gx {tuple(gx.shape)}, r {tuple(r.shape)}, "
                         f"carry {[tuple(t.shape) for t in carry]}; want "
                         "[B, L, H, 4 dh], [H, dh, 4 dh], [B, H, dh] x 4")
    if len({t.device for t in (gx, r, *carry)}) != 1:
        raise ValueError("slstm: inputs on different devices")


def _beyond(gx, r, carry) -> str:
    """Why the kernel does not take this call ("" if it does)."""
    c, n, h, m = carry
    dh = r.shape[1]
    if not (gx.dtype == r.dtype == h.dtype) or gx.dtype not in _DTYPES:
        return (f"slstm: the kernel takes gx, r and h of one type, float32 "
                f"or bfloat16 (got {gx.dtype}, {r.dtype}, {h.dtype})")
    if any(t.dtype != torch.float32 for t in (c, n, m)):
        return "slstm: the kernel takes c, n and m in float32"
    if dh > MAX_DH:
        return f"slstm: the kernel takes dh <= {MAX_DH} (got {dh})"
    step = DH_STEP[gx.dtype]
    if dh % step:
        return (f"slstm: the {_NAMES[gx.dtype]} kernel takes dh a multiple "
                f"of {step} (got {dh})")
    return ""


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels' TMA reads it: last dimension contiguous, every
    other stride a positive multiple of 16 bytes, base 16-byte aligned (a
    contiguous copy otherwise)."""
    es = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(st <= 0 or st * es % 16 for st in t.stride()[:-1])):
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
    return t


def slstm_scan(gx: torch.Tensor, r: torch.Tensor, carry: tuple, *,
               save: bool = False):
    """The recurrence over ``gx``'s L positions: the CUDA kernel on CUDA
    tensors, ``slstm_scan_plain`` on the CPU.  ``slstm_scan.launches``
    counts the kernel's launches (one per call).  Tensors that require
    grad (with grad mode on) raise ``NotImplementedError``: the kernel's
    output has no ``grad_fn``, and ``grad.scan`` is the differentiable
    call."""
    _check(gx, r, carry)
    dev = gx.device
    if plain_device(gx):
        return slstm_scan_plain(gx, r, carry, save=save)
    if needs_grad(gx, r, *carry):
        raise NotImplementedError(
            "slstm: the inputs require grad, and the kernel's output would "
            "carry none; call grad.scan (the backward kernel's "
            "autograd.Function) instead")
    if dev.type != "cuda":
        raise ValueError(f"slstm: no kernel for {dev}")
    beyond = _beyond(gx, r, carry)
    if beyond:
        raise ValueError(beyond)
    gx = _tma_ready(gx)
    r = r.contiguous()
    c0, n0, h0, m0 = (t.contiguous() for t in carry)
    B, L, H, four_dh = gx.shape
    dh = four_dh // 4
    ys = torch.empty((B, L, H, dh), dtype=gx.dtype, device=dev)
    c1, n1, m1 = (torch.empty_like(c0) for _ in range(3))
    h1 = torch.empty_like(h0)
    g = cs = ns = ms = None
    if save:
        g = torch.empty((B, L, H, four_dh), dtype=gx.dtype, device=dev)
        cs, ns, ms = (torch.empty((B, L, H, dh), dtype=torch.float32,
                                  device=dev) for _ in range(3))

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.slstm_fwd_launch(
            gx.data_ptr(), r.data_ptr(), c0.data_ptr(), n0.data_ptr(),
            h0.data_ptr(), m0.data_ptr(), ys.data_ptr(), c1.data_ptr(),
            n1.data_ptr(), h1.data_ptr(), m1.data_ptr(), ptr(g), ptr(cs),
            ptr(ns), ptr(ms), _DTYPES[gx.dtype], B, L, H, dh,
            (ctypes.c_longlong * 3)(*gx.stride()[:3]), stream)
    if err != 0:
        raise RuntimeError(f"slstm launch failed: CUDA error {err}")
    slstm_scan.launches += 1
    carry = (c1, n1, h1, m1)
    return (ys, carry, (g, cs, ns, ms)) if save else (ys, carry)


slstm_scan.launches = 0

_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernels' library (forward and backward), built at first use."""
    global _LIB
    if _LIB is None:
        lib = load_library("slstm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.slstm_fwd_launch.argtypes = (
            [p] * 15 + [i] * 5 + [ctypes.POINTER(ctypes.c_longlong), p])
        lib.slstm_fwd_launch.restype = i
        lib.slstm_bwd_launch.argtypes = [p] * 18 + [i] * 5 + [p]
        lib.slstm_bwd_launch.restype = i
        _LIB = lib
    return _LIB
