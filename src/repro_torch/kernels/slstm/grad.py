"""Gradients of the sLSTM recurrence: the backward kernel's wrapper, its
plain torch version and the ``autograd.Function`` that joins them to the
forward kernel.

The JAX package differentiates its ``lax.scan`` of ``_slstm_cell`` with
``jax.grad``; the port's forward kernel output has no ``grad_fn``, so
``SLSTMScanFn`` runs the forward kernel with ``save=True`` and, in its
backward, ``slstm_scan_bwd``: the reverse recurrence (the hand-written
``slstm_bwd`` kernel, ``kernels/csrc/slstm.cu``, on CUDA tensors;
``slstm_scan_bwd_plain`` on the CPU) for dgx and the carry in's
gradients, then dr as one batched product of the h entering each position
and dg (a plain large product).  Both follow autograd of the plain forward
(``slstm_scan_plain``): the gate gradients are rounded to gx's type where
autograd casts them (``(gx + gr).float()``), dg r^T is rounded to h's
type and added to the output's gradient in h's type, as autograd sums two
gradients of a bf16 tensor; ``torch.maximum`` splits a tie in half and
``torch.clamp_min(n, 1)`` passes the whole gradient at ``n == 1``
(``jnp.maximum`` would pass half there; the two cancel to rounding).

What the Function saves, per layer: the gate inputs ``g`` in gx's type
(the bytes of gx: 32 MiB at xlstm-350m's training shape, bf16 [4, 1024,
4, 1024]), each position's c, n and m (float32, 16 MiB each there), the
outputs ys (h's type, 8 MiB), r and the carry in; nothing is recomputed.

``scan`` is what the model layer calls: without a gradient it is
``slstm_scan`` itself, launch for launch; with one it takes the Function
(on the card only where the kernels take the call, else
``NotImplementedError``; on the CPU with the plain versions).
"""
from __future__ import annotations

import torch

from ...trace_hooks import plain_device, recurrence
from .. import needs_grad
from .kernel import (_DTYPES, _beyond, _check, _lib, _softplus, _tma_ready,
                     slstm_scan)

__all__ = ["SLSTMScanFn", "scan", "slstm_scan_bwd", "slstm_scan_bwd_plain"]


def _zeros_for(grads: tuple, carry: tuple) -> tuple:
    return tuple(torch.zeros_like(c) if d is None else d
                 for d, c in zip(grads, carry))


def _dr(h0: torch.Tensor, ys: torch.Tensor, dgx: torch.Tensor
        ) -> torch.Tensor:
    """``sum_t h_{t-1}^T dg_t`` over batch and positions, per head: one
    batched product in h's type."""
    hprev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)     # [B, L, H, dh]
    return torch.einsum("blhd,blhk->hdk", hprev, dgx.to(hprev.dtype))


def slstm_scan_bwd_plain(g, r, carry0, states, ys, dys, dcarry):
    """Plain torch version of the backward kernel: the reverse recurrence
    in float32, one position at a time.  ``(dgx, dr, dcarry0)``."""
    if dys is None:
        dys = torch.zeros_like(ys)
    L = g.shape[1]
    dgx = torch.empty_like(g)
    dcarry0 = recurrence(lambda steps: _reverse(
        g, r, carry0, states, dys, dcarry, dgx, range(L - steps, L)), L,
        g.device)
    return dgx, _dr(carry0[2], ys, dgx), dcarry0


def _reverse(g, r, carry0, states, dys, dcarry, dgx, ts):
    """The reverse recurrence over positions ``ts``, the last first, each
    writing its row of ``dgx``: the gradient of the carry before them."""
    c0, n0, h0, m0 = carry0
    cs, ns, ms = states
    dt = h0.dtype
    dc, dn, dh1, dm = _zeros_for(dcarry, carry0)
    dc, dn, dm = dc.float(), dn.float(), dm.float()
    dhr = dh1.to(dt)
    for t in reversed(ts):
        dhf = (dys[:, t] + dhr).float()          # summed in h's type
        z, i, f, o = torch.chunk(g[:, t].float(), 4, dim=-1)
        cp, np_, mp = ((cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t
                       else (c0, n0, m0))
        lf = -_softplus(-f)
        lfm = lf + mp
        m2 = torch.maximum(lfm, i)
        ip, fp, tz = torch.exp(i - m2), torch.exp(lfm - m2), torch.tanh(z)
        c2, n2 = fp * cp + ip * tz, fp * np_ + ip
        so = torch.sigmoid(o)
        den = torch.clamp_min(n2, 1.0)
        d_a = dhf / den
        dden = -dhf * ((so * c2 / den) / den)
        dn2 = dn + torch.where(n2 >= 1.0, dden, 0.0)
        dc2 = dc + d_a * so
        d_o = d_a * c2 * (1 - so) * so
        dfp = dc2 * cp + dn2 * np_
        dip = dc2 * tz + dn2
        dz = dc2 * ip * (1 - tz * tz)
        dxi, dxf = dip * ip, dfp * fp
        dm2 = dm - dxi - dxf
        half = 0.5 * dm2
        dlfm = dxf + torch.where(lfm > i, dm2, torch.where(lfm < i, 0.0,
                                                             half))
        di = dxi + torch.where(i > lfm, dm2, torch.where(i < lfm, 0.0, half))
        x, dsp = -f, -dlfm
        e = torch.exp(-x.abs())
        df = -(dsp * (x >= 0) + (-((dsp / (1 + e)) * e)) * torch.sign(x))
        dg = torch.cat([dz, di, df, d_o], dim=-1).to(g.dtype)
        dgx[:, t] = dg
        dhr = torch.einsum("bhk,hdk->bhd", dg.to(dt), r)
        dc, dn, dm = dc2 * fp, dn2 * fp, dlfm
    return dc, dn, dhr, dm


def slstm_scan_bwd(g, r, carry0, states, ys, dys, dcarry):
    """``(dgx, dr, (dc0, dn0, dh0, dm0))`` of ``slstm_scan``'s outputs,
    given the forward's saved ``g`` and ``states = (cs, ns, ms)``, its
    carry in and outputs ys, and the gradients ``dys`` and ``dcarry`` (each
    may be None: zero): the CUDA kernel on CUDA tensors, the plain version
    on the CPU.  ``slstm_scan_bwd.launches`` counts the kernel's launches
    (one per call; dr is a torch product after it)."""
    dev = g.device
    if plain_device(g):
        return slstm_scan_bwd_plain(g, r, carry0, states, ys, dys, dcarry)
    if dev.type != "cuda":
        raise ValueError(f"slstm_scan_bwd: no kernel for {dev}")
    _check(g, r, carry0)
    beyond = _beyond(g, r, carry0)
    if beyond:
        raise ValueError(beyond)
    B, L, H, four_dh = g.shape
    dh = four_dh // 4
    c0, n0, h0, m0 = (t.contiguous() for t in carry0)
    g, cs, ns, ms = (_tma_ready(t.contiguous()) for t in (g, *states))
    r = r.contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()
    keep = [None if t is None else t.contiguous() for t in dcarry]
    keep.insert(0, None if dys is None else _tma_ready(dys.contiguous()))
    dgx = torch.empty((B, L, H, four_dh), dtype=g.dtype, device=dev)
    dc0, dn0, dm0 = (torch.empty_like(c0) for _ in range(3))
    dh0 = torch.empty_like(h0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().slstm_bwd_launch(
            g.data_ptr(), r.data_ptr(), c0.data_ptr(),
            n0.data_ptr(), m0.data_ptr(), cs.data_ptr(), ns.data_ptr(),
            ms.data_ptr(), *(ptr(t) for t in keep), dgx.data_ptr(),
            dc0.data_ptr(), dn0.data_ptr(), dh0.data_ptr(), dm0.data_ptr(),
            _DTYPES[g.dtype], B, L, H, dh, stream)
    if err != 0:
        raise RuntimeError(f"slstm_bwd launch failed: CUDA error {err}")
    slstm_scan_bwd.launches += 1
    return dgx, _dr(h0, ys, dgx), (dc0, dn0, dh0, dm0)


slstm_scan_bwd.launches = 0


class SLSTMScanFn(torch.autograd.Function):
    """``slstm_scan`` with its backward kernel: inputs ``gx, r, c, n, h,
    m``, outputs ``ys, c', n', h', m'``.  Saves the gate inputs, each
    position's c, n, m, ys, r and the carry in (the module note)."""

    @staticmethod
    def forward(ctx, gx, r, c, n, h, m):
        ctx.set_materialize_grads(False)
        ys, carry, (g, cs, ns, ms) = slstm_scan(gx, r, (c, n, h, m),
                                                save=True)
        ctx.save_for_backward(g, r, c, n, h, m, cs, ns, ms, ys)
        return (ys, *carry)

    @staticmethod
    def backward(ctx, dys, dc, dn, dh, dm):
        g, r, c, n, h, m, cs, ns, ms, ys = ctx.saved_tensors
        dgx, dr, dcarry = slstm_scan_bwd(g, r, (c, n, h, m), (cs, ns, ms),
                                         ys, dys, (dc, dn, dh, dm))
        return (dgx, dr, *dcarry)


def scan(gx: torch.Tensor, r: torch.Tensor, carry: tuple):
    """``slstm_scan`` that autograd can differentiate (see the module
    note): ``(ys, carry')``."""
    if not needs_grad(gx, r, *carry):
        return slstm_scan(gx, r, carry)
    if not plain_device(gx):
        _check(gx, r, carry)
        beyond = _beyond(gx, r, carry)
        if beyond:
            raise NotImplementedError(beyond)
    ys, *out = SLSTMScanFn.apply(gx, r, *carry)
    return ys, tuple(out)
