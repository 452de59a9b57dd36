"""The port's sLSTM recurrence (``kernels/slstm``) against the JAX reference
and against autograd.

``slstm_scan_plain`` (the loop of ``_slstm_cell`` the CPU takes, and the
kernel's plain version) and its autograd are held against the reference's
``lax.scan`` of ``_slstm_cell`` and its ``jax.vjp``, in float32, with a
carry in and out (also from the zero carry, where ``n == 1`` exactly and
the port's ``clamp_min`` and the reference's ``maximum`` pass different
shares of the gradient that cancel; and an L = 1 decode step), to 1e-5
of the largest entry.  ``slstm_scan_bwd_plain`` (the backward kernel's
plain version) is held against autograd of ``slstm_scan_plain``: float32
to 1e-5 of the largest entry, bf16 to 2e-2 (autograd sums r's gradient
one position at a time in bf16; the plain version, like the kernel, in
one float32 product).  ``scan`` takes ``SLSTMScanFn`` only with a
gradient; on the card (the ``meta`` device stands in here) a call the
kernels do not take raises.  The ``cuda``-marked cases hold the kernels
against their plain versions on the card and skip elsewhere
(``python -m pytest -m cuda tests/test_torch_slstm.py``).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.slstm import (SLSTMScanFn, scan, slstm,
                                       slstm_scan, slstm_scan_bwd,
                                       slstm_scan_bwd_plain, slstm_scan_plain)
from repro_torch.kernels.slstm.kernel import _tma_ready

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite's test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, B, L, H, dh, zero_carry=False):
    """gx [B, L, H, 4 dh], r [H, dh, 4 dh], the carry (c, n, h, m) and
    cotangents of ys and of the carry out, float32 numpy."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    gx, r = f32(B, L, H, 4 * dh), f32(H, dh, 4 * dh, scale=dh ** -0.5)
    if zero_carry:
        carry = tuple(np.zeros((B, H, dh), np.float32) for _ in range(4))
    else:
        carry = (f32(B, H, dh), (0.5 + rng.random((B, H, dh))).astype(
            np.float32), f32(B, H, dh, scale=0.3), f32(B, H, dh))
    cot = (f32(B, L, H, dh),) + tuple(f32(B, H, dh) for _ in range(4))
    return gx, r, carry, cot


def ref_scan_and_vjp(gx, r, carry, cot):
    """The reference's ``lax.scan`` of ``_slstm_cell`` (as its
    ``slstm_apply`` runs it; JAX imported here: the card's machine has
    none) and its ``jax.vjp`` for the cotangents ``cot``."""
    import jax

    from repro.models import blocks as RB

    def f(gx, r, c, n, h, m):
        carry, ys = jax.lax.scan(lambda cr, g: RB._slstm_cell(cr, g, r),
                                 (c, n, h, m), gx.swapaxes(0, 1))
        return ys.swapaxes(0, 1), carry

    @jax.jit
    def run(gx, r, carry, cot):
        out, vjp = jax.vjp(f, gx, r, *carry)
        return out, vjp((cot[0], tuple(cot[1:])))
    (ys, carry_out), grads = run(gx, r, carry, cot)
    return np.asarray(ys), [np.asarray(x) for x in carry_out], [
        np.asarray(g) for g in grads]


def close(ours, ref, rel=REL):
    ours = ours.detach().float().numpy() if isinstance(
        ours, torch.Tensor) else np.asarray(ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (err,
                                                         np.abs(ref).max())


def weighted(ys, carry, cot):
    return (ys.float() * cot[0].float()).sum() + sum(
        (x.float() * w.float()).sum() for x, w in zip(carry, cot[1:]))


@pytest.mark.parametrize("L, zero_carry", [(8, False), (6, True), (1, False)])
def test_plain_scan_and_autograd_match_reference(L, zero_carry):
    """Forward, carry out and every input's gradient; L = 1 is a decode
    step from the cache's carry.  From the zero carry, position 0 has
    ``n == 1`` exactly wherever ``i >= log sigmoid(f)``: the port's
    ``clamp_min`` passes the whole gradient there and the reference's
    ``maximum`` half, and the two paths cancel in every gradient but that
    of the carry's own n (the zero carry of training and prefill, which
    nothing learns), so that one is left out there."""
    gx, r, carry, cot = inputs(0, 2, L, 3, 8, zero_carry)
    ys_ref, carry_ref, grads_ref = ref_scan_and_vjp(gx, r, carry, cot)
    leaves = [torch.tensor(x, requires_grad=True) for x in (gx, r, *carry)]
    ys, carry_out = slstm_scan_plain(leaves[0], leaves[1], tuple(leaves[2:]))
    close(ys, ys_ref)
    for x, w in zip(carry_out, carry_ref):
        close(x, w)
    grads = torch.autograd.grad(weighted(ys, carry_out, [
        torch.tensor(c) for c in cot]), leaves)
    for i, (g, w) in enumerate(zip(grads, grads_ref)):
        if not (zero_carry and i == 3):
            close(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_autograd_of_plain_forward(dtype):
    gx, r, carry, cot = inputs(1, 2, 10, 3, 16)
    tens = [torch.tensor(x).to(dtype if i in (0, 1, 4) else torch.float32)
            for i, x in enumerate((gx, r, *carry))]
    cot = [torch.tensor(c).to(dtype if i in (0, 3) else torch.float32)
           for i, c in enumerate(cot)]
    leaves = [t.clone().requires_grad_() for t in tens]
    ys, carry_out = slstm_scan_plain(leaves[0], leaves[1], tuple(leaves[2:]))
    want = torch.autograd.grad(weighted(ys, carry_out, cot), leaves)
    ys2, _, saved = slstm_scan_plain(tens[0], tens[1], tuple(tens[2:]),
                                     save=True)
    assert torch.equal(ys2, ys.detach())
    dgx, dr, dcarry = slstm_scan_bwd_plain(saved[0], tens[1], tuple(tens[2:]),
                                           saved[1:], ys2, cot[0],
                                           tuple(cot[1:]))
    rel = REL if dtype == torch.float32 else 2e-2
    for g, w in zip((dgx, dr, *dcarry), want):
        assert g.dtype == w.dtype
        close(g, w.float(), rel)


def test_function_matches_reference_vjp_and_saves_what_it_reads():
    """Through ``scan`` with a gradient required (``SLSTMScanFn``): the
    reference's gradients; the Function saves the gate inputs, each
    position's c, n, m, ys, r and the carry in."""
    gx, r, carry, cot = inputs(2, 2, 7, 2, 8)
    ys_ref, carry_ref, grads_ref = ref_scan_and_vjp(gx, r, carry, cot)
    leaves = [torch.tensor(x, requires_grad=True) for x in (gx, r, *carry)]
    ys, carry_out = scan(leaves[0], leaves[1], tuple(leaves[2:]))
    assert type(ys.grad_fn).__name__ == "SLSTMScanFnBackward"
    assert len(ys.grad_fn.saved_tensors) == 10
    close(ys, ys_ref)
    weighted(ys, carry_out, [torch.tensor(c) for c in cot]).backward()
    for t, w in zip(leaves, grads_ref):
        close(t.grad, w)


def test_scan_takes_the_function_only_with_a_gradient():
    gx, r, carry, _ = (torch.tensor(x) if not isinstance(x, tuple) else
                       tuple(torch.tensor(c) for c in x)
                       for x in inputs(3, 1, 5, 2, 8))
    ys, _ = scan(gx, r, carry)
    assert ys.grad_fn is None
    assert torch.equal(slstm(gx, r, carry)[0], ys)  # the model-layout name
    ys2, _ = scan(gx.clone().requires_grad_(), r, carry)
    assert type(ys2.grad_fn).__name__ == "SLSTMScanFnBackward"
    assert torch.equal(ys2.detach(), ys)


def meta(*shape, grad=False, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype, requires_grad=grad)


def meta_call(dh, gx_dtype=torch.bfloat16, r_dtype=torch.bfloat16):
    gx = meta(2, 4, 2, 4 * dh, grad=True, dtype=gx_dtype)
    r = meta(2, dh, 4 * dh, dtype=r_dtype)
    carry = (meta(2, 2, dh), meta(2, 2, dh), meta(2, 2, dh, dtype=r_dtype),
             meta(2, 2, dh))
    return gx, r, carry


@pytest.mark.parametrize("dh, gx_dtype, match", [
    (512, torch.bfloat16, "dh <= 256"),
    (16, torch.float32, "one type"),
    (24, torch.bfloat16, "bf16 kernel takes dh a multiple of 16"),
    (18, torch.float32, "float32 kernel takes dh a multiple of 4")])
def test_uncovered_grad_call_off_the_cpu_raises(dh, gx_dtype, match):
    """On the card a grad-requiring call the kernels do not take (dh over
    256, gx and h of different types, dh off the tensor-core k-steps of 16
    in bf16 or off TMA's 16-byte rows in float32) raises instead of
    detaching."""
    r_dtype = (torch.bfloat16 if match == "one type" else gx_dtype)
    gx, r, carry = meta_call(dh, gx_dtype, r_dtype)
    with pytest.raises(NotImplementedError, match=match):
        scan(gx, r, carry)


def test_covered_grad_call_off_the_cpu_takes_the_function():
    """xlstm-350m's shapes (dh 256, bf16) pass the limits and reach the
    Function, whose forward kernel refuses the ``meta`` device; a direct
    kernel call that requires grad raises."""
    gx, r, carry = meta_call(256)
    with pytest.raises(ValueError, match="no kernel"):
        scan(gx, r, carry)
    with pytest.raises(NotImplementedError, match="grad.scan"):
        slstm_scan(gx, r, carry)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        slstm_scan(gx, r, carry)


def _proj(dtype, width, cut, start=0):
    """Column slice [start, start + cut) of a [2, 3, 2, width] projection:
    strides (3 * 2 * width, 2 * width, width, 1)."""
    proj = torch.arange(2 * 3 * 2 * width, dtype=torch.float32).reshape(
        2, 3, 2, width).to(dtype)
    return proj[..., start:start + cut]


@pytest.mark.parametrize("dtype, width, cut, start", [
    (torch.bfloat16, 64, 64, 0), (torch.bfloat16, 96, 64, 0),
    (torch.bfloat16, 96, 64, 16), (torch.float32, 24, 16, 4)])
def test_tma_ready_keeps_aligned_views(dtype, width, cut, start):
    """A view whose strides are multiples of 16 bytes, with its base
    16-byte aligned and its last dimension contiguous, is handed to TMA as
    it is (the same storage and strides)."""
    t = _proj(dtype, width, cut, start)
    got = _tma_ready(t)
    assert got is t


@pytest.mark.parametrize("what", ["odd row stride", "offset base",
                                  "strided last dim", "offset contiguous"])
def test_tma_ready_copies_what_tma_cannot_read(what):
    """A row stride off 16 bytes, a base off 16 bytes (a column slice
    from an odd column, or a contiguous tensor at an element offset), or a
    strided last dimension: a contiguous copy, 16-byte aligned, equal in
    value."""
    if what == "odd row stride":        # bf16 rows of 100 elements
        t = _proj(torch.bfloat16, 100, 64)
    elif what == "offset base":         # starts 2 bytes into a row
        t = _proj(torch.bfloat16, 96, 64, 1)
    elif what == "strided last dim":
        t = _proj(torch.float32, 32, 32)[..., ::2]
    else:                               # contiguous, 4 bytes in
        t = torch.arange(1 + 2 * 3 * 16, dtype=torch.float32)[1:].view(
            2, 3, 16)
        assert t.is_contiguous() and t.data_ptr() % 16
    got = _tma_ready(t)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert got.data_ptr() != t.data_ptr()
    assert torch.equal(got, t)


def test_kernel_modules_import_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.kernels.slstm, repro_torch.kernels.ssd_scan\n"
            "import repro_torch.models.blocks\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _cuda_inputs(B, L, H, dh, dtype, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    gx, r, carry, cot = inputs(seed, B, L, H, dh)
    dev = "cuda"
    t = [torch.tensor(x, device=dev) for x in (gx, r, *carry)]
    t[0], t[1], t[4] = (x.to(dtype) for x in (t[0], t[1], t[4]))
    c = [torch.tensor(x, device=dev) for x in cot]
    c[0], c[3] = c[0].to(dtype), c[3].to(dtype)
    return t[0], t[1], tuple(t[2:]), c[0], tuple(c[1:])


def _hold(got, want, dtype):
    rel = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max()
        assert err <= rel * w.float().abs().max(), (err, w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [
    ((2, 16, 4, 16), torch.float32), ((2, 16, 4, 16), torch.bfloat16),
    ((3, 64, 2, 256), torch.float32), ((9, 32, 2, 64), torch.bfloat16),
    ((4, 1, 4, 256), torch.bfloat16), ((4, 1024, 4, 256), torch.bfloat16),
    ((8, 64, 2, 256), torch.bfloat16), ((16, 48, 2, 256), torch.bfloat16),
    ((4, 96, 4, 128), torch.bfloat16), ((2, 40, 2, 20), torch.float32),
    ((4, 1024, 4, 256), torch.float32)])
def test_cuda_kernels_match_plain(shape, dtype):
    """Forward (ys and the carry out) and backward (dgx, dr, the carry
    in's gradients, both fed the forward kernel's saved values) against
    the plain versions: bf16 within 2e-2, float32 within 2e-5 of the
    largest entry; each kernel's second call gives the same bits."""
    gx, r, carry, dys, dcarry = _cuda_inputs(*shape, dtype)
    ys, c1, saved = slstm_scan(gx, r, carry, save=True)
    pys, pc1 = slstm_scan_plain(gx, r, carry)
    _hold((ys, *c1), (pys, *pc1), dtype)
    again = slstm_scan(gx, r, carry, save=True)
    assert all(torch.equal(x, y) for x, y in zip(
        (ys, *c1, *saved), (again[0], *again[1], *again[2])))

    def bwd(fn):
        dgx, dr, dc = fn(saved[0], r, carry, saved[1:], ys, dys, dcarry)
        return (dgx, dr, *dc)
    got = bwd(slstm_scan_bwd)
    _hold(got, bwd(slstm_scan_bwd_plain), dtype)
    assert all(torch.equal(x, y) for x, y in zip(got, bwd(slstm_scan_bwd)))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_kernel_reads_a_column_slice_of_a_projection():
    """gx as columns [64, 64 + 4 dh) of a wider bf16 projection, which the
    kernel's TMA reads with its own strides (no copy): within 2e-2 of the
    plain version and the same bits as from a contiguous gx."""
    gx, r, carry, _, _ = _cuda_inputs(4, 64, 4, 256, torch.bfloat16)
    proj = torch.zeros((4, 64, 4, 4 * 256 + 128), dtype=gx.dtype,
                       device=gx.device)
    proj[..., 64:64 + 4 * 256] = gx
    view = proj[..., 64:64 + 4 * 256]
    assert not view.is_contiguous() and _tma_ready(view) is view
    ys, c1 = slstm_scan(view, r, carry)
    pys, pc1 = slstm_scan_plain(gx, r, carry)
    _hold((ys, *c1), (pys, *pc1), torch.bfloat16)
    ys2, c2 = slstm_scan(gx, r, carry)
    assert all(torch.equal(x, y) for x, y in zip((ys, *c1), (ys2, *c2)))


@pytest.mark.cuda
def test_cuda_function_trains_through_the_kernels():
    """``scan`` with a gradient on the card launches the forward kernel
    once and the backward kernel once."""
    gx, r, carry, dys, _ = _cuda_inputs(2, 64, 2, 64, torch.bfloat16)
    gx.requires_grad_()
    fwd0, bwd0 = slstm_scan.launches, slstm_scan_bwd.launches
    ys, _ = scan(gx, r, carry)
    assert isinstance(ys.grad_fn, SLSTMScanFn._backward_cls)
    ys.backward(dys)
    assert (slstm_scan.launches - fwd0, slstm_scan_bwd.launches - bwd0) == (
        1, 1)
    assert torch.isfinite(gx.grad.float()).all()
