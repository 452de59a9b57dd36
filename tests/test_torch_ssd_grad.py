"""The gradient of the port's SSD scan kernel against autograd and the JAX
reference.

``ssd_scan_bwd_plain`` (the backward kernel's plain version, which the CPU
takes) is held against ``torch.autograd`` through the plain forward and
against ``jax.vjp`` of the reference's ``gla_chunked`` (the function the
reference trains through; it has no backward kernel), for q, k, v and the
log-decay a, on the same numpy inputs and cotangents: several chunks, q
and k broadcast over heads (Mamba-2: their gradients summed over heads by
the ``expand``), slow decay, the TPU layout.  Tolerance: float32, ``max
|port - other| <= 2e-5 * max |other|`` per gradient (da gathers the whole
sequence in a reverse sum, the others sum products in other orders; the
reads are below 1e-6).

Also: ``SSDScanFn`` / ``scan`` (what the model layer calls with a
gradient required) give those gradients; with the normaliser (the
mLSTM's ``norm=True``) ``SSDScanNormFn`` gives those of ``jax.vjp`` of
the reference's two ``gla_chunked`` calls (numerator and ``v = 1``), and
the plain normaliser backward those of autograd through
``ssd_scan_plain(norm=True)``; the bf16 wide kernel's form of the
normaliser (a rank-1 term: dden added to the score tile, the N-vectors n
and dn carried beside the states), written as a small plain function,
gives the extra column's gradients; every bf16 shape the backward
kernels admit reaches the wide kernels as they take it; on the card (the ``meta`` device stands
in here) a grad-requiring call beyond both backward kernels (bf16 N or P
over 256, float32 over 128) raises, as does a direct kernel call.  The
``cuda``-marked cases hold the CUDA kernels (``ssd_scan_bwd`` and, for
wide heads and the normaliser, ``ssd_wide_bwd``) against the plain
version on the card and skip elsewhere (``python -m pytest -m cuda
tests/test_torch_ssd_grad.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import aligned16
from repro_torch.kernels.scar_eval.kernel import blocked_cumsum
from repro_torch.kernels.ssd_scan import (SSDScanFn, scan, ssd_scan,
                                          ssd_scan_bwd, ssd_scan_bwd_plain,
                                          ssd_scan_plain, ssd_wide_bwd)
from repro_torch.kernels.ssd_scan import grad as G
from repro_torch.models import layers as TL

REL = 2e-5
# (B, L, H, N, P, chunk, q and k broadcast over heads, slow decay)
CASES = [(2, 64, 3, 8, 5, 16, False, False),
         (1, 96, 4, 16, 16, 32, True, False),
         (2, 48, 2, 16, 8, 48, True, False),
         (1, 128, 2, 16, 16, 32, True, True),
         (1, 40, 2, 8, 8, 8, False, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite's test
    workers share the cores, and torch's default pool (a thread per core
    in each worker) oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, B, L, H, N, P, broadcast, slow):
    """q, k ([B, L, 1 or H, N]), v, the cotangent do ([B, L, H, P]) and
    a <= 0 ([B, L, H]), float32 numpy."""
    rng = np.random.default_rng(seed)
    hq = 1 if broadcast else H
    q = rng.standard_normal((B, L, hq, N)).astype(np.float32)
    k = rng.standard_normal((B, L, hq, N)).astype(np.float32)
    v = rng.standard_normal((B, L, H, P)).astype(np.float32)
    do = rng.standard_normal((B, L, H, P)).astype(np.float32)
    if slow:
        a = (-0.01 * rng.random((B, L, H))).astype(np.float32)
    else:
        a = -np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(
            np.float32)
    return q, k, v, do, a


def close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= REL * np.abs(ref).max(), (err, np.abs(ref).max())


def expanded(q, k, H):
    B, L, _, N = q.shape
    return q.expand(B, L, H, N), k.expand(B, L, H, N)


def jax_grads(q, k, v, do, a, chunk):
    """``jax.vjp`` of the reference layer (q and k broadcast inside).
    JAX is imported here: the card's machine, where the ``cuda`` cases
    run, has none."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as RL
    H = v.shape[2]

    def f(q, k, v, a):
        B, L, _, N = q.shape
        return RL.gla_chunked(jnp.broadcast_to(q, (B, L, H, N)),
                              jnp.broadcast_to(k, (B, L, H, N)), v, a, chunk)

    @jax.jit                 # a tenth of the time of op-by-op dispatch
    def value_and_vjp(q, k, v, a, do):
        out, vjp = jax.vjp(f, q, k, v, a)
        return out, vjp(do)
    return value_and_vjp(q, k, v, a, do)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_of_plain_forward(case):
    B, L, H, N, P, c, bc, slow = case
    q, k, v, do, a = (torch.tensor(x) for x in inputs(0, B, L, H, N, P, bc,
                                                      slow))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, a)]
    qe, ke = expanded(leaves[0], leaves[1], H)
    out = ssd_scan_plain(qe, ke, leaves[2], leaves[3], chunk=c)
    want = torch.autograd.grad(out, leaves, do)
    qe, ke = expanded(q, k, H)
    dq, dk, dv, da = ssd_scan_bwd_plain(qe, ke, v, a, do, chunk=c)
    assert dq.shape == (B, L, H, N) and da.dtype == torch.float32
    got = (dq.sum(2, keepdim=True) if bc else dq,
           dk.sum(2, keepdim=True) if bc else dk, dv, da)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("case", CASES)
def test_function_matches_jax_vjp_of_gla_chunked(case):
    """Through ``SSDScanFn`` (``scan`` with a gradient required): the
    per-head dq and dk summed over heads by autograd's ``expand``
    backward, da for the log-decay."""
    B, L, H, N, P, c, bc, slow = case
    q, k, v, do, a = inputs(1, B, L, H, N, P, bc, slow)
    out, want = jax_grads(q, k, v, do, a, c)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, a)]
    qe, ke = expanded(leaves[0], leaves[1], H)
    got = scan(qe, ke, leaves[2], leaves[3], chunk=c)
    assert type(got.grad_fn).__name__ == "SSDScanFnBackward"
    close(got, out)
    got.backward(torch.tensor(do))
    for t, w in zip(leaves, want):
        close(t.grad, w)


def test_tpu_layout_matches_model_layout():
    q, k, v, do, a = (torch.tensor(x) for x in inputs(2, 1, 64, 3, 8, 4,
                                                      False, False))
    want = ssd_scan_bwd_plain(q, k, v, a, do, chunk=16)
    got = ssd_scan_bwd_plain(*(t[0].transpose(0, 1) for t in (q, k, v, a,
                                                               do)),
                             chunk=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w[0].transpose(0, 1), rtol=0, atol=0)


def test_model_layer_takes_the_function_only_with_a_gradient():
    q, k, v, _, a = (torch.tensor(x) for x in inputs(3, 1, 32, 2, 8, 8,
                                                     True, False))
    qe, ke = expanded(q, k, 2)
    out = TL.gla_chunked(qe, ke, v, a, 16)
    assert out.grad_fn is None
    vg = v.clone().requires_grad_()
    got = TL.gla_chunked(qe, ke, vg, a, 16)
    assert type(got.grad_fn).__name__ == "SSDScanFnBackward"
    torch.testing.assert_close(got.detach(), out, rtol=0, atol=0)


def test_cpu_normaliser_takes_plain_autograd():
    """The normalised call takes ``SSDScanNormFn`` on the CPU too (mLSTM
    training), with the plain backward: the gradients of autograd through
    the plain forward."""
    q, k, v, _, a = (torch.tensor(x) for x in inputs(4, 1, 32, 2, 8, 8,
                                                     False, False))
    vg = v.clone().requires_grad_()
    num, den = scan(q, k, vg, a, chunk=16, norm=True)
    assert type(num.grad_fn).__name__ == "SSDScanNormFnBackward"
    (num.sum() + den.sum()).backward()
    vp = v.clone().requires_grad_()
    pn, pd = ssd_scan_plain(q, k, vp, a, chunk=16, norm=True)
    (pn.sum() + pd.sum()).backward()
    close(vg.grad, vp.grad)
    assert vg.grad.abs().sum() > 0


# (B, L, H, N, P, chunk, q and k broadcast, slow decay): the normaliser
NORM_CASES = [(2, 64, 3, 8, 5, 16, False, False),
              (1, 96, 2, 16, 16, 32, False, True)]


def jax_norm_grads(q, k, v, do, dden, a, chunk):
    """``jax.vjp`` of the reference mLSTM's two ``gla_chunked`` calls: the
    numerator and the normaliser (``v = 1``)."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as RL

    def f(q, k, v, a):
        ones = jnp.ones(v.shape[:-1] + (1,), v.dtype)
        return (RL.gla_chunked(q, k, v, a, chunk),
                RL.gla_chunked(q, k, ones, a, chunk)[..., 0])

    @jax.jit
    def value_and_vjp(q, k, v, a, do, dden):
        out, vjp = jax.vjp(f, q, k, v, a)
        return out, vjp((do, dden))
    return value_and_vjp(q, k, v, a, do, dden)


@pytest.mark.parametrize("case", NORM_CASES)
def test_normalised_function_matches_jax_vjp_of_two_gla_chunked(case):
    B, L, H, N, P, c, bc, slow = case
    q, k, v, do, a = inputs(6, B, L, H, N, P, bc, slow)
    dden = np.random.default_rng(7).standard_normal(a.shape).astype(
        np.float32)
    (out, den), want = jax_norm_grads(q, k, v, do, dden, a, c)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, a)]
    got_o, got_d = scan(*leaves, chunk=c, norm=True)
    assert type(got_o.grad_fn).__name__ == "SSDScanNormFnBackward"
    close(got_o, out)
    close(got_d, den)
    torch.autograd.backward((got_o, got_d), (torch.tensor(do),
                                             torch.tensor(dden)))
    for t, w in zip(leaves, want):
        close(t.grad, w)


@pytest.mark.parametrize("case", NORM_CASES + [
    (1, 64, 2, 64, 64, 16, True, False)])
def test_plain_normaliser_backward_matches_autograd(case):
    """``ssd_scan_bwd_plain(..., dden=)`` against autograd through the
    plain forward's two scans (``norm=True``)."""
    B, L, H, N, P, c, bc, slow = case
    q, k, v, do, a = (torch.tensor(x) for x in inputs(8, B, L, H, N, P, bc,
                                                      slow))
    dden = torch.tensor(np.random.default_rng(9).standard_normal(
        a.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, a)]
    qe, ke = expanded(leaves[0], leaves[1], H)
    o, den = ssd_scan_plain(qe, ke, leaves[2], leaves[3], chunk=c, norm=True)
    want = torch.autograd.grad((o, den), leaves, (do, dden))
    qe, ke = expanded(q, k, H)
    dq, dk, dv, da = ssd_wide_bwd(qe, ke, v, a, do, chunk=c, dden=dden)
    assert dv.shape == v.shape
    got = (dq.sum(2, keepdim=True) if bc else dq,
           dk.sum(2, keepdim=True) if bc else dk, dv, da)
    for g, w in zip(got, want):
        close(g, w)


def rank1_normaliser(q, k, a, dden, chunk):
    """The normaliser's share of ``(dq, dk, da)`` as the bf16 wide kernel
    forms it, in float32 ([B, L, H, .] inputs): per chunk, with the gate
    ``exp(cum_t - cum_s)`` on s <= t, the score tile gains dden_t (so
    dden_t gated times k_s for dq, times q_t for dk); n_in, the chain of
    the decayed k, adds ``exp(cum_t) dden_t n_in`` to dq_t; dn_out, the
    reverse chain of ``q_t exp(cum_t) dden_t``, adds ``exp(total - cum_s)
    dn_out`` to dk_s; da the reverse sum of their row dots."""
    qf, kf = (t.float().transpose(1, 2) for t in (q, k))
    af, df = a.float().transpose(1, 2), dden.float().transpose(1, 2)
    B, H, L, N = qf.shape
    c = min(chunk, L)
    nc = L // c

    def part(t, i):
        return t[:, :, i * c:(i + 1) * c]

    cums = [blocked_cumsum(part(af, i).movedim(-1, 0)).movedim(0, -1)
            for i in range(nc)]
    n_in, n = [], qf.new_zeros((B, H, N))
    for i in range(nc):
        n_in.append(n)
        cum, total = cums[i], cums[i][..., -1:]
        n = n * torch.exp(total) + (part(kf, i) * torch.exp(
            total - cum)[..., None]).sum(2)
    dn_out, dn = [None] * nc, qf.new_zeros((B, H, N))
    for i in reversed(range(nc)):
        dn_out[i] = dn
        cum, total = cums[i], cums[i][..., -1:]
        dn = dn * torch.exp(total) + (
            part(qf, i) * (torch.exp(cum) * part(df, i))[..., None]).sum(2)
    tril = torch.ones((c, c), dtype=torch.bool).tril()
    dqs, dks = [], []
    for i in range(nc):
        cum, total = cums[i], cums[i][..., -1:]
        rel = cum[..., :, None] - cum[..., None, :]
        gate = torch.where(tril, torch.exp(torch.where(tril, rel, 0.0)), 0.0)
        g_dd = part(df, i)[..., :, None] * gate               # [t, s]
        dqs.append(g_dd @ part(kf, i) + (torch.exp(cum) * part(df, i))[
            ..., None] * n_in[i][..., None, :])
        dks.append(g_dd.transpose(-1, -2) @ part(qf, i)
                   + torch.exp(total - cum)[..., None]
                   * dn_out[i][..., None, :])
    dq, dk = (torch.cat(t, dim=2) for t in (dqs, dks))
    r = (qf * dq).sum(-1) - (kf * dk).sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(r, [-1]), -1), [-1])
    return dq.transpose(1, 2), dk.transpose(1, 2), da.transpose(1, 2)


@pytest.mark.parametrize("case", [(2, 64, 3, 8, 5, 16, False, False),
                                  (1, 96, 2, 16, 16, 32, False, True),
                                  (1, 200, 2, 48, 80, 100, False, False),
                                  (2, 64, 1, 64, 16, 64, False, True)])
def test_rank1_normaliser_matches_the_extra_column(case):
    """The numerator's gradients plus the rank-1 normaliser terms give
    ``ssd_scan_bwd_plain(..., dden=)`` (v with a column of ones, dO with
    the column dden): dq, dk and da within 1e-5 of the largest entry, dv
    the numerator's alone."""
    B, L, H, N, P, c, _, slow = case
    q, k, v, do, a = (torch.tensor(x) for x in inputs(16, B, L, H, N, P,
                                                      False, slow))
    dden = torch.tensor(np.random.default_rng(17).standard_normal(
        a.shape).astype(np.float32))
    want = ssd_scan_bwd_plain(q, k, v, a, do, chunk=c, dden=dden)
    num = ssd_scan_bwd_plain(q, k, v, a, do, chunk=c)
    terms = rank1_normaliser(q, k, a, dden, c)
    got = (num[0] + terms[0], num[1] + terms[1], num[2], num[3] + terms[2])
    for g_, w in zip(got, want):
        assert g_.shape == w.shape
        assert (g_ - w).abs().max() <= 1e-5 * w.abs().max()


def test_every_admitted_bf16_shape_meets_the_wide_kernels_needs():
    """Every bf16 shape the backward kernels admit (``_beyond``: N and P
    multiples of 16 up to 256, chunks up to 256 rows) reaches the bf16
    ``ssd_wide_bwd`` launch as its library takes it (``tc_ok``: N and P
    multiples of 16; after ``aligned16``, 16 B aligned pointers, strides
    multiples of 8 elements, a contiguous last dimension), also for q, k
    and v as views of one projection at an offset TMA cannot read and dO
    head-major; ``_beyond`` refuses shapes off that grid."""
    for N in range(16, 257, 16):
        for P in range(16, 257, 16):
            for c in (16, 100, 256):
                assert G._beyond(N, P, c, torch.bfloat16) == ""
                B, L, H, W = 1, c, 1, 2 * N + P + 4
                buf = torch.arange(L * W, dtype=torch.bfloat16).reshape(
                    B, L, H, W)
                views = (buf[..., 4:4 + N], buf[..., 4 + N:4 + 2 * N],
                         buf[..., 4 + 2 * N:W],
                         torch.ones((B, H, L, P), dtype=torch.bfloat16
                                    ).transpose(1, 2))
                for t in views:
                    got = aligned16(t)
                    assert torch.equal(got, t)
                    assert got.data_ptr() % 16 == 0 and got.stride(-1) == 1
                    assert all(s % 8 == 0 for s in got.stride()[:-1])
    for N, P, c in ((40, 16, 16), (16, 272, 16), (16, 16, 512)):
        assert G._beyond(N, P, c, torch.bfloat16)


def meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


@pytest.mark.parametrize("N, P, norm, bf16", [(512, 16, False, True),
                                              (256, 16, True, False),
                                              (16, 256, False, False)])
def test_uncovered_grad_call_off_the_cpu_raises(N, P, norm, bf16):
    """Beyond both backward kernels (bf16 N or P over 256, float32 over
    128, with or without the normaliser) a grad-requiring call raises,
    stating the limits, instead of detaching."""
    dt = torch.bfloat16 if bf16 else torch.float32
    q = meta(1, 32, 2, N, grad=True).to(dt)
    k, v = meta(1, 32, 2, N).to(dt), meta(1, 32, 2, P).to(dt)
    with pytest.raises(NotImplementedError, match="backward kernels take"):
        scan(q, k, v, meta(1, 32, 2), chunk=16, norm=norm)


@pytest.mark.parametrize("N, norm, bf16", [(256, True, True),
                                           (128, True, False),
                                           (16, True, False)])
def test_xlstm_grad_call_off_the_cpu_reaches_the_function(N, norm, bf16):
    """xlstm-350m's mLSTM (bf16 N = P = 256 with the normaliser) and the
    reduced float32 one pass the limits and reach ``SSDScanNormFn``,
    whose forward kernel refuses the ``meta`` device."""
    dt = torch.bfloat16 if bf16 else torch.float32
    q = meta(1, 32, 2, N, grad=True).to(dt)
    k, v = meta(1, 32, 2, N).to(dt), meta(1, 32, 2, N).to(dt)
    with pytest.raises(ValueError, match="no kernel"):
        scan(q, k, v, meta(1, 32, 2), chunk=16, norm=norm)


@pytest.mark.parametrize("N, P", [(8, 16), (16, 40)])
def test_bf16_grad_call_off_the_cpu_with_heads_off_16_raises(N, P):
    """The bf16 backward runs on the tensor cores only, in steps of 16:
    other bf16 widths raise (float32 takes them)."""
    q = meta(1, 32, 2, N, grad=True).bfloat16()
    k, v = meta(1, 32, 2, N).bfloat16(), meta(1, 32, 2, P).bfloat16()
    with pytest.raises(NotImplementedError, match="multiples of 16"):
        scan(q, k, v, meta(1, 32, 2), chunk=16)


@pytest.mark.parametrize("view", ["aligned", "offset", "broadcast"])
def test_aligned16_copies_only_what_16_byte_loads_cannot_read(view):
    """``aligned16`` (what the bf16 wrappers apply) returns an aligned
    tensor as it is, and copies one at an odd offset into fresh storage,
    keeping a broadcast (stride 0) head dimension broadcast."""
    base = torch.arange(2 * 24 * 16, dtype=torch.bfloat16).reshape(2, 24, 16)
    t = {"aligned": base[:, 8:],
         "offset": base.flatten()[1:1 + 2 * 8 * 16].reshape(2, 8, 16),
         "broadcast": base.flatten()[3:3 + 2 * 8 * 16].reshape(
             2, 8, 1, 16).expand(2, 8, 5, 16)}[view]
    got = aligned16(t)
    assert torch.equal(got, t)
    assert got.data_ptr() % 16 == 0
    assert all(s % 8 == 0 for s in got.stride()[:-1])
    assert (got.data_ptr() == t.data_ptr()) == (view == "aligned")
    if view == "broadcast":
        assert got.stride(2) == 0


def test_kernel_call_off_the_cpu_that_requires_grad_raises():
    q, k, v, a = meta(1, 32, 2, 16), meta(1, 32, 2, 16), meta(
        1, 32, 2, 16, grad=True), meta(1, 32, 2)
    with pytest.raises(NotImplementedError, match="grad.scan"):
        ssd_scan(q, k, v, a, chunk=16)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        ssd_scan(q, k, v, a, chunk=16)
    with pytest.raises(ValueError, match="no kernel"):
        ssd_scan_bwd(q, k, v.detach(), a, v.detach(), chunk=16)


def test_function_saves_its_inputs():
    q, k, v, _, a = (torch.tensor(x, requires_grad=True)
                     for x in inputs(5, 1, 16, 2, 4, 4, False, False))
    out = SSDScanFn.apply(q, k, v, a, 8)
    assert len(out.grad_fn.saved_tensors) == 4


def _cuda_case(case, dtype, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    B, L, H, N, P, c, bc, slow = case
    q, k, v, do, a = inputs(seed, B, L, H, N, P, bc, slow)
    tq, tk = (torch.tensor(x).to("cuda", dtype).expand(B, L, H, N)
              for x in (q, k))
    tv, tdo = (torch.tensor(x).to("cuda", dtype) for x in (v, do))
    ta = torch.tensor(a).cuda()
    got = ssd_scan_bwd(tq, tk, tv, ta, tdo, chunk=c)
    want = ssd_scan_bwd_plain(tq, tk, tv, ta, tdo, chunk=c)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", [(2, 512, 4, 64, 32, 256, True, False),
                                  (1, 512, 2, 64, 64, 128, False, True),
                                  (2, 96, 3, 16, 16, 16, True, False)])
def test_cuda_kernel_matches_plain(case, bf16):
    """bf16 dq, dk, dv elementwise within 2e-2 (rtol and atol); float32
    ones, and da in both, within 2e-5 of the largest entry."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    got, want = _cuda_case(case, dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        if bf16 and i < 3:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-2)
        else:
            assert (g - w).abs().max() <= 2e-5 * w.abs().max()


def mlstm_views(q, k, v, do, dtype, offset):
    """q, k and v as column slices of one [B, L, H, 2 N + P + offset]
    projection starting ``offset`` elements in, and dO head-major
    ([B, H, L, P] transposed): the layouts an mLSTM's fused projection and
    autograd hand the backward."""
    B, L, H, N = q.shape
    P = v.shape[-1]
    buf = torch.zeros((B, L, H, 2 * N + P + offset), dtype=dtype,
                      device="cuda")
    views = []
    for x, at in ((q, offset), (k, offset + N), (v, offset + 2 * N)):
        view = buf[..., at:at + x.shape[-1]]
        view.copy_(torch.tensor(x))
        views.append(view)
    tdo = torch.tensor(do).to("cuda", dtype).transpose(1, 2).contiguous(
        ).transpose(1, 2)
    return (*views, tdo)


@pytest.mark.cuda
@pytest.mark.parametrize("case, norm, bf16", [
    ((1, 64, 2, 16, 16, 16, False, False), True, False),
    ((2, 256, 3, 128, 96, 128, False, True), True, False),
    ((1, 512, 2, 128, 64, 256, False, False), False, True),
    ((4, 1024, 4, 256, 256, 256, False, False), True, True),
    ((2, 1024, 2, 256, 256, 256, False, True), True, True),
    ((2, 256, 3, 48, 80, 128, False, False), True, True),
    ((1, 200, 2, 80, 48, 100, False, True), False, True),
    ((2, 64, 2, 32, 16, 16, False, False), True, True),
    ((2, 512, 4, 256, 256, 256, "views", False), True, True),
    ((1, 256, 2, 64, 128, 128, "odd views", True), True, True)])
def test_cuda_wide_kernel_matches_plain(case, norm, bf16):
    """``ssd_wide_bwd`` (xLSTM's widths and the normaliser, the fourth case
    xlstm-350m's training shape, the fifth its slow decay a = -0.01 U[0,
    1); N and P off multiples of 64; a chunk of 100 rows; the mLSTM's
    strided views, at an offset TMA reads and at one ``aligned16`` copies)
    against the plain version: bf16 dq, dk, dv within 2e-2 and da, and
    float32, within 2e-5 of the largest entry; a second call gives the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    dtype = torch.bfloat16 if bf16 else torch.float32
    B, L, H, N, P, c, views, slow = case
    q, k, v, do, a = inputs(10, B, L, H, N, P, False, slow)
    if views:
        tq, tk, tv, tdo = mlstm_views(q, k, v, do, dtype,
                                      4 if views == "odd views" else 0)
    else:
        tq, tk, tv, tdo = (torch.tensor(x).to("cuda", dtype)
                           for x in (q, k, v, do))
    ta = torch.tensor(a).cuda()
    dden = (torch.tensor(np.random.default_rng(11).standard_normal(
        a.shape).astype(np.float32)).to("cuda", dtype) if norm else None)
    got = ssd_wide_bwd(tq, tk, tv, ta, tdo, chunk=c, dden=dden)
    want = ssd_scan_bwd_plain(tq, tk, tv, ta, tdo, chunk=c, dden=dden)
    again = ssd_wide_bwd(tq, tk, tv, ta, tdo, chunk=c, dden=dden)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        rel = 2e-2 if bf16 and i < 3 else 2e-5
        assert (g.float() - w.float()).abs().max() <= rel * w.float().abs(
        ).max()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_cuda_kernel_gives_the_same_bits_twice():
    """bf16 at zamba2's training shape (q and k broadcast over 80 heads,
    N = P = 64, chunk 256): two calls on the same inputs give the same
    bits; the states hand-off runs in a fixed order and every output
    element is written by one thread, with no atomics."""
    case = (4, 1024, 80, 64, 64, 256, True, False)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    B, L, H, N, P, c, bc, slow = case
    q, k, v, do, a = inputs(13, B, L, H, N, P, bc, slow)
    tq, tk = (torch.tensor(x).to("cuda", torch.bfloat16).expand(B, L, H, N)
              for x in (q, k))
    tv, tdo = (torch.tensor(x).to("cuda", torch.bfloat16) for x in (v, do))
    ta = torch.tensor(a).cuda()
    first = ssd_scan_bwd(tq, tk, tv, ta, tdo, chunk=c)
    second = ssd_scan_bwd(tq, tk, tv, ta, tdo, chunk=c)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
