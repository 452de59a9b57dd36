"""The port's SSD scan kernel wrapper and its plain version against the JAX
reference.

Inputs come from a numpy seed and go to both packages.  The reference runs
as its own tests run it (``tests/test_kernels.py``): the Pallas kernel in
interpret mode and its oracle (``use_kernel=False``, which is the model
layer ``gla_chunked``), on that file's shapes and with its tolerances, 2e-5
in float32 and 2e-2 in bf16 (rtol and atol).  The in-chunk prefix sums take
the association of ``jnp.cumsum`` on the CPU (``blocked_cumsum``): the
gates are differences of prefix sums near -100, and with another
association the float32 outputs move by about 1e-4 relative, past the
reference's own tolerance.

Also: Mamba-2's q and k broadcast over heads (head stride 0, no copy), the
state carried across chunks (the reference's running-sum case), the TPU
layout ``[BH, L, N]``, and the model layer ``gla_chunked`` and ``gla_step``.
The CUDA kernel runs only on a GPU: the ``cuda``-marked tests skip
elsewhere (``python -m pytest -m cuda tests/test_torch_ssd_scan.py`` on the
card).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import gla, ssd_scan, ssd_scan_plain
from repro_torch.models import layers as TL

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# tests/test_kernels.py's shapes: (B, L, H, N, P, chunk)
GLA_SHAPES = [(1, 128, 1, 16, 16, 64), (2, 256, 2, 64, 64, 128),
              (1, 512, 4, 32, 64, 128), (1, 256, 2, 64, 64, 256)]


def inputs(seed, B, L, H, N, P, *, heads_qk=None, slow=False):
    """q, k, v and a <= 0 (``-softplus`` of a normal draw, or with ``slow``
    the slow decay ``-0.01 U[0, 1)`` that Mamba-2's small dt gives),
    float32 numpy; ``heads_qk=1`` draws q and k once and broadcasts them
    over heads."""
    rng = np.random.default_rng(seed)
    hq = heads_qk or H
    q = rng.standard_normal((B, L, hq, N)).astype(np.float32)
    k = rng.standard_normal((B, L, hq, N)).astype(np.float32)
    v = rng.standard_normal((B, L, H, P)).astype(np.float32)
    if slow:
        a = (-0.01 * rng.random((B, L, H))).astype(np.float32)
    else:
        a = -np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(
            np.float32)
    return q, k, v, a


def to_torch(q, k, v, a, dt=torch.float32, device="cpu"):
    H = v.shape[2]
    tq, tk = (torch.tensor(x).to(device, dt).expand(-1, -1, H, -1)
              for x in (q, k))
    return tq, tk, torch.tensor(v).to(device, dt), torch.tensor(a).to(device)


def to_jax(q, k, v, a, bf16=False):
    import jax.numpy as jnp
    H = v.shape[2]
    dt = jnp.bfloat16 if bf16 else jnp.float32
    jq, jk = (jnp.broadcast_to(jnp.asarray(x, dt), x.shape[:2] + (H,)
                               + x.shape[3:]) for x in (q, k))
    return jq, jk, jnp.asarray(v, dt), jnp.asarray(a)


def close(ours, ref, tol):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("B,L,H,N,P,chunk", GLA_SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_gla_matches_reference_kernel_and_oracle(B, L, H, N, P, chunk, bf16):
    from repro.kernels.ssd_scan import gla as ref_gla
    x = inputs(L + N, B, L, H, N, P)
    j = to_jax(*x, bf16=bf16)
    t = to_torch(*x, dt=torch.bfloat16 if bf16 else torch.float32)
    before = ssd_scan.launches
    ours = gla(*t, chunk=chunk)
    assert ssd_scan.launches == before             # CPU: no kernel launch
    assert ours.dtype == t[2].dtype and ours.shape == (B, L, H, P)
    tol = BF16_TOL if bf16 else F32_TOL
    close(ours, ref_gla(*j, chunk=chunk, interpret=True), tol)
    close(ours, ref_gla(*j, chunk=chunk, use_kernel=False), tol)
    assert torch.equal(gla(*t, chunk=chunk, use_kernel=False), ours)


@pytest.mark.parametrize("L,chunk", [(48, 16), (256, 64), (64, 64)])
def test_layer_gla_chunked_with_broadcast_qk(L, chunk):
    """Mamba-2's shapes: q and k shared by every head (a stride-0 view)."""
    from repro.models import layers as RL
    x = inputs(L, 2, L, 4, 16, 16, heads_qk=1)
    t = to_torch(*x)
    assert t[0].stride(2) == 0
    close(TL.gla_chunked(*t, chunk), RL.gla_chunked(*to_jax(*x), chunk),
          F32_TOL)


def test_state_carries_across_chunks():
    """a = 0: the output at position t is the running sum of k^T v (the
    reference's own check that the state survives chunk boundaries)."""
    B, L, H, N, P = 1, 256, 1, 8, 8
    q = torch.ones((B, L, H, N)) / N
    k = torch.ones((B, L, H, N))
    v = torch.ones((B, L, H, P))
    a = torch.zeros((B, L, H))
    out = ssd_scan(q, k, v, a, chunk=64)
    np.testing.assert_allclose(out[0, :, 0, 0].numpy(),
                               np.arange(1, L + 1, dtype=np.float32),
                               rtol=1e-5)


def test_tpu_layout_matches_reference_kernel():
    from repro.kernels.ssd_scan import ssd_scan as ref_scan
    import jax.numpy as jnp
    q, k, v, a = inputs(9, 1, 128, 6, 16, 32)
    flat = [np.ascontiguousarray(x[0].swapaxes(0, 1)) for x in (q, k, v, a)]
    ours = ssd_scan(*(torch.tensor(x) for x in flat), chunk=32)
    assert ours.shape == (6, 128, 32)
    close(ours, ref_scan(*(jnp.asarray(x) for x in flat), chunk=32,
                         interpret=True), F32_TOL)


def test_gla_step_matches_reference():
    from repro.models import layers as RL
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    state = rng.standard_normal((2, 3, 8, 5)).astype(np.float32)
    q, k = (rng.standard_normal((2, 3, 8)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 3, 5)).astype(np.float32)
    a = -np.abs(rng.standard_normal((2, 3))).astype(np.float32)
    rs, ro = RL.gla_step(*(jnp.asarray(x) for x in (state, q, k, v, a)))
    ts, to = TL.gla_step(*(torch.tensor(x) for x in (state, q, k, v, a)))
    close(ts, rs, F32_TOL)
    close(to, ro, F32_TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 32, 2, 8)
    v = torch.zeros(1, 32, 2, 4)
    a = torch.zeros(1, 32, 2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(q, q, v, a, chunk=24)
    with pytest.raises(TypeError, match="a is"):
        ssd_scan(q, q, v, a.double(), chunk=16)
    with pytest.raises(TypeError, match="want all"):
        ssd_scan(q, q.bfloat16(), v, a, chunk=16)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan(q, q, v, a[:, :, :1], chunk=16)
    with pytest.raises(ValueError, match="seq len"):
        TL.gla_chunked(q[:, :30], q[:, :30], v[:, :30], a[:, :30], 16)


# ----------------- the bf16 kernel's operand precision ---------------------

def _once(x):
    return x.bfloat16().float()


def _split(x, terms=2):
    """x as a sum of ``terms`` bf16 values: bf16(x), bf16(x - that), ...
    (the bf16 kernel multiplies three)."""
    out = torch.zeros_like(x)
    for _ in range(terms):
        out = out + (x - out).bfloat16().float()
    return out


def _kernel_operands(q, k, v, a, chunk, rnd):
    """The bf16 kernel's products in float32, every float32-held operand it
    gives the tensor cores passed through ``rnd``: the gated scores G and
    the decayed k (each times v) and the state entering a chunk (times q).
    q, k and v hold bf16 values, so their own products are exact; the inter
    term scales q . state by exp(cum) after the product, as the kernel
    does.  [B, L, H, X] in, float32 out."""
    from repro_torch.kernels.scar_eval.kernel import blocked_cumsum
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    af = a.float().transpose(1, 2)
    B, H, L, N = qf.shape
    state = qf.new_zeros((B, H, N, vf.shape[-1]))
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    outs = []
    for c0 in range(0, L, chunk):
        qc, kc, vc = (t[:, :, c0:c0 + chunk] for t in (qf, kf, vf))
        cum = blocked_cumsum(af[:, :, c0:c0 + chunk].movedim(-1, 0)).movedim(
            0, -1)
        total = cum[..., -1:]
        rel = cum[..., :, None] - cum[..., None, :]
        gate = torch.where(tril, torch.exp(torch.where(tril, rel, 0.0)), 0.0)
        intra = rnd((qc @ kc.transpose(-1, -2)) * gate) @ vc
        inter = torch.exp(cum)[..., None] * (qc @ rnd(state))
        outs.append(intra + inter)
        k_dec = rnd(kc * torch.exp(total - cum)[..., None])
        state = (state * torch.exp(total)[..., None]
                 + k_dec.transpose(-1, -2) @ vc)
    return torch.cat(outs, dim=2).transpose(1, 2)


def test_bf16_operand_split_meets_the_tolerance_one_rounding_breaks():
    """Slow decay, B 1, L 1024, H 8, N = P = 64, chunk 256, q and k
    broadcast: rounding G, the decayed k and the state once to bf16 puts
    outputs beyond rtol = atol = 2e-2 of the float32 plain version; a split
    into two bf16 terms (hi + lo, two products each) puts none there, and
    neither do the kernel's three."""
    x = inputs(11, 1, 1024, 8, 64, 64, heads_qk=1, slow=True)
    q, k, v, a = (t.bfloat16().float() if t.dtype == torch.float32
                  and i < 3 else t for i, t in enumerate(to_torch(*x)))
    ref = ssd_scan_plain(q, k, v, a, chunk=256)

    def beyond(out):
        return int(((out - ref).abs() > 2e-2 + 2e-2 * ref.abs()).sum())

    assert beyond(_kernel_operands(q, k, v, a, 256, _once)) > 1000
    assert beyond(_kernel_operands(q, k, v, a, 256, _split)) == 0
    assert beyond(_kernel_operands(
        q, k, v, a, 256, lambda x: _split(x, terms=3))) == 0


# ------------------------------ on the card --------------------------------

CUDA_CASES = [
    # (B, L, H, N, P, chunk, q and k broadcast over heads)
    (1, 128, 1, 16, 16, 16, False),
    (2, 256, 2, 64, 64, 64, False),
    (2, 48, 4, 16, 16, 16, True),
    (1, 512, 3, 64, 64, 256, True),
    (1, 200, 2, 32, 48, 40, False),
    (4, 1024, 80, 64, 64, 256, True),      # the zamba2-2.7b serve shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_matches_plain(case, bf16):
    """On the card: the CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, L, H, N, P, chunk, shared = case
    dt = torch.bfloat16 if bf16 else torch.float32
    t = to_torch(*inputs(L + P, B, L, H, N, P,
                         heads_qk=1 if shared else None), dt=dt,
                 device="cuda")
    before = ssd_scan.launches
    out = ssd_scan(*t, chunk=chunk)
    plain = ssd_scan_plain(*t, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    close(out.cpu(), plain.float().cpu().numpy(),
          BF16_TOL if bf16 else F32_TOL)


SLOW_CASES = [
    # (B, L, H, N, P, chunk, q and k broadcast): slow decay, >= 4 chunks
    (1, 1024, 8, 64, 64, 256, True),
    (2, 256, 4, 32, 48, 64, False),
    (4, 1024, 80, 64, 64, 256, True),      # the serve shape
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SLOW_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_matches_plain_on_slow_decay(case, bf16):
    """On the card, a = -0.01 U[0, 1).  bf16: where rounding the kernel's
    float32-held operands once to bf16 would break 2e-2 (the CPU test
    above).  float32: the state sums up to 1024 barely decayed steps into
    outputs of several hundred, so an output near zero carries the
    summation order's own error (about 1e-4) beyond an elementwise 2e-5;
    the kernel is held to 2e-5 of the largest plain output, which a state
    lost or taken twice would break by far."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, L, H, N, P, chunk, shared = case
    t = to_torch(*inputs(L + N + P, B, L, H, N, P,
                         heads_qk=1 if shared else None, slow=True),
                 dt=torch.bfloat16 if bf16 else torch.float32,
                 device="cuda")
    before = ssd_scan.launches
    out = ssd_scan(*t, chunk=chunk)
    plain = ssd_scan_plain(*t, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    if bf16:
        close(out.cpu(), plain.float().cpu().numpy(), BF16_TOL)
    else:
        assert bool(torch.isfinite(out).all())
        assert (out - plain).abs().max().item() <= \
            F32_TOL["atol"] * plain.abs().max().item()


@pytest.mark.cuda
def test_cuda_bf16_zero_decay_is_the_exact_running_sum():
    """On the card, bf16, a = 0 over 8 chunks of 256, N = P = 64, q and k
    broadcast: with entries in {-1, 0, 1} every product and sum is an
    integer float32 holds exactly, so each output is the exact causal sum
    rounded once to bf16, and a state lost or taken twice anywhere in the
    chain of chunks shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    q, k = (torch.tensor(rng.integers(-1, 2, (2, 2048, 1, 64))).to(
        "cuda", torch.bfloat16).expand(2, 2048, 4, 64) for _ in range(2))
    v = torch.tensor(rng.integers(-1, 2, (2, 2048, 4, 64))).to(
        "cuda", torch.bfloat16)
    exact = torch.einsum(
        "bhij,bjhp->bihp",
        torch.einsum("bihn,bjhn->bhij", q.double(), k.double()).tril(),
        v.double())
    out = ssd_scan(q, k, v, torch.zeros((2, 2048, 4), device="cuda"),
                   chunk=256)
    assert torch.equal(out, exact.to(torch.bfloat16))


@pytest.mark.cuda
def test_cuda_bf16_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bf = dict(device="cuda", dtype=torch.bfloat16)
    a = torch.zeros((1, 64, 2), device="cuda")
    q = torch.zeros((1, 64, 2, 264), **bf)
    with pytest.raises(ValueError, match="kernel takes N 264"):
        ssd_scan(q, q, torch.zeros((1, 64, 2, 16), **bf), a, chunk=64)
    q = torch.zeros((1, 64, 2, 12), **bf)
    with pytest.raises(ValueError, match="cp.async"):
        ssd_scan(q, q, torch.zeros((1, 64, 2, 16), **bf), a, chunk=64)
    big = torch.zeros((1, 512, 2, 16), **bf)
    with pytest.raises(ValueError, match="chunk 512"):
        ssd_scan(big, big, big, torch.zeros((1, 512, 2), device="cuda"),
                 chunk=512)


WIDE_CASES = [
    # (B, L, H, N, P, chunk, normaliser): the wide bf16 kernel
    (4, 1024, 4, 256, 256, 256, True),     # the xlstm-350m serve shape
    (1, 512, 2, 256, 256, 256, False),
    (2, 96, 4, 16, 16, 16, True),          # reduced xlstm
    (1, 200, 2, 128, 72, 40, True),        # a narrow last column tile
    (1, 256, 2, 96, 96, 64, False),        # past the narrow kernel's 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("slow", [False, True])
def test_cuda_wide_heads_match_plain(case, slow):
    """On the card, bf16 heads wider than 64 (one CTA per 64 state
    columns), with and without the normaliser the same launch computes:
    output and normaliser within rtol = atol = 2e-2 of the plain version's
    two calls, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, L, H, N, P, chunk, norm = case
    t = to_torch(*inputs(L + N + P, B, L, H, N, P, slow=slow),
                 dt=torch.bfloat16, device="cuda")
    before = ssd_scan.launches
    out = ssd_scan(*t, chunk=chunk, norm=norm)
    plain = ssd_scan_plain(*t, chunk=chunk, norm=norm)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    for o, p in zip(out, plain) if norm else [(out, plain)]:
        close(o.cpu(), p.float().cpu().numpy(), BF16_TOL)


@pytest.mark.cuda
def test_cuda_wide_zero_decay_is_the_exact_running_sum():
    """On the card, bf16, a = 0 over 4 chunks of 256 at N = P = 256 with
    the normaliser: entries in {-1, 0, 1} make every product and sum an
    integer float32 holds exactly, so each output and each normaliser is
    the exact causal sum rounded once to bf16, and a state tile or
    normaliser state lost or taken twice shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.integers(-1, 2, (1, 1024, 2, 256))).to(
        "cuda", torch.bfloat16) for _ in range(3))
    scores = torch.einsum("bihn,bjhn->bhij", q.double(), k.double()).tril()
    out, den = ssd_scan(q, k, v, torch.zeros((1, 1024, 2), device="cuda"),
                        chunk=256, norm=True)
    assert torch.equal(out, torch.einsum("bhij,bjhp->bihp", scores,
                                         v.double()).to(torch.bfloat16))
    assert torch.equal(den, scores.sum(-1).transpose(1, 2).to(
        torch.bfloat16))
