"""The gradient of the port's attention kernel against autograd and the JAX
reference.

``attention_bwd_plain`` (the backward kernel's plain version, which the
CPU takes) is held against ``torch.autograd`` through the plain forward
and against ``jax.vjp`` of the reference's ``_sdpa`` (the function the
reference trains through; it has no backward kernel), on the same numpy
inputs and cotangents, causal and not, with GQA groups of 1, 2 and 6 and both
layouts, and non-causal with Sq != Skv (the VLM's cross-attention).  Tolerance:
float32 throughout, ``max |port - other| <= 1e-5 * max |other|`` per gradient:
both sides sum the same products in other orders (the reads are about 3e-7).

Also: ``FlashAttentionFn`` / ``attention`` (what the model layer calls with
a gradient required) give those gradients; a mask the backward does not
cover raises; a kernel call on tensors off the CPU that require grad
raises instead of returning an output autograd cannot see (the ``meta``
device stands in for the card here); without a gradient the layer calls
the forward kernel as serving does.  The ``cuda``-marked cases hold the
CUDA kernel against the plain version on the card and skip elsewhere
(``python -m pytest -m cuda tests/test_torch_attention_grad.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (FlashAttentionFn, attention,
                                                 attention_bwd_plain,
                                                 attention_plain,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 lse_buffer)
from repro_torch.models import layers as TL

REL = 1e-5
# (B, S, Hq, Hkv, D)
SHAPES = [(2, 37, 4, 4, 16), (2, 64, 4, 2, 16), (1, 50, 6, 1, 8),
          (2, 33, 4, 2, 80)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite's test
    workers share the cores, and torch's default pool (a thread per core
    in each worker) oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, B, S, Hq, Hkv, D, Skv=None):
    """q and the cotangent ``[B, S, Hq, D]``, k and v ``[B, Skv, Hkv, D]``
    (``Skv`` defaults to S)."""
    Skv = S if Skv is None else Skv
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    return q, k, v, do


def close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    err = np.abs(ours - ref).max()
    assert err <= REL * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_of_plain_forward(shape, causal):
    q, k, v, do = (torch.tensor(x) for x in inputs(0, *shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention_plain(*leaves, causal=causal)
    want = torch.autograd.grad(o, leaves, do)
    got = attention_bwd_plain(q, k, v, o.detach(), do, causal=causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        close(g, w)


def jax_sdpa_vjp(q, k, v, do, causal):
    """The reference ``_sdpa``'s output and ``jax.vjp`` at ``do``.  JAX is
    imported here: the card's machine, where the ``cuda`` cases run, has
    none."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as RL

    @jax.jit                 # faster than op-by-op dispatch
    def value_and_vjp(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: RL._sdpa(a, b, c, causal),
                           q, k, v)
        return out, vjp(do)
    return value_and_vjp(q, k, v, jnp.asarray(do))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp_of_sdpa(shape, causal):
    q, k, v, do = inputs(1, *shape)
    out, want = jax_sdpa_vjp(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o = attention_plain(tq, tk, tv, causal=causal)
    close(o, out)
    for g, w in zip(attention_bwd_plain(tq, tk, tv, o, tdo, causal=causal),
                    want):
        close(g, w)


# (B, Sq, Skv, Hq, Hkv, D): the reduced VLM's cross-attention (a context
# of 16 rows under 64 queries), and the other way round
CROSS_SHAPES = [(2, 64, 16, 4, 1, 16), (1, 16, 64, 4, 2, 16)]


@pytest.mark.parametrize("shape", CROSS_SHAPES)
def test_plain_backward_at_sq_ne_skv_matches_jax_vjp_of_sdpa(shape):
    """Non-causal, Sq != Skv: the cross-attention's gradients."""
    B, Sq, Skv, Hq, Hkv, D = shape
    q, k, v, do = inputs(8, B, Sq, Hq, Hkv, D, Skv=Skv)
    out, want = jax_sdpa_vjp(q, k, v, do, False)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o = attention_plain(tq, tk, tv, causal=False)
    close(o, out)
    got = attention_bwd_plain(tq, tk, tv, o, tdo, causal=False)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape
        close(g, w)


def test_mixed_types_train_through_the_float32_function():
    """float32 q over bf16 k and v (a float32 VLM's cross-attention over a
    bf16 context): ``attention`` runs the Function on the upcast inputs,
    returns bf16, and hands each input its gradient in its own type."""
    q, k, v, do = inputs(9, 2, 64, 4, 1, 16, Skv=16)
    leaves = [torch.tensor(q, requires_grad=True),
              torch.tensor(k).bfloat16().requires_grad_(),
              torch.tensor(v).bfloat16().requires_grad_()]
    o = attention(*leaves, causal=False)
    assert o.dtype == torch.bfloat16
    o.backward(torch.tensor(do).bfloat16())
    up = [t.detach().float().requires_grad_() for t in leaves]
    want_o = FlashAttentionFn.apply(*up, False, None)
    want_o.bfloat16().backward(torch.tensor(do).bfloat16())
    assert torch.equal(o.detach(), want_o.detach().bfloat16())
    for t, u in zip(leaves, up):
        assert t.grad.dtype == t.dtype
        assert torch.equal(t.grad, u.grad.to(t.dtype))


def test_tpu_layout_matches_model_layout():
    """``[BH, S, D]`` (one kv head per query head) gives the model
    layout's gradients, head by head."""
    q, k, v, do = (torch.tensor(x) for x in inputs(2, 1, 40, 3, 3, 16))
    o = attention_plain(q, k, v)
    got = attention_bwd_plain(*(t[0].transpose(0, 1) for t in (q, k, v, o,
                                                               do)))
    want = attention_bwd_plain(q, k, v, o, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w[0].transpose(0, 1), rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_function_gives_the_jax_gradients(causal):
    """``attention`` with a gradient required goes through
    ``FlashAttentionFn``: its forward is the plain version here, its
    backward ``attention_bwd_plain``, and the gradients are the
    reference's."""
    q, k, v, do = inputs(3, 2, 48, 4, 2, 16)
    _, want = jax_sdpa_vjp(q, k, v, do, causal)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = attention(*leaves, causal=causal)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    o.backward(torch.tensor(do))
    for t, w in zip(leaves, want):
        close(t.grad, w)


def test_model_layer_takes_the_function_only_with_a_gradient():
    q, k, v, _ = (torch.tensor(x) for x in inputs(4, 1, 32, 4, 4, 16))
    out = TL.sdpa_chunked(q, k, v, causal=True, q_chunk=16)
    assert out.grad_fn is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = TL.sdpa_chunked(*leaves, causal=True, q_chunk=16)
    assert type(got.grad_fn).__name__ == "FlashAttentionFnBackward"
    torch.testing.assert_close(got.detach(), out, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert TL.sdpa_chunked(*leaves, causal=True, q_chunk=16).grad_fn \
            is None


@pytest.mark.parametrize("kw", [{"q_offset": 3}, {"kv_len": 20}])
def test_grad_with_a_cache_mask_raises(kw):
    q, k, v, _ = (torch.tensor(x, requires_grad=True)
                  for x in inputs(5, 1, 32, 2, 2, 16))
    with pytest.raises(NotImplementedError, match="q_offset = 0"):
        attention(q, k, v, **kw)
    with torch.no_grad():                    # serving: allowed
        attention(q, k, v, **kw)


def test_kernel_call_off_the_cpu_that_requires_grad_raises():
    """The forward kernel's output has no ``grad_fn``: with a gradient
    required, a call off the CPU raises rather than detach silently."""
    q = torch.empty((1, 32, 2, 16), device="meta", requires_grad=True)
    k = torch.empty((1, 32, 2, 16), device="meta")
    with pytest.raises(NotImplementedError, match="grad.attention"):
        flash_attention(q, k, k)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_bwd(q.detach(), k, k, q.detach(), q.detach())


def _logsumexp(q, k, causal):
    """Each query row's log-sum-exp of the scaled (masked) scores, float32,
    ``[B, Hq, Sq]``: what the forward hands the bf16 backward kernel."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1:3]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
    s = (qf @ kf.transpose(-1, -2)) / D ** 0.5
    if causal:
        s = s.masked_fill(torch.ones(Sq, Skv, dtype=torch.bool,
                                     device=q.device).triu(1), -1e30)
    return torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_forward_fills_the_lse_buffer(causal):
    """On the CPU ``flash_attention(..., lse=)`` fills the rows' log-sum-exp
    as the kernel does (rows past Sq in the rounded-up buffer untouched)."""
    q, k, v, _ = (torch.tensor(x) for x in inputs(9, 2, 37, 4, 2, 16))
    lse = lse_buffer(q)
    assert lse.shape == (2, 4, 64) and lse.dtype == torch.float32
    lse.fill_(7.0)
    out = flash_attention(q, k, v, causal=causal, lse=lse)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))
    torch.testing.assert_close(lse[..., :37], _logsumexp(q, k, causal),
                               rtol=0, atol=1e-5)
    assert bool((lse[..., 37:] == 7.0).all())
    with pytest.raises(ValueError, match="lse"):
        flash_attention(q, k, v, lse=lse[:, :, :30])


def test_function_saves_inputs_and_output():
    q, k, v, _ = (torch.tensor(x, requires_grad=True)
                  for x in inputs(6, 1, 16, 2, 1, 8))
    o = FlashAttentionFn.apply(q, k, v, True, None)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 4 and torch.equal(saved[3], o.detach())


def _cuda_case(B, S, Hq, Hkv, D, causal, dtype, seed=0, Skv=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    q, k, v, do = (torch.tensor(x).to("cuda", dtype)
                   for x in inputs(seed, B, S, Hq, Hkv, D, Skv=Skv))
    o = flash_attention(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, o, do, causal=causal)
    want = attention_bwd_plain(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    return got, want


def _hold(got, want, dtype):
    """bf16 elementwise within 2e-2 (rtol and atol, both sides round the
    float32 sums once); float32 within 2e-5 of the largest gradient."""
    for g, w in zip(got, want):
        assert g.dtype == dtype
        if dtype == torch.bfloat16:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-2)
        else:
            assert (g - w).abs().max() <= 2e-5 * w.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", [(2, 100, 4, 2, 80, True),
                                  (2, 130, 4, 4, 64, False),
                                  (1, 256, 8, 2, 128, True)])
def test_cuda_kernel_matches_plain(case, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    _hold(*_cuda_case(*case, dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", CROSS_SHAPES[:1]
                         + [(1, 1024, 4096, 64, 8, 128)])
def test_cuda_kernel_matches_plain_at_sq_ne_skv(shape, bf16):
    """Non-causal, Sq != Skv, at the reduced VLM's cross shape and at the
    full width's (64 query heads over 8 kv heads, a 4 096-row context)."""
    B, Sq, Skv, Hq, Hkv, D = shape
    dtype = torch.bfloat16 if bf16 else torch.float32
    _hold(*_cuda_case(B, Sq, Hq, Hkv, D, False, dtype, Skv=Skv), dtype)


@pytest.mark.cuda
def test_cuda_function_trains_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    q, k, v, do = (torch.tensor(x).cuda() for x in inputs(7, 1, 64, 4, 2, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention_bwd.launches
    attention(*leaves).backward(do)
    assert flash_attention_bwd.launches == before + 1
    want = attention_bwd_plain(q, k, v, attention_plain(q, k, v), do)
    for t, w in zip(leaves, want):
        assert (t.grad - w).abs().max() <= 2e-5 * w.abs().max()


# zamba2-2.7b's training shape: its shared attention (B, S, Hq, Hkv, D)
ZAMBA2_TRAIN = (4, 1024, 32, 32, 80)


@pytest.mark.cuda
def test_cuda_kernel_gives_the_same_bits_twice():
    """bf16 at zamba2's training shape: two calls on the same inputs (the
    forward's lse) give the same bits; every output element is written by
    one thread in a fixed order, with no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    B, S, Hq, Hkv, D = ZAMBA2_TRAIN
    q, k, v, do = (torch.tensor(x).to("cuda", torch.bfloat16)
                   for x in inputs(11, B, S, Hq, Hkv, D))
    lse = lse_buffer(q)
    o = flash_attention(q, k, v, lse=lse)
    first = flash_attention_bwd(q, k, v, o, do, lse=lse)
    second = flash_attention_bwd(q, k, v, o, do, lse=lse)
    without = flash_attention_bwd(q, k, v, o, do)     # lse recomputed
    torch.cuda.synchronize()
    for x, y, z in zip(first, second, without):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", [(2, 100, 4, 2, 80, True),
                                  (1, 130, 4, 4, 128, False),
                                  (4, 1024, 32, 32, 80, True)])
def test_cuda_forward_lse_is_the_logsumexp(case, bf16):
    """The forward kernel's lse output against ``torch.logsumexp`` of the
    plain scores, within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    B, S, Hq, Hkv, D, causal = case
    dtype = torch.bfloat16 if bf16 else torch.float32
    q, k, v, _ = (torch.tensor(x).to("cuda", dtype)
                  for x in inputs(12, B, S, Hq, Hkv, D))
    lse = lse_buffer(q)
    flash_attention(q, k, v, causal=causal, lse=lse)
    torch.testing.assert_close(lse[..., :S], _logsumexp(q, k, causal),
                               rtol=0, atol=1e-5)


# scripts/flash_forward_bits.py's digests of the forward kernel's outputs
# as they were before the kernel had an lse output (NVIDIA H100 80GB HBM3)
FORWARD_BITS = {
    "2,300,300,8,2,80,1,0,None,torch.bfloat16":
        "42580d860f6393c9909925738963903bb0a45561a5dbc4ec79c1792bd520771a",
    "1,200,520,4,4,128,1,300,500,torch.bfloat16":
        "2e00b128d0562c66a2c325cb3cb2972e3609644b3cb6ee8382cad169cece207a",
    "2,100,100,4,2,64,1,0,None,torch.float32":
        "a33d371ed3d6b2fdf12a9fc5dfa47d7a4c233b46a17557a6e265fa5a321cdb95"}


@pytest.mark.cuda
def test_cuda_forward_bits_unchanged():
    """Serving's forward (no lse) gives the bits it gave before the lse
    output existed, on seeded inputs; with the lse output it gives the
    same bits too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
            / "flash_forward_bits.py")
    spec = importlib.util.spec_from_file_location("flash_forward_bits", path)
    bits = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bits)
    assert bits.digests(flash_attention, torch) == FORWARD_BITS

    def with_lse(q, k, v, **kw):
        return flash_attention(q, k, v, lse=lse_buffer(q), **kw)
    assert bits.digests(with_lse, torch) == FORWARD_BITS
