"""Gradients through a KV-cache mask against the JAX reference.

The reference differentiates ``_sdpa`` at any ``q_offset`` / ``kv_len``
(``repro/models/layers.py``): query row ``i`` sees kv position ``j`` when
``j < kv_len`` and, if causal, ``j <= i + q_offset``.  The port's
``attention_bwd_plain`` (the backward kernel's plain version, which the CPU
takes) and ``attention(...).backward()`` (``FlashAttentionFn``) are held
against ``jax.vjp`` of ``_sdpa`` on the same numpy inputs and cotangents:
q_offset 0, 5 and 64, ``kv_len`` short of the keys, causal and not, GQA
groups of 2, 3 and 4, float32.  Keys at ``kv_len`` and beyond get zero dK
and dV.  ``attn_apply`` with a cache (the new keys and values written into
it in place at ``cache_index``, where the reference returns an updated copy)
is differentiated against ``jax.vjp`` of the reference layer, with respect
to the weights, the input and the cache's earlier entries.  Tolerance:
``max |port - reference| <= 1e-5 * max |reference|`` per gradient (both
sides sum the same float32 products in other orders).

The ``cuda``-marked cases hold the ``flash_attention_bwd`` kernel under a
cache mask against its plain version on the card (bf16 elementwise within
2e-2, float32 within 2e-5 of the largest gradient) and skip elsewhere.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention,
                                                 attention_bwd_plain,
                                                 attention_plain,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.models import layers as TL

REL = 1e-5
# (B, Sq, Skv, Hq, Hkv, D, q_offset, kv_len)
CASES = [(2, 16, 48, 4, 2, 16, 0, 16),      # a prompt in a longer cache
         (2, 16, 48, 4, 2, 16, 5, 21),      # written at 5, seen to 21
         (1, 16, 96, 6, 2, 16, 64, 80),
         (2, 8, 96, 4, 1, 16, 64, 70)]      # kv_len cuts the causal rows


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, B, Sq, Skv, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, do


def close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= REL * np.abs(ref).max(), (err, np.abs(ref).max())


def jax_sdpa_vjp(q, k, v, do, causal, q_offset, kv_len):
    """``_sdpa``'s output and its ``jax.vjp`` at ``do`` under the mask."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as RL

    @jax.jit                 # faster than op-by-op dispatch
    def value_and_vjp(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: RL._sdpa(a, b, c, causal,
                                                    q_offset, kv_len),
                           q, k, v)
        return out, vjp(do)
    return value_and_vjp(q, k, v, jnp.asarray(do))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp_under_a_cache_mask(case, causal):
    *shape, q_offset, kv_len = case
    q, k, v, do = inputs(1, *shape)
    out, want = jax_sdpa_vjp(q, k, v, do, causal, q_offset, kv_len)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    mask = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    o = attention_plain(tq, tk, tv, **mask)
    close(o, out)
    got = attention_bwd_plain(tq, tk, tv, o, tdo, **mask)
    for g, w in zip(got, want):
        close(g, w)
    # keys the mask hides get no gradient
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_function_backward_matches_jax_vjp_under_a_cache_mask(case,
                                                               causal):
    """``attention`` with a gradient required no longer refuses a cache
    mask: ``FlashAttentionFn`` carries it to its backward."""
    *shape, q_offset, kv_len = case
    q, k, v, do = inputs(2, *shape)
    _, want = jax_sdpa_vjp(q, k, v, do, causal, q_offset, kv_len)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = attention(*leaves, causal=causal, q_offset=q_offset, kv_len=kv_len)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    o.backward(torch.tensor(do))
    for t, w in zip(leaves, want):
        close(t.grad, w)


def test_plain_backward_matches_autograd_of_plain_forward():
    """``attention_bwd_plain`` under a cache mask against autograd through
    the plain forward (the mask at q_offset 5, kv_len 30 of 48)."""
    q, k, v, do = (torch.tensor(x) for x in inputs(3, 2, 16, 48, 6, 2, 16))
    mask = dict(causal=True, q_offset=5, kv_len=30)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention_plain(*leaves, **mask)
    want = torch.autograd.grad(o, leaves, do)
    got = attention_bwd_plain(q, k, v, o.detach(), do, **mask)
    for g, w in zip(got, want):
        close(g, w)


def test_wrapper_takes_the_mask_on_the_cpu():
    """``flash_attention_bwd`` on CPU tensors is the plain version under
    the mask it is given; a ``kv_len`` past the keys is the keys."""
    q, k, v, do = (torch.tensor(x) for x in inputs(4, 1, 8, 32, 4, 2, 16))
    o = attention_plain(q, k, v, q_offset=20, kv_len=28)
    got = flash_attention_bwd(q, k, v, o, do, q_offset=20, kv_len=28)
    want = attention_bwd_plain(q, k, v, o, do, q_offset=20, kv_len=28)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    full = flash_attention_bwd(q, k, v, o, do, q_offset=20, kv_len=99)
    for g, w in zip(full, attention_bwd_plain(q, k, v, o, do, q_offset=20)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_bwd(q, k, v, o, do, q_offset=-1)


def _attn_params(rng, d, n_q, n_kv, hd):
    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)
    return {"wq": {"w": w(d, n_q * hd)}, "wk": {"w": w(d, n_kv * hd)},
            "wv": {"w": w(d, n_kv * hd)}, "wo": {"w": w(n_q * hd, d)}}


@pytest.mark.parametrize("index", [0, 20])
def test_attn_apply_with_a_cache_matches_jax_vjp(index):
    """``attn_apply`` writing S = 8 new keys and values into a 48-row cache
    at ``cache_index`` and attending over it (RoPE at the absolute
    positions): the gradients of the weights, the input and the cache's
    entries (zero where the call overwrites them) are the reference
    layer's ``jax.vjp``."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as RL

    B, S, L, d, n_q, n_kv, hd = 2, 8, 48, 32, 4, 2, 16
    rng = np.random.default_rng(5 + index)
    p = _attn_params(rng, d, n_q, n_kv, hd)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    cache = {n: rng.standard_normal((B, L, n_kv, hd)).astype(np.float32)
             for n in ("k", "v")}
    dout = rng.standard_normal((B, S, d)).astype(np.float32)
    positions = np.arange(index, index + S)[None]
    rdims = RL.AttnDims(d_model=d, n_q=n_q, n_kv=n_kv, hd=hd)

    def ref(p, x, cache):
        return RL.attn_apply(p, x, rdims, causal=True, theta=10000.0,
                             positions=jnp.asarray(positions),
                             cache=cache, cache_index=index)[0]
    @jax.jit
    def value_and_vjp(p, x, cache, dout):
        out, vjp = jax.vjp(ref, p, x, cache)
        return out, vjp(dout)
    out, (want_p, want_x, want_c) = value_and_vjp(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(dout))

    tp = {n: {"w": torch.tensor(v["w"], requires_grad=True)}
          for n, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    tc = {n: torch.tensor(v, requires_grad=True) for n, v in cache.items()}
    live = {n: t.clone() for n, t in tc.items()}     # written in place
    got, new = TL.attn_apply(
        tp, tx, TL.AttnDims(d_model=d, n_q=n_q, n_kv=n_kv, hd=hd),
        causal=True, theta=10000.0, positions=torch.tensor(positions),
        cache=live, cache_index=index)
    assert new is live
    close(got, out)
    got.backward(torch.tensor(dout))
    for n in p:
        close(tp[n]["w"].grad, want_p[n]["w"])
    close(tx.grad, want_x)
    for n in ("k", "v"):
        close(tc[n].grad, want_c[n])
        assert not tc[n].grad[:, index:index + S].any()


def _cuda_case(case, causal, dtype, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    B, Sq, Skv, Hq, Hkv, D, q_offset, kv_len = case
    q, k, v, do = (torch.tensor(x).to("cuda", dtype)
                   for x in inputs(seed, B, Sq, Skv, Hq, Hkv, D))
    mask = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    o = flash_attention(q, k, v, **mask)
    got = flash_attention_bwd(q, k, v, o, do, **mask)
    want = attention_bwd_plain(q, k, v, o, do, **mask)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", [(2, 100, 300, 4, 2, 80, 150, 250),
                                  (1, 256, 1024, 8, 2, 128, 768, 900),
                                  (2, 64, 200, 4, 4, 64, 5, 69)])
def test_cuda_kernel_matches_plain_under_a_cache_mask(case, causal, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    got, want = _cuda_case(case, causal, dtype)
    kv_len = case[-1]
    for g, w in zip(got, want):
        assert g.dtype == dtype
        if dtype == torch.bfloat16:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=2e-2)
        else:
            assert (g - w).abs().max() <= 2e-5 * w.abs().max()
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()
