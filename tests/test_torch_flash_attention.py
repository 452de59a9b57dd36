"""The port's attention kernel wrapper and its plain version against the JAX
reference.

Inputs come from a numpy seed and go to both packages (bf16 inputs are the
same float32 draws rounded to bf16 by each).  The reference runs as its own
tests run it (``tests/test_kernels.py``): the Pallas kernel in interpret
mode and its oracle (``use_kernel=False``), on that file's shapes and with
its tolerances, 2e-5 in float32 and 2e-2 in bf16 (rtol and atol).  Those
use Sq == Skv, the one case where the oracle's bottom-right causal mask,
the Pallas kernel's top-left one and the model layer's
``kv_pos <= q_pos + q_offset`` agree.  The model layer's mask with
``q_offset`` and ``kv_len`` (the serve path's prefill into a longer cache)
is held against the reference's ``layers._sdpa`` and ``sdpa_chunked``.
Mixed types (float32 queries over a bf16 context's keys and values, a
float32 VLM's cross-attention) take the float32 path and return v's type;
against ``_sdpa``, which rounds the probabilities to bf16 as well, within
the bf16 tolerance.

On the CPU the wrapper runs the plain version.  The CUDA kernel runs only
on a GPU: the ``cuda``-marked tests skip elsewhere
(``python -m pytest -m cuda tests/test_torch_flash_attention.py`` on the
card).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention, mha)
from repro_torch.models import layers as TL

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# tests/test_kernels.py's shapes: (B, S, Hq, Hkv, D)
MHA_SHAPES = [(1, 128, 1, 1, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 128),
              (2, 384, 6, 2, 64), (1, 512, 2, 2, 128)]


def draws(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(a, bf16):
    """The same draw as a jax and a torch array, both bf16 or float32."""
    import jax.numpy as jnp
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()
    return jnp.asarray(a), torch.tensor(a)


def close(ours, ref, tol):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("B,S,Hq,Hkv,D", MHA_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_mha_matches_reference_kernel_and_oracle(B, S, Hq, Hkv, D, causal,
                                                 bf16):
    from repro.kernels.flash_attention import mha as ref_mha
    q, k, v = (both(a, bf16) for a in draws(B * S + D, (B, S, Hq, D),
                                             (B, S, Hkv, D), (B, S, Hkv, D)))
    before = flash_attention.launches
    ours = mha(q[1], k[1], v[1], causal=causal)
    assert flash_attention.launches == before      # CPU: no kernel launch
    assert ours.dtype == q[1].dtype and ours.shape == q[1].shape
    tol = BF16_TOL if bf16 else F32_TOL
    close(ours, ref_mha(q[0], k[0], v[0], causal=causal, interpret=True),
          tol)
    close(ours, ref_mha(q[0], k[0], v[0], causal=causal, use_kernel=False),
          tol)
    close(mha(q[1], k[1], v[1], causal=causal, use_kernel=False),
          ref_mha(q[0], k[0], v[0], causal=causal, use_kernel=False), tol)


def test_tpu_layout_matches_reference_kernel():
    """``[BH, S, D]`` inputs (the TPU kernel's layout), GQA group 4."""
    from repro.kernels.flash_attention import flash_attention as ref_flash
    q, k, v = (both(a, False) for a in draws(3, (8, 256, 64), (2, 256, 64),
                                             (2, 256, 64)))
    ours = flash_attention(q[1], k[1], v[1], causal=True)
    assert ours.shape == (8, 256, 64)
    close(ours, ref_flash(q[0], k[0], v[0], causal=True, interpret=True),
          F32_TOL)


@pytest.mark.parametrize("Sq,Skv,q_offset,kv_len,G", [
    (1, 40, 17, 18, 1),       # one decode row into a cache
    (24, 40, 0, 24, 2),       # prefill into a longer cache (serve path)
    (16, 64, 20, 36, 4),      # a later chunk of queries
    (30, 30, 0, None, 1),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_layer_sdpa_with_offset_and_kv_len(Sq, Skv, q_offset,
                                                         kv_len, G, causal):
    import jax.numpy as jnp
    from repro.models import layers as RL
    B, Hkv, D = 2, 2, 16
    q, k, v = (both(a, False) for a in draws(Sq + Skv, (B, Sq, Hkv * G, D),
                                             (B, Skv, Hkv, D),
                                             (B, Skv, Hkv, D)))
    ref = RL._sdpa(q[0], k[0], v[0], causal, jnp.int32(q_offset),
                   None if kv_len is None else jnp.int32(kv_len))
    close(attention_plain(q[1], k[1], v[1], causal=causal,
                          q_offset=q_offset, kv_len=kv_len), ref, F32_TOL)
    close(flash_attention(q[1], k[1], v[1], causal=causal,
                          q_offset=q_offset, kv_len=kv_len), ref, F32_TOL)
    close(TL._sdpa(q[1], k[1], v[1], causal, q_offset, kv_len), ref,
          F32_TOL)


def test_sdpa_chunked_matches_reference_past_q_chunk():
    """Sq = 3 * q_chunk over a longer cache, causal, GQA group 2."""
    import jax.numpy as jnp
    from repro.models import layers as RL
    q, k, v = (both(a, False) for a in draws(5, (2, 48, 4, 16),
                                             (2, 60, 2, 16), (2, 60, 2, 16)))
    ref = RL.sdpa_chunked(q[0], k[0], v[0], True, 16, jnp.int32(0),
                          jnp.int32(48))
    close(TL.sdpa_chunked(q[1], k[1], v[1], True, 16, 0, 48), ref, F32_TOL)
    close(attention_plain(q[1], k[1], v[1], causal=True, kv_len=48), ref,
          F32_TOL)
    with pytest.raises(ValueError, match="multiple of q_chunk"):
        TL.sdpa_chunked(q[1][:, :40], k[1], v[1], True, 16)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, q, q, kv_len=0)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def test_mixed_types_take_the_float32_path():
    """float32 q over bf16 k and v (and bf16 q over float32 k and v): the
    bf16 side upcast, the float32 path, v's type out; the reference's
    ``_sdpa`` on the same mixed inputs within the bf16 tolerance."""
    import jax.numpy as jnp

    from repro.models import layers as RL
    q, k, v = draws(11, (2, 64, 4, 16), (2, 16, 1, 16), (2, 16, 1, 16))
    tq, tk, tv = torch.tensor(q), torch.tensor(k).bfloat16(), \
        torch.tensor(v).bfloat16()
    out = flash_attention(tq, tk, tv, causal=False)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, attention_plain(tq, tk.float(), tv.float(),
                                            causal=False).bfloat16())
    ref = RL._sdpa(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                   jnp.asarray(v, jnp.bfloat16), causal=False)
    assert ref.dtype == jnp.bfloat16
    close(out, ref, BF16_TOL)
    back = flash_attention(tq.bfloat16(), tk.float(), tv.float(),
                           causal=False)
    assert back.dtype == torch.float32
    assert torch.equal(back, attention_plain(tq.bfloat16().float(),
                                             tk.float(), tv.float(),
                                             causal=False))


# ------------------------------ on the card --------------------------------

CUDA_CASES = [
    # (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len)
    (1, 1, 1, 1, 1, 64, True, 0, None),
    (2, 64, 64, 4, 2, 16, True, 0, None),
    (2, 1000, 1000, 8, 1, 80, True, 0, None),
    (1, 100, 300, 4, 4, 128, True, 37, 200),
    (2, 48, 68, 4, 2, 80, True, 0, 48),
    (1, 256, 256, 2, 2, 64, False, 0, None),
    (1, 33, 97, 8, 8, 80, False, 0, 61),
    (2, 100, 300, 4, 4, 80, True, 37, 200),    # D 80, q_offset and kv_len
    (1, 384, 384, 4, 2, 80, True, 0, None),    # 128-row tiles on the
    (1, 300, 300, 2, 2, 80, True, 0, None),    # diagonal, whole and ragged
    (2, 1000, 1056, 8, 8, 80, True, 0, 1000),  # prefill into a cache
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernel_matches_plain(case, bf16):
    """On the card: the CUDA kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len = case
    dt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (torch.tensor(a).to("cuda", dt) for a in draws(
        Sq * Skv + D, (B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                          kv_len=kv_len)
    plain = attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    close(out.cpu(), plain.float().cpu().numpy(),
          BF16_TOL if bf16 else F32_TOL)


@pytest.mark.cuda
def test_cuda_bf16_rejects_what_tma_cannot_load():
    """bf16 is loaded by TMA: head_dim and strides must be multiples of 8
    elements.  The wrapper raises rather than fall back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros((1, 8, 2, 20), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(q, q, q)
    wide = torch.zeros((1, 8, 2, 36), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        flash_attention(wide[..., 4:], wide[..., 4:], wide[..., 4:])


# the VLM's cross-attention: (B, Sq, Skv, Hq, Hkv, D), non-causal, at the
# reduced config's shape and at the full width's (llama-3.2-vision-90b:
# 64 query heads over 8 kv heads, a context of 4 096 rows)
CROSS_CASES = [(2, 64, 16, 4, 1, 16), (1, 1024, 4096, 64, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CROSS_CASES)
def test_cuda_mixed_types_take_the_float32_kernel(case):
    """On the card: float32 queries over bf16 keys and values (a float32
    model's cross-attention over a bf16 context) launch the float32 kernel
    once, return bf16, and meet the plain version within the bf16
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, Sq, Skv, Hq, Hkv, D = case
    q, k, v = draws(Sq + Skv, (B, Sq, Hq, D), (B, Skv, Hkv, D),
                    (B, Skv, Hkv, D))
    q = torch.tensor(q).cuda()
    k, v = (torch.tensor(a).to("cuda", torch.bfloat16) for a in (k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    plain = attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == plain.dtype == torch.bfloat16
    close(out.cpu(), plain.float().cpu().numpy(), BF16_TOL)
