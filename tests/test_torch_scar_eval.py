"""The port's ``scar_eval`` plain version against the JAX Pallas kernel.

Inputs are drawn from a numpy seed in the compact form the port's kernel
reads (per-segment class, last layer, live count, comm terms); the dense
one-hots the Pallas kernel reads are built from the same integers.  The
reference runs as its own tests run it: ``interpret=True`` and the jnp
oracle ``scar_eval_ref``.  Tolerance: rtol 2e-5, the repo's float32 kernel
tolerance (``tests/test_kernels.py``); both sides are float32 and differ
only in summation order.

The CUDA kernel itself runs only on a GPU: ``test_cuda_kernel_matches_plain``
carries the ``cuda`` marker and skips elsewhere
(``python -m pytest -m cuda tests/test_torch_scar_eval.py`` on the card).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.scar_eval import (blocked_cumsum, scar_eval,
                                           scar_eval_plain)

# The JAX reference is imported inside the tests that compare against it,
# so the ``cuda`` test also runs where JAX is not installed.

RTOL = 2e-5

# (B, Lw, S, C): single candidate/layer, ragged batches, the 6x6 and 16x16
# main-path widths (Lw 56..80, S 6, C 2), a deep window and 3 classes.
SHAPES = [(1, 1, 1, 2), (7, 11, 6, 2), (24, 56, 6, 2), (33, 80, 8, 3),
          (16, 300, 6, 3)]


def compact_batch(rng, B, Lw, S, C):
    """Seeded compact inputs, incl. padding rows and single-segment rows."""
    lat_tab = rng.lognormal(-9, 2, (Lw, C)).astype(np.float32)
    e_tab = rng.lognormal(-5, 2, (Lw, C)).astype(np.float32)
    n_segs = rng.integers(0, min(S, Lw) + 1, B)
    n_segs[0] = min(1, Lw)                       # a single-segment row
    if B > 1:
        n_segs[-1] = 0                           # a padding row
    last = np.full((B, S), -1, np.int32)
    for b in range(B):
        k = int(n_segs[b])
        if k:
            cuts = np.sort(rng.choice(Lw - 1, k - 1, replace=False))
            last[b, :k] = np.concatenate([cuts, [Lw - 1]])
    seg_cls = rng.integers(0, C, (B, S)).astype(np.int32)
    comm_lat = rng.lognormal(-10, 1, (B, S)).astype(np.float32)
    comm_e = rng.lognormal(-6, 1, (B, S)).astype(np.float32)
    return lat_tab, e_tab, seg_cls, last, n_segs.astype(np.int32), \
        comm_lat, comm_e


def dense_inputs(lat_tab, e_tab, seg_cls, last, n_segs, comm_lat, comm_e,
                 pipelined):
    """The Pallas kernel's dense one-hot inputs for the same batch."""
    import jax.numpy as jnp
    Lw, C = lat_tab.shape
    B, S = seg_cls.shape
    seg_id = np.full((B, Lw), -1)
    for b in range(B):
        lo = 0
        for s in range(int(n_segs[b])):
            seg_id[b, lo:last[b, s] + 1] = s
            lo = last[b, s] + 1
    live = seg_id >= 0
    layer_cls = np.take_along_axis(seg_cls, np.maximum(seg_id, 0), axis=1)
    cls_oh = (layer_cls[..., None] == np.arange(C)) & live[..., None]
    seg_oh = seg_id[..., None] == np.arange(S)
    valid = np.arange(S)[None, :] < n_segs[:, None]
    pipe = np.full((B, 1), 1.0 if pipelined else 0.0, np.float32)
    f = np.float32
    return (jnp.asarray(lat_tab), jnp.asarray(e_tab), jnp.asarray(cls_oh, f),
            jnp.asarray(seg_oh, f), jnp.asarray(comm_lat),
            jnp.asarray(comm_e), jnp.asarray(valid, f), jnp.asarray(pipe))


@pytest.mark.parametrize("B,Lw,S,C", SHAPES)
@pytest.mark.parametrize("pipelined", [True, False])
def test_plain_matches_pallas_kernel_and_ref(B, Lw, S, C, pipelined):
    from repro.kernels.scar_eval import scar_eval as pallas_scar_eval
    from repro.kernels.scar_eval import scar_eval_ref
    rng = np.random.default_rng(B * 1000 + Lw * 10 + S + C)
    batch = compact_batch(rng, B, Lw, S, C)
    dense = dense_inputs(*batch, pipelined)
    ours = scar_eval_plain(*(torch.from_numpy(a) for a in batch),
                           pipelined).numpy()
    pallas = np.asarray(pallas_scar_eval(*dense, block_b=B, interpret=True))
    ref = np.asarray(scar_eval_ref(*dense))
    np.testing.assert_allclose(ours, pallas, rtol=RTOL)
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    # padding rows score (0, 0), as in the reference
    assert (ours[batch[4] == 0] == 0).all()


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a) for a in compact_batch(rng, 9, 20, 4, 2)]
    before = scar_eval.launches
    out = scar_eval(*args, True)
    assert scar_eval.launches == before
    assert torch.equal(out, scar_eval_plain(*args, True))


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(a) for a in compact_batch(rng, 9, 20, 4, 2)]
    bad_dtype = list(args)
    bad_dtype[3] = bad_dtype[3].long()
    with pytest.raises(TypeError):
        scar_eval(*bad_dtype, True)
    bad_shape = list(args)
    bad_shape[5] = bad_shape[5][:, :2].contiguous()
    with pytest.raises(ValueError):
        scar_eval(*bad_shape, True)
    strided = list(args)
    strided[2] = torch.cat([args[2], args[2]], dim=1)[:, ::2]
    with pytest.raises(ValueError):
        scar_eval(*strided, True)


@pytest.mark.parametrize("n", [1, 11, 16, 17, 56, 80, 300, 1000])
def test_blocked_cumsum_matches_reference_float32_bits(n):
    """``blocked_cumsum`` sums in the association of the reference's
    float32 evaluator (``jnp.cumsum`` on the CPU), bit for bit."""
    import jax.numpy as jnp
    x = np.random.default_rng(n).lognormal(0, 3, (n, 2)).astype(np.float32)
    ours = blocked_cumsum(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lw,S,C", SHAPES + [(7872, 56, 6, 2)])
@pytest.mark.parametrize("pipelined", [True, False])
def test_cuda_kernel_matches_plain(B, Lw, S, C, pipelined):
    """On the card: the CUDA kernel against its plain version, 1e-5 of the
    largest magnitude (both float32, same association)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(B + Lw + S + C)
    args = [torch.from_numpy(a).cuda() for a in compact_batch(rng, B, Lw,
                                                               S, C)]
    before = scar_eval.launches
    out = scar_eval(*args, pipelined)
    plain = scar_eval_plain(*args, pipelined)
    torch.cuda.synchronize()
    assert scar_eval.launches == before + 1
    tol = 1e-5 * plain.abs().max().item()
    assert (out - plain).abs().max().item() <= tol
