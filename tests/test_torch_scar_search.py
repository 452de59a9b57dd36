"""The port's ``scar_search`` plain version and ``masked_topk`` against the
JAX reference.

Occupancy words are drawn from a numpy seed as uint32 (dense random words,
sparse words so that many pairs are disjoint, and all-zero / all-ones rows)
and fed to the port as their int32 bit patterns.  The reference runs as its
own tests run it: the scalar oracle ``conflict_counts_ref``, the jitted
jnp form (``use_kernel=False``) and the Pallas kernel in interpret mode.
Counts are integers, so equality is exact.

The CUDA kernel itself runs only on a GPU: ``test_cuda_kernel_matches_plain``
carries the ``cuda`` marker and skips elsewhere
(``python -m pytest -m cuda tests/test_torch_scar_search.py`` on the card).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.scar_search import (conflict_counts,
                                             conflict_counts_plain,
                                             masked_topk, scar_search)

# (Bm, N, W): one pair, a ragged N past a 2048 block at W=2 (3x3, 6x6
# packages), the 16x16 pod's W=8 at beam 48, and a wider beam.
SHAPES = [(1, 1, 2), (48, 2049, 2), (48, 4096, 8), (64, 300, 8)]


def occupancy_words(rng, n, w):
    """uint32 words: dense rows, sparse rows, and zero / all-ones rows."""
    dense = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
    sparse = dense & rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64) \
        & rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64)
    out = np.where(rng.random((n, 1)) < 0.5, dense, sparse).astype(np.uint32)
    out[0] = 0
    if n > 1:
        out[1] = 0xFFFFFFFF
    return out


def as_int32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("bm,n,w", SHAPES)
def test_plain_matches_reference_oracles_and_pallas(bm, n, w):
    import jax.numpy as jnp
    from repro.kernels.scar_search import conflict_counts as ref_counts
    from repro.kernels.scar_search import conflict_counts_ref
    rng = np.random.default_rng(bm * 100_000 + n * 10 + w)
    beam = occupancy_words(rng, bm, w)
    cand = occupancy_words(rng, n, w)
    ours = conflict_counts_plain(as_int32(beam), as_int32(cand))
    assert ours.dtype == torch.int32 and tuple(ours.shape) == (bm, n)
    ours = ours.numpy()
    np.testing.assert_array_equal(ours, conflict_counts_ref(beam, cand))
    jb, jc = jnp.asarray(beam), jnp.asarray(cand)
    np.testing.assert_array_equal(
        ours, np.asarray(ref_counts(jb, jc, use_kernel=False)))
    np.testing.assert_array_equal(
        ours, np.asarray(ref_counts(jb, jc, use_kernel=True,
                                    interpret=True)))
    if n > 1:                          # zero rows are disjoint from all,
        assert (ours[0] == 0).all()    # all-ones rows count the other's bits
        assert (ours[:, 0] == 0).all()
        np.testing.assert_array_equal(
            ours[1], np.unpackbits(cand.view(np.uint8), axis=1).sum(1))


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    rng = np.random.default_rng(1)
    beam = as_int32(occupancy_words(rng, 5, 8))
    cand = as_int32(occupancy_words(rng, 77, 8))
    before = scar_search.launches
    out = scar_search(beam, cand)
    assert scar_search.launches == before
    assert torch.equal(out, conflict_counts_plain(beam, cand))
    assert torch.equal(conflict_counts(beam, cand, use_kernel=False), out)


def test_kernel_request_on_cpu_raises():
    beam = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        conflict_counts(beam, beam, use_kernel=True)


def test_wrapper_rejects_bad_inputs():
    beam = torch.zeros((4, 8), dtype=torch.int32)
    cand = torch.zeros((9, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        scar_search(beam.long(), cand)
    with pytest.raises(ValueError):
        scar_search(beam, cand[:, :2].contiguous())
    with pytest.raises(ValueError):
        scar_search(beam, torch.zeros((9, 16), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError):
        scar_search(beam[0], cand)


@pytest.mark.parametrize("case", ["ties", "all_invalid", "k_past_valid"])
def test_masked_topk_matches_reference(case):
    import jax.numpy as jnp
    from repro.kernels.scar_search import masked_topk as ref_topk
    from repro.kernels.scar_search import masked_topk_ref
    rng = np.random.default_rng(7)
    n = 40
    scores = rng.integers(0, 5, n).astype(np.float32)     # many equal values
    valid = rng.random(n) < 0.7
    k = 12
    if case == "all_invalid":
        valid[:] = False
    elif case == "k_past_valid":
        valid[:] = False
        valid[[3, 9, 17]] = True
    vals, idx = masked_topk(torch.from_numpy(scores), torch.from_numpy(valid),
                            k)
    want_v, want_i = masked_topk_ref(scores, valid, k)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    jv, ji = ref_topk(jnp.asarray(scores), jnp.asarray(valid), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_masked_topk_k_beyond_length():
    vals, idx = masked_topk(torch.tensor([2.0, 1.0]),
                            torch.tensor([True, True]), 4)
    assert vals.tolist() == [1.0, 2.0, float("inf"), float("inf")]
    assert idx.tolist() == [1, 0, -1, -1]


@pytest.mark.cuda
@pytest.mark.parametrize("bm,n,w", SHAPES + [(48, 8192, 8), (7, 1000, 3),
                                              (3, 129, 4)])
def test_cuda_kernel_matches_plain(bm, n, w):
    """On the card: the CUDA kernel against its plain version, exactly
    (W = 3 takes the kernel's any-W path, W = 2, 4, 8 its vector loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(bm + n + w)
    beam = as_int32(occupancy_words(rng, bm, w)).cuda()
    cand = as_int32(occupancy_words(rng, n, w)).cuda()
    before = scar_search.launches
    out = scar_search(beam, cand)
    plain = conflict_counts_plain(beam, cand)
    torch.cuda.synchronize()
    assert scar_search.launches == before + 1
    assert torch.equal(out, plain)
