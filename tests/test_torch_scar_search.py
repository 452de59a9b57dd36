"""The port's ``scar_search`` plain versions and ``masked_topk`` against
the JAX reference and the host beam.

The kernel does a beam stage's whole screen: disjointness, the keep width,
the row-major expansion budget and the masked score plane.  Its plain
version (``scar_search_plain``) is held bit for bit against a numpy
transcription of ``engine.BeamEngine.combine``'s stage, in float32 and
float64.  Its disjointness half, ``conflict_counts_plain``, stays held
against the reference as the reference's own tests run it: the scalar
oracle ``conflict_counts_ref``, the jitted jnp form (``use_kernel=False``)
and the Pallas kernel in interpret mode.  Counts are integers and scores
single IEEE operations, so equality is exact.

Occupancy words are drawn from a numpy seed as uint32 (dense random words,
sparse words so that many pairs are disjoint, and all-zero / all-ones rows)
and fed to the port as their int32 bit patterns.  The CUDA kernel itself
runs only on a GPU: the tests marked ``cuda`` skip elsewhere (``python -m
pytest -m cuda tests/test_torch_scar_search.py`` on the card) and hold it
bitwise against its plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.scar_search import (conflict_counts_plain,
                                             masked_topk, scar_search,
                                             scar_search_plain, screen)

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


def stage_inputs(rng, bm, n, w, dtype, *, n_live, n_valid, exp=0,
                 sparse=True):
    """One stage's screen inputs from a seed (torch, on the CPU)."""
    if sparse:                     # a few bits a word: many disjoint pairs
        def words(rows):
            bits = rng.integers(0, 32, (rows, w, 2))
            return ((np.uint32(1) << bits[..., 0].astype(np.uint32))
                    | (np.uint32(1) << bits[..., 1].astype(np.uint32))
                    ) * (rng.random((rows, w)) < 0.3)
        beam, cand = words(bm).astype(np.uint32), words(n).astype(np.uint32)
    else:
        beam, cand = occupancy_words(rng, bm, w), occupancy_words(rng, n, w)
    f = np.float32 if dtype == torch.float32 else np.float64
    valid = np.arange(n) < n_valid
    return dict(
        beam_words=as_int32(beam), cand_words=as_int32(cand),
        valid=torch.from_numpy(valid),
        state=torch.tensor([0, exp, n_live, 0], dtype=torch.int64),
        b_lat=torch.from_numpy(rng.lognormal(-6, 1, bm).astype(f)),
        b_e=torch.from_numpy(rng.lognormal(-2, 1, bm).astype(f)),
        c_lat=torch.from_numpy(rng.lognormal(-6, 1, n).astype(f)),
        c_e=torch.from_numpy(rng.lognormal(-2, 1, n).astype(f)))


def host_stage(t, keep, max_exp, metric):
    """numpy transcription of one ``engine.BeamEngine.combine`` stage over
    the live beam rows and the valid candidates: the accepted (row,
    candidate) pairs, their scores, and the stage total."""
    n_live, exp = int(t["state"][2]), int(t["state"][1])
    n_cand = int(t["valid"].sum())
    b_mask = t["beam_words"].numpy().view(np.uint32)[:n_live]
    cand_masks = t["cand_words"].numpy().view(np.uint32)[:n_cand]
    disjoint = ((b_mask[:, None, :] & cand_masks[None, :, :]) == 0
                ).all(axis=-1)
    if keep < n_cand:
        rank = np.add.accumulate(disjoint, axis=1, dtype=np.int32)
        sel = disjoint & (rank <= keep)
    else:
        sel = disjoint
    total = int(np.count_nonzero(sel))
    if exp + total > max_exp:
        flat_sel = sel.ravel()
        before = np.cumsum(flat_sel) - flat_sel
        okf = flat_sel & ((exp + before < max_exp) | (before == 0))
        sel = okf.reshape(sel.shape)
        total = int(np.count_nonzero(sel))
    rows, cand_idx = np.nonzero(sel)
    b_lat, b_e = t["b_lat"].numpy(), t["b_e"].numpy()
    c_lat, c_e = t["c_lat"].numpy(), t["c_e"].numpy()
    new_lat = np.maximum(b_lat[rows], c_lat[cand_idx])
    new_e = b_e[rows] + c_e[cand_idx]
    score = (new_lat if metric == "latency" else new_e if metric == "energy"
             else new_lat * new_e)
    return rows, cand_idx, score, total


# (case, n_live of 8 rows, keep, expansions before, max_exp, metric)
STAGES = {
    "keep_below_count": (8, 3, 0, 20000, "edp"),
    "keep_at_count": (8, None, 0, 20000, "edp"),
    "budget_ends_mid_row": (8, 40, 100, None, "edp"),
    "max_exp_1_first_acceptance": (8, 5, 7, 1, "edp"),
    "max_exp_1_from_zero": (8, 5, 0, 1, "latency"),
    "dead_beam_rows": (3, 6, 0, 20000, "energy"),
}


@pytest.mark.parametrize("case", sorted(STAGES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_screen_plain_matches_host_beam_stage(case, dtype):
    n_live, keep, exp, max_exp, metric = STAGES[case]
    rng = np.random.default_rng(len(case) * 31 + (dtype == torch.float64))
    t = stage_inputs(rng, 8, 300, 4, dtype, n_live=n_live, n_valid=250,
                     exp=exp)
    dis = (conflict_counts_plain(t["beam_words"], t["cand_words"]) == 0) \
        & t["valid"][None, :]
    counts = dis[:n_live].sum(1)
    assert int(counts.min()) > 3          # every live row has a choice
    if keep is None:                      # the largest row count
        keep = int(counts.max())
    if max_exp is None:                   # runs out inside row 2
        max_exp = exp + 2 * keep + keep // 2
    rows, cand_idx, score, total = host_stage(t, keep, max_exp, metric)
    plane, state = scar_search_plain(**t, keep=keep, max_exp=max_exp,
                                     metric=metric)
    want = np.full((8, 300), np.inf, dtype=plane.numpy().dtype)
    want[rows, cand_idx] = score
    assert plane.dtype == dtype
    np.testing.assert_array_equal(plane.numpy(), want)
    assert state.tolist() == [total, exp + total, min(total, 8),
                              int(total == 0)]
    if case == "budget_ends_mid_row":
        assert np.bincount(rows, minlength=8)[2] not in (0, keep)
    if case.startswith("max_exp_1"):
        assert total == 1


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing."""
    rng = np.random.default_rng(1)
    t = stage_inputs(rng, 5, 77, 8, torch.float32, n_live=4, n_valid=70,
                     sparse=False)
    before = scar_search.launches
    plane, state = scar_search(**t, keep=9, max_exp=50, metric="edp")
    assert scar_search.launches == before
    want = scar_search_plain(**t, keep=9, max_exp=50, metric="edp")
    assert torch.equal(plane, want[0]) and torch.equal(state, want[1])
    got = screen(**t, use_kernel=False, keep=9, max_exp=50, metric="edp")
    assert torch.equal(got[0], plane) and torch.equal(got[1], state)


def test_kernel_request_on_cpu_raises():
    t = stage_inputs(np.random.default_rng(0), 2, 3, 2, torch.float32,
                     n_live=1, n_valid=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        screen(**t, use_kernel=True, keep=1, max_exp=1, metric="edp")


def test_wrapper_rejects_bad_inputs():
    t = stage_inputs(np.random.default_rng(2), 4, 9, 8, torch.float32,
                     n_live=2, n_valid=9)
    kw = dict(keep=2, max_exp=10, metric="edp")
    with pytest.raises(TypeError):
        scar_search(**{**t, "beam_words": t["beam_words"].long()}, **kw)
    with pytest.raises(ValueError):
        scar_search(**{**t, "cand_words":
                       t["cand_words"][:, :2].contiguous()}, **kw)
    with pytest.raises(ValueError):
        scar_search(**{**t, "cand_words": torch.zeros(
            (9, 16), dtype=torch.int32)[:, ::2]}, **kw)
    with pytest.raises(TypeError):
        scar_search(**{**t, "b_e": t["b_e"].double()}, **kw)
    with pytest.raises(ValueError):
        scar_search(**{**t, "state": t["state"][:3]}, **kw)


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


# Bm, N (8 193 is one past a tile multiple; 65 536 at Bm 64 is a grid of
# several waves, where a tile waits on tickets of an earlier wave), keep
# (N: no keep limit), max_exp
CARD_BM = (1, 48, 64)
CARD_N = (1, 255, 8192, 8193, 65536)
CARD_MAX_EXP = (1, 7, 20000)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_plain_bitwise(w, dtype):
    """On the card: the screen kernel against its plain version, bit for
    bit, over every (Bm, N, keep, max_exp) (W = 3 takes the kernel's
    any-W path, W = 2 its 8-byte loads, W = 4 and 8 its 16-byte ones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(w * 10 + (dtype == torch.float64))
    for bm in CARD_BM:
        for n in CARD_N:
            for keep in (1, 48, n):
                for max_exp in CARD_MAX_EXP:
                    t = stage_inputs(
                        rng, bm, n, w, dtype,
                        n_live=int(rng.integers(0, bm + 1)),
                        n_valid=int(rng.integers(n // 2, n + 1)),
                        exp=int(rng.integers(0, 10)),
                        sparse=bool(rng.random() < 0.7))
                    t = {k: v.cuda() for k, v in t.items()}
                    kw = dict(keep=keep, max_exp=max_exp, metric="edp")
                    before = scar_search.launches
                    plane, state = scar_search(**t, **kw)
                    want = scar_search_plain(**t, **kw)
                    torch.cuda.synchronize()
                    assert scar_search.launches == before + 1
                    case = (bm, n, w, keep, max_exp, dtype)
                    assert torch.equal(plane, want[0]), case
                    assert torch.equal(state, want[1]), case
