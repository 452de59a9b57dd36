"""The port's host pipeline and cost model against the JAX reference.

Same inputs, made from numpy seeds or the paper's scenarios, go through
``repro`` and ``repro_torch``:

* CostDB (built by the port, and carried across with
  ``cost_db_from_arrays``), ``greedy_pack`` windows, ``top_k_segmentations``
  and ``frontier_paths`` paths and occupancy words: bitwise equal;
* quantised score buckets (numpy and torch forms): equal;
* ``comm_from_parts`` / ``comm_terms`` and the float64 oracle
  ``eval_model_candidates``: rtol 1e-12, as ``tests/test_evaluator.py``
  holds the reference's own batched forms to its scalar oracle, and
  bitwise (the port runs the reference's operations in its order);
* the float32 evaluator (``backend="torch_ref"``) against the reference's
  numpy oracle: rtol 2e-4 (``F32_SCORE_RTOL`` of ``tests/test_evaluator``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.cost import comm_terms as ref_comm_terms
from repro.core.cost import eval_model_candidates as ref_eval_oracle
from repro.core.paths import frontier_paths as ref_frontier_paths
from repro.core.provision import provision as ref_provision
from repro.core.quantize import quantize_scores as ref_quantize
from repro.core.reconfig import greedy_pack as ref_greedy_pack
from repro.core.sched import assemble_candidates as ref_assemble
from repro.core.scheduler import get_cost_db as ref_get_cost_db
from repro.core.segmentation import top_k_segmentations as ref_top_k

import repro_torch.core as T
from repro_torch.core.cost import BatchedModelCandidates
from repro_torch.core.cost import (comm_terms, eval_model_candidates,
                                   numpy_row_sum)
from repro_torch.core.evaluator import eval_candidates
from repro_torch.core.maestro import build_cost_db, cost_db_from_arrays
from repro_torch.core.paths import frontier_paths
from repro_torch.core.quantize import (SCORE_SIG, quantize_scores,
                                       quantize_scores_torch)
from repro_torch.core.reconfig import greedy_pack
from repro_torch.core.segmentation import top_k_segmentations
from repro_torch.launch import platform

F32_SCORE_RTOL = 2e-4
F64_RTOL = 1e-12
CPU = torch.device("cpu")


def n_pe_of(scn):
    return 4096 if scn.startswith("dc") else 256


def as_port_db(db):
    """The reference CostDB carried across through the state bridge."""
    return cost_db_from_arrays({f.name: getattr(db, f.name)
                                for f in dataclasses.fields(db)})


def as_port_cand(cand):
    return BatchedModelCandidates(**{f.name: getattr(cand, f.name)
                                     for f in dataclasses.fields(cand)})


def window0_batches(scn, rows=3, pattern="het_sides", path_cap=64):
    """Reference production candidate batches of window 0 (+ port twins)."""
    sc = R.get_scenario(scn)
    mcm = R.make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe_of(scn))
    db = ref_get_cost_db(sc, mcm)
    wa = ref_greedy_pack(db, mcm.class_counts(), 4)
    ranges = wa.ranges[0]
    alloc = ref_provision(db, mcm.class_counts(), ranges, mcm.n_chiplets,
                          metric="edp", max_nodes_per_model=6)
    tmcm = T.make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe_of(scn))
    tdb = as_port_db(db)
    for mi, (s, e) in sorted(ranges.items()):
        segs = ref_top_k(db, mcm, s, e, alloc[mi], k=4, cap=128,
                         metric="edp")
        cand, _, _ = ref_assemble(mcm, mi, (s, e), segs, None,
                                  path_cap=path_cap)
        yield db, mcm, cand, tdb, tmcm, as_port_cand(cand), len(ranges)


# ------------------------------ CostDB ------------------------------------

@pytest.mark.parametrize("pattern", ["het_sides", "het_cb", "simba_nvdla"])
def test_cost_db_bitwise(pattern):
    fields = [f.name for f in dataclasses.fields(R.CostDB)]
    for scn in R.SCENARIO_NAMES:
        mcm = R.make_mcm(pattern, n_pe=n_pe_of(scn))
        tmcm = T.make_mcm(pattern, n_pe=n_pe_of(scn))
        ref = R.build_cost_db(R.get_scenario(scn), mcm.classes, mcm.pkg)
        ours = build_cost_db(T.get_scenario(scn), tmcm.classes, tmcm.pkg)
        bridged = as_port_db(ref)
        for name in fields:
            a, b, c = (getattr(x, name) for x in (ref, ours, bridged))
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype == c.dtype, name
                np.testing.assert_array_equal(b, a, err_msg=name)
                np.testing.assert_array_equal(c, a, err_msg=name)
            else:
                assert a == b == c, name


def test_cost_db_bridge_rejects_bad_shapes():
    ref = R.build_cost_db(R.get_scenario("dc1_lms"),
                          R.make_mcm("het_sides").classes,
                          R.make_mcm("het_sides").pkg)
    d = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    d["w_bytes"] = d["w_bytes"][:-1]
    with pytest.raises(ValueError):
        cost_db_from_arrays(d)


# --------------------------- windows, SEG, paths ---------------------------

@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_windows_and_segmentations_bitwise_6x6(scn):
    mcm = R.make_mcm("het_cross", rows=6, cols=6, n_pe=n_pe_of(scn))
    tmcm = T.make_mcm("het_cross", rows=6, cols=6, n_pe=n_pe_of(scn))
    db = ref_get_cost_db(R.get_scenario(scn), mcm)
    tdb = as_port_db(db)
    wa = ref_greedy_pack(db, mcm.class_counts(), 4)
    twa = greedy_pack(tdb, tmcm.class_counts(), 4)
    assert twa.ranges == wa.ranges
    assert twa.boundaries == wa.boundaries
    for ranges in wa.ranges:
        alloc = ref_provision(db, mcm.class_counts(), ranges,
                              mcm.n_chiplets, metric="edp",
                              max_nodes_per_model=6)
        talloc = T.provision(tdb, tmcm.class_counts(), ranges,
                             tmcm.n_chiplets, metric="edp",
                             max_nodes_per_model=6)
        assert dict(talloc) == dict(alloc)
        for mi, (s, e) in sorted(ranges.items()):
            assert top_k_segmentations(tdb, tmcm, s, e, talloc[mi], k=4,
                                       cap=512) == \
                ref_top_k(db, mcm, s, e, alloc[mi], k=4, cap=512)


@pytest.mark.parametrize("length", [1, 2, 4, 6])
def test_frontier_paths_bitwise_6x6(length):
    for starts in ([0, 6, 12, 18, 24, 30, 5, 11], [14], [35, 0, 14]):
        for cap in (64, 512):
            p, w = frontier_paths(6, 6, length, starts, cap=cap)
            rp, rw = ref_frontier_paths(6, 6, length, starts, cap=cap)
            assert p.dtype == rp.dtype and w.dtype == rw.dtype
            np.testing.assert_array_equal(p, rp)
            np.testing.assert_array_equal(w, rw)


def test_quantized_buckets_equal():
    rng = np.random.default_rng(5)
    scores = np.concatenate([rng.lognormal(-20, 6, 4000), [0.0, np.inf],
                             np.round(rng.lognormal(-10, 3, 200), 9)])
    for sig in (SCORE_SIG, 11):
        want = ref_quantize(scores, sig=sig)
        np.testing.assert_array_equal(quantize_scores(scores, sig=sig), want)
        got = quantize_scores_torch(torch.from_numpy(scores), sig=sig)
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------- cost model ------------------------------------

@pytest.mark.parametrize("n", [1, 5, 7, 8, 13, 128, 129, 300])
def test_numpy_row_sum_matches_numpy_bits(n):
    x = np.random.default_rng(n).lognormal(0, 3, (64, n))
    np.testing.assert_array_equal(numpy_row_sum(torch.from_numpy(x)).numpy(),
                                  x.sum(axis=1))


@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_comm_terms_and_f64_oracle_match_reference(scn):
    for db, mcm, cand, tdb, tmcm, tcand, na in window0_batches(scn):
        for prev_end in (None, 4):
            ref = ref_comm_terms(db, mcm, cand, na, prev_end=prev_end)
            ours = comm_terms(tdb, tmcm, tcand, na, prev_end=prev_end,
                              device=CPU)
            for a, b in zip(ref, ours):
                assert b.dtype == torch.float64
                np.testing.assert_allclose(b.numpy(), a, rtol=F64_RTOL,
                                           atol=0)
                np.testing.assert_array_equal(b.numpy(), a)
            for pipelined in (True, False):
                rl, re = ref_eval_oracle(db, mcm, cand, na,
                                         prev_end=prev_end,
                                         pipelined=pipelined)
                tl, te = eval_model_candidates(tdb, tmcm, tcand, na,
                                               prev_end=prev_end,
                                               pipelined=pipelined,
                                               device=CPU)
                np.testing.assert_allclose(tl.numpy(), rl, rtol=F64_RTOL)
                np.testing.assert_allclose(te.numpy(), re, rtol=F64_RTOL)
                # same operations in the same order: bit for bit
                np.testing.assert_array_equal(tl.numpy(), rl)
                np.testing.assert_array_equal(te.numpy(), re)


@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_f32_evaluator_matches_reference_oracle(scn):
    for db, mcm, cand, tdb, tmcm, tcand, na in window0_batches(scn):
        for prev_end in (None, 4):
            for pipelined in (True, False):
                rl, re = ref_eval_oracle(db, mcm, cand, na,
                                         prev_end=prev_end,
                                         pipelined=pipelined)
                tl, te = eval_candidates(tdb, tmcm, tcand, na,
                                         prev_end=prev_end,
                                         pipelined=pipelined,
                                         backend="torch_ref", device=CPU)
                assert tl.dtype == te.dtype == np.float64
                np.testing.assert_allclose(tl, rl, rtol=F32_SCORE_RTOL)
                np.testing.assert_allclose(te, re, rtol=F32_SCORE_RTOL)


def test_one_counted_fetch_per_scoring_batch():
    batches = list(window0_batches("dc4_lms_seg_image"))
    platform.reset_sync_count()
    for backend in ("torch", "torch_ref", "auto"):
        for _, _, _, tdb, tmcm, tcand, na in batches:
            eval_candidates(tdb, tmcm, tcand, na, backend=backend,
                            device=CPU)
    assert platform.sync_count() == 3 * len(batches)


# ------------------------------ engines -------------------------------------

@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_window_sets_and_engines_match_reference(scn):
    """Candidate sets of every window equal the reference's bitwise (small
    batches score on the float64 oracle); the port's ``BeamEngine`` equals
    its ``reference_combine`` and the reference's engine (plan, metrics,
    explored cloud); ``batched_fitness`` matches on seeded random picks."""
    from repro.core.engine import BeamEngine as RefBeam
    from repro.core.engine import CandidateTensors as RefCT
    from repro.core.engine import batched_fitness as ref_fitness
    from repro.core.scheduler import SearchConfig as RefCfg
    from repro.core.scheduler import build_window_sets as ref_sets
    from repro_torch.core.engine import (BeamEngine, CandidateTensors,
                                         batched_fitness, reference_combine)
    from repro_torch.core.scheduler import build_window_sets

    mcm = R.make_mcm("het_sides", n_pe=n_pe_of(scn))
    tmcm = T.make_mcm("het_sides", n_pe=n_pe_of(scn))
    db = ref_get_cost_db(R.get_scenario(scn), mcm)
    tdb = as_port_db(db)
    rng = np.random.default_rng(len(scn))
    anchors = {}
    for ranges in ref_greedy_pack(db, mcm.class_counts(), 4).ranges:
        rs = ref_sets(db, mcm, RefCfg(), ranges, anchors)
        ts = build_window_sets(tdb, tmcm, T.SearchConfig(), ranges, anchors,
                               device=CPU)
        for a, b in zip(rs, ts):
            for name in ("lat", "energy", "mask_words", "chips", "n_segs",
                         "seg_arr"):
                np.testing.assert_array_equal(getattr(b, name),
                                              getattr(a, name))
        ref = RefBeam(beam=48).combine(db, mcm, rs, anchors)
        ours = BeamEngine(beam=48).combine(tdb, tmcm, ts, anchors)
        oracle = reference_combine(tdb, tmcm, ts, anchors, beam=48)
        for got in (ours, oracle):
            # the two packages' dataclasses differ, so compare as tuples
            assert dataclasses.astuple(got.plan) == \
                dataclasses.astuple(ref.plan)
            assert dataclasses.astuple(got.result) == \
                dataclasses.astuple(ref.result)
            assert got.explored == ref.explored
        picks = np.stack([rng.integers(0, [cs.n_cands for cs in rs])
                          for _ in range(16)])
        want = ref_fitness(RefCT.from_sets(rs, mcm.n_chiplets), picks, "edp")
        got = batched_fitness(CandidateTensors.from_sets(ts, tmcm.n_chiplets),
                              picks, "edp")
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        anchors = dict(anchors)
        anchors.update(ref.result.end_chiplet)
