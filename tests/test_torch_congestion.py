"""The port's congestion comm model (``comm_model="congestion"``) against
the JAX reference.

The ladder of ``tests/test_comm_congestion.py``, run through the port and
held against ``repro`` on the same inputs:

* route oracles: link counts equal the hop metric, the wait tables
  (``route_wait_tables``, torch and numpy forms) equal ``_route_wait``
  over the route lists and the reference's tables, ``plan_link_bytes``
  equals the reference's;
* the scalar window oracle ``evaluate_window`` against the batched float64
  form at the reference's 1e-12 (and 1e-15 for the occupancy sums), and
  equal to the reference's window oracle bit for bit;
* zero co-tenant overlap on the uniform NoC equals the analytic model bit
  for bit; overlap on a narrow NoC is strictly slower; an unknown
  ``comm_model`` is rejected;
* the float64 form (``eval_model_candidates``) ``==`` the reference's on
  production batches of all ten scenarios, cold and anchored;
* the float32 form (``scar_eval_window_plain`` through
  ``eval_candidates(backend="torch_ref")``) against the reference's
  ``jax_ref`` and Pallas (interpret) backends within ``F32_SCORE_RTOL``;
* whole schedules: the same plans and ``==`` float64 metrics as the
  reference through the port's ``beam`` on the float64 and float32
  backends and the fused ``beam_jax`` search, on the ten 3x3 scenarios.

Everything runs on the CPU, the kernel's plain version standing in for it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import cost as RC
from repro.core import scenarios as RS
from repro.core.evaluator import eval_candidates as ref_eval_candidates
from repro.core.provision import provision as ref_provision
from repro.core.reconfig import greedy_pack as ref_greedy_pack
from repro.core.sched import assemble_candidates as ref_assemble
from repro.core.scheduler import get_cost_db as ref_get_cost_db
from repro.core.segmentation import top_k_segmentations as ref_top_k

import repro_torch.core as T
from repro_torch.core import cost as TC
from repro_torch.core import scenarios as TS
from repro_torch.core.chiplet import NoCConfig
from repro_torch.core.evaluator import eval_candidates
from repro_torch.core.maestro import cost_db_from_arrays
from repro_torch.core.scheduler import get_cost_db
from repro_torch.launch import platform

F32_SCORE_RTOL = 2e-4           # the reference's float32 score tolerance
CPU = torch.device("cpu")
MESHES = [(3, 3), (4, 5), (1, 4), (4, 1)]
HET_NOC = dict(h_bw=40e9, v_bw=25e9, congestion_alpha=0.7)


def n_pe_of(scn):
    return 4096 if scn.startswith("dc") else 256


def both_mcms(pattern="het_sides", rows=3, cols=3, n_pe=4096, noc=None):
    """The same package in both packages; ``noc`` a preset name or the
    ``NoCConfig`` fields."""
    if isinstance(noc, str):
        r_noc, t_noc = RS.noc_config(noc), TS.noc_config(noc)
    elif noc is not None:
        r_noc, t_noc = R.chiplet.NoCConfig(**noc), NoCConfig(**noc)
    else:
        r_noc = t_noc = None
    return (R.make_mcm(pattern, rows=rows, cols=cols, n_pe=n_pe, noc=r_noc),
            T.make_mcm(pattern, rows=rows, cols=cols, n_pe=n_pe, noc=t_noc))


def as_port_db(db):
    return cost_db_from_arrays({f.name: getattr(db, f.name)
                                for f in dataclasses.fields(db)})


def as_port_cand(cand):
    return TC.BatchedModelCandidates(**{f.name: getattr(cand, f.name)
                                        for f in dataclasses.fields(cand)})


def as_port_plan(p):
    return TC.ModelWindowPlan(**dataclasses.asdict(p))


def plan_batch(p):
    """One ``ModelWindowPlan`` as a singleton candidate batch (port)."""
    lw = p.end - p.start
    seg_id = np.zeros((1, lw), np.int64)
    prev = p.start
    for s_idx, e in enumerate(p.seg_ends):
        seg_id[0, prev - p.start:e - p.start] = s_idx
        prev = e
    return TC.BatchedModelCandidates(
        model_idx=p.model_idx, start=p.start, end=p.end, seg_id=seg_id,
        chiplets=np.asarray([p.chiplets], np.int64),
        n_segs=np.array([p.n_segments], np.int64),
        seg_ends=np.asarray([p.seg_ends], np.int64))


def window0_batches(scn, noc, prev_end_seed=None):
    """Reference production candidate batches of window 0 on 3x3
    ``het_sides`` (``path_cap=64``), with their port twins."""
    rmcm, tmcm = both_mcms(n_pe=n_pe_of(scn), noc=noc)
    db = ref_get_cost_db(R.get_scenario(scn), rmcm)
    ranges = ref_greedy_pack(db, rmcm.class_counts(), 4).ranges[0]
    alloc = ref_provision(db, rmcm.class_counts(), ranges, rmcm.n_chiplets,
                          metric="edp", max_nodes_per_model=6)
    tdb = as_port_db(db)
    for mi, (s, e) in sorted(ranges.items()):
        segs = ref_top_k(db, rmcm, s, e, alloc[mi], k=4, cap=128,
                         metric="edp")
        prev = None if prev_end_seed is None else (mi + prev_end_seed) % 9
        cand, _, _ = ref_assemble(rmcm, mi, (s, e), segs, prev, path_cap=64)
        yield (db, rmcm, cand), (tdb, tmcm, as_port_cand(cand)), prev, \
            len(ranges)


# ------------------------------ route oracles -------------------------------

@pytest.mark.parametrize("rows,cols", MESHES)
def test_route_lengths_match_hop_metric(rows, cols):
    """Routed link counts equal ``MCM.hops`` / ``hops_to_dram``, and the
    routes equal the reference's link for link."""
    _, mcm = both_mcms(rows=rows, cols=cols, n_pe=256)
    n_links = TC.n_interposer_links(rows, cols)
    assert n_links == RC.n_interposer_links(rows, cols)
    for s in range(mcm.n_chiplets):
        dlinks = TC.dram_route_links(rows, cols, s)
        assert len(dlinks) == mcm.hops_to_dram(s)
        assert dlinks == RC.dram_route_links(rows, cols, s)
        for d in range(mcm.n_chiplets):
            links = TC.xy_route_links(rows, cols, s, d)
            assert len(links) == mcm.hops(s, d)
            assert len(set(links)) == len(links)
            assert all(0 <= li < n_links for li in links)
            assert links == RC.xy_route_links(rows, cols, s, d)


@pytest.mark.parametrize("rows,cols", MESHES)
def test_route_wait_tables_match_route_lists(rows, cols):
    """The range-mask tables, in torch (float32 and float64) and numpy
    form, equal ``_route_wait`` over every route and the reference's
    tables, bit for bit (a max is exact)."""
    rng = np.random.default_rng(rows * 10 + cols)
    cost = rng.uniform(0.0, 1e-3, TC.n_interposer_links(rows, cols))
    ref_pair, ref_dram = RC.route_wait_tables(np, cost, rows, cols)
    np_pair, np_dram = TC.route_wait_tables(cost, rows, cols)
    np.testing.assert_array_equal(np_pair, ref_pair)
    np.testing.assert_array_equal(np_dram, ref_dram)
    for dt in (torch.float64, torch.float32):
        t_pair, t_dram = TC.route_wait_tables(
            torch.tensor(cost, dtype=dt), rows, cols)
        assert t_pair.dtype == dt
        np.testing.assert_array_equal(
            t_pair.numpy(), ref_pair.astype(t_pair.numpy().dtype))
        np.testing.assert_array_equal(
            t_dram.numpy(), ref_dram.astype(t_dram.numpy().dtype))
    n = rows * cols
    for s in range(n):
        assert np_dram[s] == TC._route_wait(
            cost, TC.dram_route_links(rows, cols, s))
        for d in range(n):
            assert np_pair[s, d] == TC._route_wait(
                cost, TC.xy_route_links(rows, cols, s, d))


def congestion_schedule(scn="dc3_lms_image_heavy", noc=HET_NOC):
    """The reference's congestion ``beam`` schedule on 3x3 ``het_sides``
    and the port's CostDB and MCM for it."""
    rmcm, tmcm = both_mcms(noc=noc)
    sc = R.get_scenario(scn)
    out = R.schedule(sc, rmcm, R.SearchConfig(
        algo="beam", eval_backend="numpy", comm_model="congestion"))
    return ref_get_cost_db(sc, rmcm), rmcm, get_cost_db(
        T.get_scenario(scn), tmcm), tmcm, out


@pytest.mark.parametrize("anchored", [False, True])
def test_scalar_window_oracle_matches_batched_and_reference(anchored):
    """``evaluate_window`` under congestion equals the reference's bit for
    bit, and its per-model latencies equal singleton
    ``eval_model_candidates`` batches fed the co-tenants' occupancy at
    1e-12; link occupancies equal the reference's and sum at 1e-15."""
    db, rmcm, tdb, tmcm, out = congestion_schedule()
    prev_end: dict[int, int] = {}
    for w in out.windows:
        wp = TC.WindowPlan(plans=tuple(as_port_plan(p)
                                       for p in w.plan.plans))
        pe = prev_end if (anchored and prev_end) else {}
        rc = TC.evaluate_window(tdb, tmcm, wp, pe, comm_model="congestion")
        ref = RC.evaluate_window(db, rmcm, w.plan, pe,
                                 comm_model="congestion")
        assert (rc.latency, rc.energy, rc.per_model_latency) == \
            (ref.latency, ref.energy, ref.per_model_latency)
        ra = TC.evaluate_window(tdb, tmcm, wp, pe)
        assert rc.energy == ra.energy       # corrections are latency-only
        occs = [TC.plan_link_bytes(tdb, tmcm, p, pe) for p in wp.plans]
        for o, p in zip(occs, w.plan.plans):
            np.testing.assert_array_equal(
                o, RC.plan_link_bytes(db, rmcm, p, pe))
        np.testing.assert_allclose(TC.window_link_occupancy(tdb, tmcm, wp,
                                                            pe),
                                   np.sum(occs, axis=0), rtol=1e-15)
        for pi, p in enumerate(wp.plans):
            bg = np.sum([o for j, o in enumerate(occs) if j != pi], axis=0) \
                if len(occs) > 1 else np.zeros_like(occs[0])
            lat, _ = TC.eval_model_candidates(
                tdb, tmcm, plan_batch(p), n_active=len(wp.plans),
                prev_end=pe.get(p.model_idx), comm_model="congestion",
                link_occ=bg, device=CPU)
            np.testing.assert_allclose(lat.numpy()[0],
                                       rc.per_model_latency[p.model_idx],
                                       rtol=1e-12)
        prev_end = dict(pe)
        prev_end.update(rc.end_chiplet)


def disjoint_row_plans(db, seed):
    """Two single-row plans on rows 0 and 2 of a 3x3 mesh: their routes
    share no interposer link."""
    rng = np.random.default_rng(seed)
    plans = []
    for mi, row in [(0, 0), (1, 2)]:
        sl = db.model_slice(mi)
        lw = sl.stop - sl.start
        n_seg = int(rng.integers(1, min(3, lw) + 1))
        cuts = sorted(rng.choice(np.arange(1, lw), n_seg - 1, replace=False)
                      .tolist()) if n_seg > 1 else []
        ends = tuple(sl.start + c for c in cuts) + (sl.stop,)
        chips = tuple(int(c) for c in 3 * row + rng.permutation(3)[:n_seg])
        plans.append(TC.ModelWindowPlan(model_idx=mi, start=sl.start,
                                        end=sl.stop, seg_ends=ends,
                                        chiplets=chips))
    return TC.WindowPlan(plans=tuple(plans))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_zero_overlap_equals_analytic(seed):
    """Uniform NoC and no co-tenant route overlap: the congestion model's
    latencies equal the analytic ones, float64 equality."""
    _, mcm = both_mcms(noc="uniform")
    db = get_cost_db(T.get_scenario("dc1_lms"), mcm)
    wp = disjoint_row_plans(db, seed)
    occ_a, occ_b = [TC.plan_link_bytes(db, mcm, p) for p in wp.plans]
    assert float((occ_a * occ_b).sum()) == 0.0
    ra = TC.evaluate_window(db, mcm, wp, validate=True)
    rc = TC.evaluate_window(db, mcm, wp, validate=True,
                            comm_model="congestion")
    assert (rc.latency, rc.energy, rc.per_model_latency) == \
        (ra.latency, ra.energy, ra.per_model_latency)


def test_overlap_strictly_slower_on_narrow_noc():
    """Model 0's DRAM stream on chiplet 4 and model 1's row-1 forward
    (3 -> 5) share a link on the narrow NoC: both latencies rise, and the
    co-tenant wait alone is a strict slowdown."""
    _, mcm = both_mcms(noc="narrow")
    db = get_cost_db(T.get_scenario("dc1_lms"), mcm)
    sl0, sl1 = db.model_slice(0), db.model_slice(1)
    mid = (sl1.start + sl1.stop) // 2
    wp = TC.WindowPlan(plans=(
        TC.ModelWindowPlan(model_idx=0, start=sl0.start, end=sl0.stop,
                           seg_ends=(sl0.stop,), chiplets=(4,),
                           pipelined=False),
        TC.ModelWindowPlan(model_idx=1, start=sl1.start, end=sl1.stop,
                           seg_ends=(mid, sl1.stop), chiplets=(3, 5),
                           pipelined=False)))
    occ0, occ1 = [TC.plan_link_bytes(db, mcm, p) for p in wp.plans]
    assert float((occ0 * occ1).sum()) > 0.0
    ra = TC.evaluate_window(db, mcm, wp, validate=True)
    rc = TC.evaluate_window(db, mcm, wp, validate=True,
                            comm_model="congestion")
    assert rc.latency > ra.latency and rc.energy == ra.energy
    for mi in (0, 1):
        assert rc.per_model_latency[mi] > ra.per_model_latency[mi]
    lats = [TC.eval_model_candidates(
        db, mcm, plan_batch(wp.plans[1]), n_active=2, pipelined=False,
        comm_model="congestion", link_occ=occ, device=CPU)[0].item()
        for occ in (occ0, None)]
    assert lats[0] > lats[1]


def test_unknown_comm_model_rejected():
    _, mcm = both_mcms(n_pe=256)
    db = get_cost_db(T.get_scenario("xr8_outdoors"), mcm)
    sl = db.model_slice(0)
    wp = TC.WindowPlan(plans=(TC.ModelWindowPlan(
        model_idx=0, start=sl.start, end=sl.stop, seg_ends=(sl.stop,),
        chiplets=(0,)),))
    with pytest.raises(ValueError, match="comm_model"):
        TC.evaluate_window(db, mcm, wp, comm_model="wormhole")
    with pytest.raises(ValueError, match="comm_model"):
        TC.eval_model_candidates(db, mcm, plan_batch(wp.plans[0]), 1,
                                 comm_model="wormhole", device=CPU)
    with pytest.raises(ValueError, match="comm_model"):
        T.schedule(T.get_scenario("xr8_outdoors"), mcm,
                   T.SearchConfig(comm_model="wormhole"), device="cpu")


# ----------------- batched forms on production batches ---------------------

@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_batched_forms_match_reference(scn):
    """Production batches of window 0, cold and anchored, random
    background occupancy on the contended NoC: the float64 form equals
    the reference's numpy oracle bit for bit; the float32 form (the
    kernel's plain version) is within ``F32_SCORE_RTOL`` of the
    reference's ``jax_ref`` backend on every batch and of its Pallas
    kernel (interpret mode, slow on the CPU) on the first anchored one;
    contention never speeds a candidate up."""
    rng = np.random.default_rng(7)
    for prev_seed in (None, 3):
        for i, ((db, rmcm, cand), (tdb, tmcm, tcand), prev, n_active) in \
                enumerate(window0_batches(scn, HET_NOC, prev_seed)):
            link_occ = rng.uniform(0.0, 5e7, TC.n_interposer_links(3, 3))
            kw = dict(n_active=n_active, prev_end=prev,
                      comm_model="congestion", link_occ=link_occ)
            l_ref, e_ref = RC.eval_model_candidates(db, rmcm, cand, **kw)
            l64, e64 = TC.eval_model_candidates(tdb, tmcm, tcand, **kw,
                                                device=CPU)
            np.testing.assert_array_equal(l64.numpy(), l_ref)
            np.testing.assert_array_equal(e64.numpy(), e_ref)
            l32, e32 = eval_candidates(tdb, tmcm, tcand, backend="torch_ref",
                                       device=CPU, **kw)
            backends = [("jax_ref", {})]
            if prev_seed is not None and i == 0:
                backends.append(("pallas", {"interpret": True}))
            for backend, extra in backends:
                l_jx, e_jx = ref_eval_candidates(db, rmcm, cand,
                                                 backend=backend, **extra,
                                                 **kw)
                np.testing.assert_allclose(l32, l_jx, rtol=F32_SCORE_RTOL)
                np.testing.assert_allclose(e32, e_jx, rtol=F32_SCORE_RTOL)
            np.testing.assert_allclose(l32, l_ref, rtol=F32_SCORE_RTOL)
            l_an, _ = TC.eval_model_candidates(
                tdb, tmcm, tcand, n_active=n_active, prev_end=prev,
                device=CPU)
            assert (l64 >= l_an - 1e-15).all()


# ------------------------- whole schedules ----------------------------------

def plan_tuples(outcome):
    return [[(p.model_idx, p.seg_ends, p.chiplets, p.pipelined)
             for p in wr.plan.plans] for wr in outcome.windows]


@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_congestion_plans_identical_across_backends(scn):
    """The reference's congestion ``beam`` schedule on 3x3 ``het_sides``
    with the ``het_rows`` NoC; the port gives its plans and its float64
    metrics through ``beam`` on the float64 (``torch``) and float32
    (``torch_ref``) backends and through the fused ``beam_jax`` search,
    which fetches once a window."""
    rmcm, tmcm = both_mcms(n_pe=n_pe_of(scn), noc="het_rows")
    ref = R.schedule(R.get_scenario(scn), rmcm, R.SearchConfig(
        algo="beam", eval_backend="numpy", comm_model="congestion"))
    for algo, backend in [("beam", "torch"), ("beam", "torch_ref"),
                          ("beam_jax", "auto")]:
        platform.reset_sync_count()
        ours = T.schedule(T.get_scenario(scn), tmcm, T.SearchConfig(
            algo=algo, eval_backend=backend, comm_model="congestion"),
            device="cpu")
        assert plan_tuples(ours) == plan_tuples(ref), (algo, backend)
        assert (ours.result.latency, ours.result.energy) == \
            (ref.result.latency, ref.result.energy)
        if algo == "beam_jax":
            assert platform.sync_count() == len(ours.windows)


# With every batch scored in float32 (the kernel's bits; the plain version
# on the CPU), dc5's congestion run breaks the same exact tie as its
# analytic run (ROADMAP.md, "Faults found in the port"): an equal-metric
# plan.  Metrics must still equal the golden record's.
F32_TIE_SCENARIOS = {"dc5_lms_seg_image_wide"}


@pytest.mark.parametrize("scn", R.SCENARIO_NAMES)
def test_all_float32_congestion_schedule_is_score_equivalent(scn):
    """6x6 ``het_cross``, ``het_rows`` NoC: every batch on the float32
    plain kernel against the golden record of the reference's default
    run."""
    import json
    import pathlib
    case = json.loads((pathlib.Path(__file__).parent / "fixtures" /
                       "torch_port_golden.json").read_text())["cases"][
        f"het_cross_6x6_congestion_het_rows/{scn}"]
    mcm = T.make_mcm("het_cross", rows=6, cols=6, n_pe=n_pe_of(scn),
                     noc=TS.noc_config("het_rows"))
    ours = T.schedule(T.get_scenario(scn), mcm, T.SearchConfig(
        path_cap=case["path_cap"], eval_backend="torch_ref",
        **case["config"]), device="cpu")
    assert (repr(ours.result.latency), repr(ours.result.energy),
            repr(ours.edp)) == (case["latency"], case["energy"],
                                case["edp"])
    got = [[[p.model_idx, list(p.seg_ends), list(p.chiplets)]
            for p in w.plan.plans] for w in ours.windows]
    assert (got == case["plans"]) == (scn not in F32_TIE_SCENARIOS)
