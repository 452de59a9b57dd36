"""The port's stochastic search engines against the JAX reference.

The cases of ``tests/test_engine.py`` and ``tests/test_core_engines.py``
for ``EvolutionaryEngine``, ``AnnealEngine`` and ``search.py``, run through
the port and held against ``repro``:

* seeded schedules with ``algo="evolutionary"`` and ``algo="anneal"``
  give the reference's plans and ``==`` float64 metrics (3x3 and the
  paper's 6x6, analytic and congestion), and repeat themselves;
* the engines over the same candidate sets (built by the reference and
  carried across) give the reference's window plans and explored clouds;
* ``search._fitness``, the scalar oracle, equals ``batched_fitness`` bit
  for bit, and both equal the reference's;
* an EA that can only propose overlapping picks repairs through the beam
  engine; ``evolutionary_combine`` equals the engine; anneal never ends
  worse than the greedy picks; ``get_engine`` builds every engine; the
  anneal move counters count.

Everything runs on the CPU.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core import engine as RE
from repro.core import search as RSearch
from repro.core.reconfig import greedy_pack as ref_greedy_pack
from repro.core.scheduler import build_window_sets as ref_window_sets
from repro.core.scheduler import get_cost_db as ref_get_cost_db

import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import engine as TE
from repro_torch.core import scenarios as TS
from repro_torch.core.maestro import cost_db_from_arrays
from repro_torch.core.search import _fitness, evolutionary_combine


def n_pe_of(scn):
    return 4096 if scn.startswith("dc") else 256


def plan_tuples(plans):
    return [(p.model_idx, p.seg_ends, p.chiplets, p.pipelined)
            for p in plans.plans]


def outcome_plans(outcome):
    return [plan_tuples(w.plan) for w in outcome.windows]


def reference_windows(scn, pattern="het_sides"):
    """Per window: the reference's candidate sets (scheduler-built) and
    anchors along its beam trajectory, with the port's CostDB and MCM."""
    sc = R.get_scenario(scn)
    mcm = R.make_mcm(pattern, n_pe=n_pe_of(scn))
    cfg = R.SearchConfig()
    db = ref_get_cost_db(sc, mcm)
    prev_end: dict[int, int] = {}
    out = []
    for ranges in ref_greedy_pack(db, mcm.class_counts(),
                                  cfg.n_splits).ranges:
        sets = ref_window_sets(db, mcm, cfg, ranges, prev_end)
        out.append((sets, dict(prev_end)))
        wr = RE.reference_combine(db, mcm, sets, prev_end, beam=cfg.beam)
        prev_end = dict(prev_end)
        prev_end.update(wr.result.end_chiplet)
    tdb = cost_db_from_arrays({f.name: getattr(db, f.name)
                               for f in dataclasses.fields(db)})
    return (db, mcm), (tdb, T.make_mcm(pattern, n_pe=n_pe_of(scn))), out


def as_port_sets(sets):
    return [TE.ModelCandidateSet(**{f.name: getattr(cs, f.name)
                                    for f in dataclasses.fields(cs)})
            for cs in sets]


# ------------------------- whole schedules ----------------------------------

SEEDED = [  # (scenario, pattern, rows, algo, seed, NoC preset)
    ("dc4_lms_seg_image", "het_cross", 6, "evolutionary", 11, None),
    ("xr9_social", "het_cross", 6, "evolutionary", 1, None),
    ("xr10_vr_gaming", "het_sides", 3, "evolutionary", 0, None),
    ("dc2_lms_image_light", "het_cross", 6, "evolutionary", 4, "het_rows"),
    ("xr10_vr_gaming", "het_sides", 3, "anneal", 5, None),
    ("xr7_ar_gaming", "het_cross", 6, "anneal", 2, None),
    ("dc3_lms_image_heavy", "het_cross", 6, "anneal", 0, None),
    ("dc1_lms", "het_cross", 6, "anneal", 3, "narrow"),
]


@pytest.mark.parametrize("scn,pattern,rows,algo,seed,noc", SEEDED)
def test_seeded_schedule_matches_reference(scn, pattern, rows, algo, seed,
                                           noc):
    kw = dict(algo=algo, seed=seed)
    if noc:
        kw["comm_model"] = "congestion"
    ref = R.schedule(R.get_scenario(scn), R.make_mcm(
        pattern, rows=rows, cols=rows, n_pe=n_pe_of(scn),
        noc=R.scenarios.noc_config(noc) if noc else None),
        R.SearchConfig(**kw))
    mcm = T.make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe_of(scn),
                     noc=TS.noc_config(noc) if noc else None)
    outs = [T.schedule(T.get_scenario(scn), mcm, T.SearchConfig(**kw),
                       device="cpu") for _ in range(2)]
    for ours in outs:
        assert outcome_plans(ours) == outcome_plans(ref)
        assert (ours.result.latency, ours.result.energy, ours.edp) == \
            (ref.result.latency, ref.result.energy, ref.edp)
        for wr in ours.windows:
            wr.plan.validate()


# ----------------------- engines on the same sets ---------------------------

@pytest.mark.parametrize("scn", ["xr9_social", "dc4_lms_seg_image"])
def test_engines_match_reference_on_the_same_sets(scn):
    """Every window of the reference's 3x3 trajectory: the port's EA and
    anneal over the reference's candidate sets give the reference's plans,
    metrics and explored clouds."""
    (db, mcm), (tdb, tmcm), windows = reference_windows(scn)
    for w, (sets, prev_end) in enumerate(windows):
        tsets = as_port_sets(sets)
        for ref_eng, eng in (
                (RE.EvolutionaryEngine(seed=w), TE.EvolutionaryEngine(seed=w)),
                (RE.AnnealEngine(iters=60, chains=12, seed=w),
                 TE.AnnealEngine(iters=60, chains=12, seed=w))):
            ref = ref_eng.combine(db, mcm, sets, prev_end, metric="edp")
            ours = eng.combine(tdb, tmcm, tsets, prev_end, metric="edp")
            assert plan_tuples(ours.plan) == plan_tuples(ref.plan)
            assert (ours.result.latency, ours.result.energy) == \
                (ref.result.latency, ref.result.energy)
            assert ours.explored == ref.explored


@pytest.mark.parametrize("metric", ["latency", "energy", "edp"])
def test_batched_fitness_matches_scalar_and_reference(metric):
    (_, mcm), (_, tmcm), windows = reference_windows("xr7_ar_gaming",
                                                     "het_cb")
    sets, _ = windows[0]
    tsets = as_port_sets(sets)
    ct = TE.CandidateTensors.from_sets(tsets, tmcm.n_chiplets)
    rng = np.random.default_rng(0)
    sizes = np.array([cs.n_cands for cs in sets])
    picks = np.stack([rng.integers(0, sizes) for _ in range(64)])
    fit, lmax, esum, overlap = TE.batched_fitness(ct, picks, metric)
    expect = np.array([_fitness(tsets, row, metric) for row in picks])
    assert (fit == expect).all()
    ref = RE.batched_fitness(RE.CandidateTensors.from_sets(
        sets, mcm.n_chiplets), picks, metric)
    for a, b in zip((fit, lmax, esum, overlap), ref):
        np.testing.assert_array_equal(a, b)
    assert (expect == np.array([RSearch._fitness(sets, row, metric)
                                for row in picks])).all()


def test_ea_overlap_repair_fallback():
    """A population that can only propose overlapping picks falls back to
    the beam repair and returns its valid plan, as the reference does."""
    (db, mcm), (tdb, tmcm), windows = reference_windows("xr9_social")
    sets, prev_end = next((s, p) for s, p in windows if len(s) >= 2)
    a, b = as_port_sets(sets[:2])

    def truncate(cs, idx):
        return TE.ModelCandidateSet(
            model_idx=cs.model_idx, start=cs.start, end=cs.end,
            seg_ends_abs=[cs.seg_end(i) for i in idx],
            paths=[cs.path(i) for i in idx],
            masks=[cs.mask_ints()[i] for i in idx],
            lat=cs.lat[list(idx)], energy=cs.energy[list(idx)], keep=cs.keep)

    overlap_i = next(i for i, m in enumerate(b.mask_ints())
                     if m & a.mask_ints()[0])
    disjoint_i = next(i for i, m in enumerate(b.mask_ints())
                      if not (m & a.mask_ints()[0]))
    pair = [truncate(a, [0]), truncate(b, [overlap_i, disjoint_i])]
    eng = TE.EvolutionaryEngine(population=1, generations=2,
                                mutation_rate=0.0, seed=0)
    res = eng.combine(tdb, tmcm, pair, prev_end, metric="edp")
    res.plan.validate()
    beam = TE.BeamEngine().combine(tdb, tmcm, pair, prev_end, metric="edp")
    assert plan_tuples(res.plan) == plan_tuples(beam.plan)
    assert res.result.latency == beam.result.latency
    ref_pair = [RE.ModelCandidateSet(**{f.name: getattr(cs, f.name) for f in
                                        dataclasses.fields(cs)})
                for cs in pair]
    ref = RE.EvolutionaryEngine(population=1, generations=2,
                                mutation_rate=0.0, seed=0).combine(
        db, mcm, ref_pair, prev_end, metric="edp")
    assert plan_tuples(res.plan) == plan_tuples(ref.plan)
    assert res.explored == ref.explored


@pytest.mark.parametrize("seed", [3, 8])
def test_evolutionary_combine_matches_engine_and_reference(seed):
    (db, mcm), (tdb, tmcm), windows = reference_windows("xr9_social",
                                                        "het_cb")
    sets, prev_end = windows[0]
    tsets = as_port_sets(sets)
    w = evolutionary_combine(tdb, tmcm, tsets, prev_end, seed=seed)
    e = TE.EvolutionaryEngine(seed=seed).combine(tdb, tmcm, tsets, prev_end)
    ref = RSearch.evolutionary_combine(db, mcm, sets, prev_end, seed=seed)
    assert plan_tuples(w.plan) == plan_tuples(e.plan) == \
        plan_tuples(ref.plan)


def test_anneal_no_worse_than_greedy_and_counts_moves():
    """Chain 0 starts from the per-model greedy picks, so the annealed
    window never ends worse than them; the move counters count every
    proposal and acceptance."""
    (_, _), (tdb, tmcm), windows = reference_windows("xr7_ar_gaming",
                                                     "het_cb")
    sets, prev_end = windows[0]
    tsets = as_port_sets(sets)
    ct = TE.CandidateTensors.from_sets(tsets, tmcm.n_chiplets)
    gfit, _, _, goverlap = TE.batched_fitness(
        ct, np.zeros((1, len(tsets)), np.int64), "edp")
    proposed = obs.counter("engine.anneal.moves_proposed")
    accepted = obs.counter("engine.anneal.moves_accepted")
    p0, a0 = proposed.value, accepted.value
    res = TE.AnnealEngine(iters=100, chains=8, seed=0).combine(
        tdb, tmcm, tsets, prev_end, metric="edp")
    res.plan.validate()
    assert proposed.value - p0 == 800
    assert 0 < accepted.value - a0 <= 800
    if int(goverlap[0]) == 0:
        assert res.result.edp <= float(gfit[0]) * (1 + 1e-12)


def test_get_engine_selects_algo():
    assert isinstance(TE.get_engine(T.SearchConfig(algo="brute")),
                      TE.BeamEngine)
    assert isinstance(TE.get_engine(T.SearchConfig(algo="beam")),
                      TE.BeamEngine)
    dev = TE.get_engine(T.SearchConfig(algo="beam_jax", beam=96),
                        device="cpu")
    assert isinstance(dev, TE.DeviceBeamEngine) and dev.beam == 96
    ea = TE.get_engine(T.SearchConfig(algo="evolutionary",
                                      ea_population=7), seed=7)
    assert isinstance(ea, TE.EvolutionaryEngine)
    assert (ea.seed, ea.population) == (7, 7)
    an = TE.get_engine(T.SearchConfig(algo="anneal",
                                      comm_model="congestion"), seed=9)
    assert isinstance(an, TE.AnnealEngine)
    assert (an.seed, an.chains, an.comm_model) == (9, 48, "congestion")
    with pytest.raises(KeyError):
        TE.get_engine(T.SearchConfig(algo="gradient_descent"))
