"""The port's schedule refinement (``core/refine.py``) against the JAX
reference.

The cases of ``tests/test_refine.py`` and
``tests/test_comm_congestion.py::test_refine_congestion_never_worse``, run
through the port: the refined schedule is never worse, valid and
deterministic, zero iterations is the identity, and under the same seed it
is the reference's outcome (plans and ``==`` float64 metrics), analytic
and congestion, called directly or through ``SearchConfig.refine_iters``.
The reference's refusal of ``refine_iters`` with warm-start anchors
stays.  Everything runs on the CPU.
"""
import pytest

import repro.core as R
from repro.core import scenarios as RS
from repro.core.refine import refine as ref_refine

import repro_torch.core as T
from repro_torch import obs
from repro_torch.core import scenarios as TS
from repro_torch.core.cost import evaluate_schedule
from repro_torch.core.refine import refine
from repro_torch.core.scheduler import get_cost_db

HET_NOC = dict(h_bw=40e9, v_bw=25e9, congestion_alpha=0.7)


def plans(outcome):
    return [[(p.model_idx, p.seg_ends, p.chiplets, p.pipelined)
             for p in w.plan.plans] for w in outcome.windows]


@pytest.fixture(scope="module")
def base():
    sc = T.get_scenario("xr10_vr_gaming")
    mcm = T.make_mcm("het_sides", n_pe=256)
    out = T.run_config(sc, "het_sides", n_pe=256,
                       cfg=T.SearchConfig(metric="edp"), device="cpu")
    return sc, mcm, out


def test_refine_never_worse(base):
    sc, mcm, out = base
    ref = refine(sc, mcm, out, iters=300, seed=1, device="cpu")
    assert ref.result.edp <= out.edp * (1 + 1e-12)


def test_refined_schedule_is_valid(base):
    sc, mcm, out = base
    ref = refine(sc, mcm, out, iters=300, seed=2, device="cpu")
    db = get_cost_db(sc, mcm)
    res = evaluate_schedule(db, mcm, [w.plan for w in ref.windows],
                            validate=True)
    assert res.latency == pytest.approx(ref.result.latency)
    seen = set()
    for w in ref.windows:
        for p in w.plan.plans:
            for li in range(p.start, p.end):
                assert li not in seen
                seen.add(li)
    assert len(seen) == db.n_layers


def test_refine_deterministic_and_counts_moves(base):
    sc, mcm, out = base
    acc, rej = (obs.counter("refine.moves." + k) for k in ("accepted",
                                                          "rejected"))
    a0, r0 = acc.value, rej.value
    r1 = refine(sc, mcm, out, iters=200, seed=7, device="cpu")
    assert 0 < (acc.value - a0) + (rej.value - r0) <= 200
    r2 = refine(sc, mcm, out, iters=200, seed=7, device="cpu")
    assert r1.result.edp == r2.result.edp
    assert plans(r1) == plans(r2)


def test_refine_zero_iters_is_identity(base):
    sc, mcm, out = base
    ref = refine(sc, mcm, out, iters=0, seed=0, device="cpu")
    assert ref.result.edp == out.edp
    assert plans(ref) == plans(out)


# (scenario, pattern, rows, NoC: None = analytic, iters, seed)
SAME_SEED = [
    ("xr10_vr_gaming", "het_sides", 3, None, 300, 1),
    ("dc3_lms_image_heavy", "het_sides", 3, HET_NOC, 60, 2),
    ("dc4_lms_seg_image", "het_cross", 6, None, 300, 0),
    ("xr10_vr_gaming", "het_cross", 6, "het_rows", 300, 0),
    ("dc2_lms_image_light", "het_cross", 6, "narrow", 200, 5),
]


def noc_pair(noc):
    if noc is None:
        return None, None
    if isinstance(noc, str):
        return RS.noc_config(noc), TS.noc_config(noc)
    from repro_torch.core.chiplet import NoCConfig
    return R.chiplet.NoCConfig(**noc), NoCConfig(**noc)


@pytest.mark.parametrize("scn,pattern,rows,noc,iters,seed", SAME_SEED)
def test_refine_matches_reference_under_the_same_seed(scn, pattern, rows,
                                                      noc, iters, seed):
    """Refinement of the same ``beam`` schedule, directly and through
    ``SearchConfig.refine_iters``: the reference's plans and metrics; the
    congestion runs (decongest move in the mix) never worse."""
    n_pe = 4096 if scn.startswith("dc") else 256
    r_noc, t_noc = noc_pair(noc)
    comm = "analytic" if noc is None else "congestion"
    rsc, rmcm = R.get_scenario(scn), R.make_mcm(pattern, rows=rows,
                                                cols=rows, n_pe=n_pe,
                                                noc=r_noc)
    tsc, tmcm = T.get_scenario(scn), T.make_mcm(pattern, rows=rows,
                                                cols=rows, n_pe=n_pe,
                                                noc=t_noc)
    rbase = R.schedule(rsc, rmcm, R.SearchConfig(algo="beam",
                                                 comm_model=comm))
    tbase = T.schedule(tsc, tmcm, T.SearchConfig(algo="beam",
                                                 comm_model=comm),
                       device="cpu")
    assert plans(tbase) == plans(rbase)
    ref = ref_refine(rsc, rmcm, rbase, iters=iters, seed=seed,
                     comm_model=comm)
    ours = refine(tsc, tmcm, tbase, iters=iters, seed=seed, comm_model=comm,
                  device="cpu")
    assert plans(ours) == plans(ref)
    assert (ours.result.latency, ours.result.energy, ours.edp) == \
        (ref.result.latency, ref.result.energy, ref.edp)
    assert ours.result.edp <= tbase.result.edp * (1 + 1e-12)
    via_cfg = T.schedule(tsc, tmcm, T.SearchConfig(
        algo="beam", comm_model=comm, refine_iters=iters, seed=seed),
        device="cpu")
    ref_cfg = R.schedule(rsc, rmcm, R.SearchConfig(
        algo="beam", comm_model=comm, refine_iters=iters, seed=seed))
    assert plans(via_cfg) == plans(ref_cfg)
    assert via_cfg.edp == ref_cfg.edp


def test_refine_with_warm_start_anchors_refused():
    """As in the reference: ``refine_iters`` with warm-start anchors."""
    sc, mcm = T.get_scenario("xr10_vr_gaming"), T.make_mcm("het_sides",
                                                           n_pe=256)
    with pytest.raises(NotImplementedError, match="warm-start"):
        T.schedule(sc, mcm, T.SearchConfig(refine_iters=10),
                   prev_end={0: 0}, device="cpu")
    with pytest.raises(NotImplementedError, match="warm-start"):
        R.schedule(R.get_scenario("xr10_vr_gaming"),
                   R.make_mcm("het_sides", n_pe=256),
                   R.SearchConfig(refine_iters=10), prev_end={0: 0})
