"""The port's SLO-aware serving against the JAX reference: service classes,
drain and preempt boundaries, MCM reconfiguration (CPU, 3x3 smoke traces).

Under ``auto`` every run equals ``repro.online.simulate`` on the same trace
(``==`` on every epoch, sample and report scalar).  Float32 runs are held
against the reference's ``jax_ref`` record of ``dc_churn_slo_smoke``
(preempt + reconfiguration) in ``tests/fixtures/torch_online_golden.json``:
they depart only on exact ties (ROADMAP.md §3).
"""
import json
import math
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_online_golden as golden  # noqa: E402

import repro.core as R  # noqa: E402
import repro.online as RO  # noqa: E402
from repro.online import slo as ref_slo  # noqa: E402
from repro.online.simulator import iteration_split as ref_split  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.online as TO  # noqa: E402
from repro_torch.online import slo  # noqa: E402
from repro_torch.online.simulator import iteration_split  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures"
with open(golden.GOLDEN) as fh:
    GOLDEN = json.load(fh)["runs"]

SMALL = dict(pattern="het_cross", rows=3, cols=3, n_pe=1024)
SMALL_CFG = dict(path_cap=32, seg_cap=64, n_splits=2)
SLO_F32 = "smoke/dc_churn_slo_smoke/preempt_reconfig/jax_ref"
# the exact ties the port's float32 runs break the other way on this trace
# (ROADMAP.md §3): epochs whose plan differs and whose float64 latency,
# energy and EDP are == the reference's
SLO_F32_TIES = [1, 5]

POLICIES = {
    "instant": dict(),
    "drain": dict(boundary="drain"),
    "preempt": dict(boundary="preempt"),
    "preempt_reconfig": dict(boundary="preempt",
                             reconfig_patterns=("het_sides", "het_cb"),
                             reconfig_hysteresis=0.1),
    "preempt_reconfig_eager": dict(boundary="preempt",
                                   reconfig_patterns=("het_sides", "het_cb"),
                                   reconfig_hysteresis=0.0),
}


def run_both(trace_name, policy, mode="warm", trace=None):
    rt = trace or RO.Trace.load(str(FIXTURES / f"trace_{trace_name}.json"))
    pt = TO.Trace.from_json(rt.to_json())
    ref = RO.simulate(rt, mode=mode, cfg=R.SearchConfig(**SMALL_CFG),
                      policy=RO.OnlinePolicy(**policy), **SMALL)
    ours = TO.simulate(pt, mode=mode, cfg=T.SearchConfig(**SMALL_CFG),
                       policy=TO.OnlinePolicy(**policy), device="cpu",
                       **SMALL)
    return ref, ours


def record(sim, ref: bool):
    mod = RO if ref else TO
    return golden.sim_record(sim, mod.qos_report, mod.slo_report)


def samples(sim):
    return [(s.t, s.model, s.tenant, s.slo, s.latency, s.weight, s.deadline,
             s.missed) for s in sim.slo_samples]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_slo_smoke_equals_reference_under_auto(policy):
    ref, ours = run_both("dc_churn_slo_smoke", POLICIES[policy])
    assert record(ours, False) == record(ref, True)
    assert samples(ours) == samples(ref)
    assert ours.n_preemptions == ref.n_preemptions
    assert ours.n_switches == ref.n_switches
    if policy.startswith("preempt"):
        assert ours.n_preemptions >= 1
    if policy == "preempt_reconfig_eager":
        assert ours.n_switches >= 1


def test_slo_float32_record_is_current():
    assert golden.reference_record(SLO_F32) == GOLDEN[SLO_F32]["record"]


@pytest.mark.parametrize("change", [{}, dict(algo="beam_jax")])
def test_float32_runs_depart_only_on_exact_ties(change):
    rec = golden.port_record(SLO_F32, "cpu", **change)
    want = GOLDEN[SLO_F32]["record"]
    diff, ties = golden.tie_departures(rec, want)
    assert diff == ties == SLO_F32_TIES
    assert [e["pattern"] for e in rec["epochs"]] == \
        [e["pattern"] for e in want["epochs"]]
    assert [e["switched"] for e in rec["epochs"]] == \
        [e["switched"] for e in want["epochs"]]


@pytest.mark.parametrize("change", [{}, dict(algo="beam_jax")])
def test_preempt_reconfig_warm_equals_cold(change):
    trace = TO.Trace.load(str(FIXTURES / "trace_dc_churn_slo_smoke.json"))
    kw = dict(cfg=T.SearchConfig(**SMALL_CFG, **change), device="cpu",
              policy=TO.OnlinePolicy(**POLICIES["preempt_reconfig_eager"]),
              **SMALL)
    cold = TO.simulate(trace, mode="cold", **kw)
    warm = TO.simulate(trace, mode="warm", **kw)
    assert golden.without_memo(record(warm, False)) == \
        golden.without_memo(record(cold, False))
    assert samples(warm) == samples(cold)
    assert warm.n_switches == cold.n_switches >= 1


def test_hysteresis_inf_is_the_fixed_pattern_rescheduler():
    trace = TO.Trace.load(str(FIXTURES / "trace_dc_churn_slo_smoke.json"))
    kw = dict(cfg=T.SearchConfig(**SMALL_CFG), device="cpu", **SMALL)
    fixed = TO.simulate(trace, policy=TO.OnlinePolicy(boundary="preempt"),
                        **kw)
    inf_h = TO.simulate(trace, policy=TO.OnlinePolicy(
        boundary="preempt", reconfig_patterns=("het_sides", "het_cb"),
        reconfig_hysteresis=math.inf), **kw)
    assert inf_h.n_switches == 0
    # the SLO re-planner names the pattern it plans on; the plain one, None
    assert {e.pattern for e in inf_h.epochs if e.outcome} == {"het_cross"}
    assert {e.pattern for e in fixed.epochs} == {None}

    def unnamed(sim):
        rec = record(sim, False)
        rec["epochs"] = [dict(e, pattern=None) for e in rec["epochs"]]
        return rec
    assert unnamed(inf_h) == unnamed(fixed)
    assert samples(inf_h) == samples(fixed)


def _two_tenant(mod, slo0, slo1):
    events = (mod.Event(t=0.0, kind="arrive", model="bert-l", tenant=0,
                        batch=3, slo=slo0),
              mod.Event(t=0.02, kind="arrive", model="googlenet", tenant=1,
                        batch=4, slo=slo1))
    return mod.Trace(name="two", kind="churn", horizon=0.6, events=events)


@pytest.mark.parametrize("classes,policy", [
    (("best_effort", "latency_critical"), "drain"),
    (("best_effort", "latency_critical"), "preempt"),
    (("standard", "standard"), "preempt"),
])
def test_preemption_semantics_match_reference(classes, policy):
    ref, ours = run_both(None, POLICIES[policy],
                         trace=_two_tenant(RO, *classes))
    assert samples(ours) == samples(ref)
    assert record(ours, False) == record(ref, True)
    if classes[0] == "standard":
        assert ours.n_preemptions == 0
    elif policy == "preempt":
        assert ours.n_preemptions >= 1


def test_slo_helpers_match_reference():
    assert {k: (c.weight, c.deadline_factor, c.preemptible)
            for k, c in slo.SLO_CLASSES.items()} == \
        {k: (c.weight, c.deadline_factor, c.preemptible)
         for k, c in ref_slo.SLO_CLASSES.items()}
    assert slo.get_slo(None).name == ref_slo.get_slo(None).name
    with pytest.raises(KeyError):
        slo.get_slo("gold")
    pml = {0: 0.3, 1: 0.05, 2: 0.125}
    classes = {0: "best_effort", 1: "latency_critical"}
    for metric in ("latency", "energy", "edp"):
        assert slo.class_weighted_score(pml, 2.5, classes, metric) == \
            ref_slo.class_weighted_score(pml, 2.5, classes, metric)
    chunks = ((0.01, 3), (0.02, 4), (0.005, 1))
    for elapsed in (0.0, 0.01, 0.015, 0.03, 0.035, 1.0):
        assert iteration_split(chunks, elapsed) == ref_split(chunks, elapsed)
    with pytest.raises(ValueError):
        iteration_split(chunks, -1.0)


def test_slorescheduler_shares_memo_across_switches():
    mcm = T.make_mcm(**SMALL)
    rs = TO.SLORescheduler(mcm, cfg=T.SearchConfig(**SMALL_CFG),
                           patterns=("het_sides",), hysteresis=0.0,
                           device="cpu")
    r0 = rs.replan([(0, "bert-l", 3)])
    ref = RO.SLORescheduler(R.make_mcm(**SMALL),
                            cfg=R.SearchConfig(**SMALL_CFG),
                            patterns=("het_sides",), hysteresis=0.0)
    q0 = ref.replan([(0, "bert-l", 3)])
    assert (r0.pattern, r0.switched) == (q0.pattern, q0.switched)
    planner = rs._planners[r0.pattern]
    planner._last = None
    assert rs.replan([(9, "bert-l", 3)]).memo_hit
    assert all(p.device.type == "cpu" for p in rs._planners.values())
