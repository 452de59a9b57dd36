"""The port's online layer against the JAX reference: traces, re-planning,
warm and cold, the simulator and its QoS accounting (CPU, small sizes).

Every comparison is ``==`` on the same inputs: the port's traces against
the reference's generators and the committed fixtures, its simulations
against ``repro.online.simulate`` under ``auto`` (float64 scoring, bitwise
the reference's), and its float32 runs (``torch_ref``, the fused
``beam_jax`` search) against the reference's ``jax_ref`` record in
``tests/fixtures/torch_online_golden.json``, where an epoch may only
depart on an exact tie: its plan differs, its float64 latency, energy and
EDP are ``==`` (ROADMAP.md §3).
"""
import json
import math
import multiprocessing as mp
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_online_golden as golden  # noqa: E402

import repro.core as R  # noqa: E402
import repro.online as RO  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.online as TO  # noqa: E402
from repro_torch.launch import platform  # noqa: E402
from repro_torch.online.metrics import weighted_percentile  # noqa: E402
from repro_torch.online.simulator import (FrameRecord, SimResult,  # noqa: E402
                                          per_model_latency, replay_cadence)

FIXTURES = ROOT / "tests" / "fixtures"
with open(golden.GOLDEN) as fh:
    GOLDEN = json.load(fh)["runs"]

SMALL = dict(pattern="het_cross", rows=3, cols=3, n_pe=1024)
SMALL_CFG = dict(path_cap=32, seg_cap=64, n_splits=2)
CADENCE = dict(pattern="het_sides", rows=3, cols=3, n_pe=256)
SMOKE_F32 = "smoke/dc_churn_smoke/jax_ref"


def ref_record(sim):
    return golden.sim_record(sim, RO.qos_report, RO.slo_report)


def port_record(sim):
    return golden.sim_record(sim, TO.qos_report, TO.slo_report)


def plans_of(outcome):
    return [[(p.model_idx, p.seg_ends, p.chiplets) for p in wr.plan.plans]
            for wr in outcome.windows]


# ------------------------------ traces --------------------------------------

@pytest.mark.parametrize("preset", sorted(R.TRACE_PRESETS))
def test_presets_match_reference_and_roundtrip(preset):
    assert sorted(T.TRACE_PRESETS) == sorted(R.TRACE_PRESETS)
    tr = T.get_trace(preset)
    assert tr.to_json() == R.get_trace(preset).to_json()
    assert TO.Trace.from_json(tr.to_json()) == tr
    assert tr.events == tuple(sorted(tr.events, key=TO.Event.sort_key))


@pytest.mark.parametrize("preset", ["dc_churn_smoke", "xr8_cadence",
                                    "dc_churn_8x8_slo", "dc_churn_slo_smoke"])
def test_committed_fixtures_regenerate(preset):
    path = FIXTURES / f"trace_{preset}.json"
    assert TO.Trace.load(str(path)) == T.get_trace(preset)
    assert T.get_trace(preset).to_json() == \
        TO.Trace.load(str(path)).to_json() == \
        RO.Trace.load(str(path)).to_json()


@pytest.mark.parametrize("preset", sorted(
    p for p, s in R.TRACE_PRESETS.items() if s["kind"] != "cadence"))
def test_streaming_matches_materialised(preset):
    events, horizon = T.iter_trace_events(preset)
    tr = T.get_trace(preset)
    assert tuple(events) == tr.events and horizon == tr.horizon
    with pytest.raises(KeyError):
        T.iter_trace_events("xr8_cadence")


def test_generators_match_reference_call_for_call():
    kw = dict(seed=7, horizon=200.0, arrival_rate=1.5, mean_lifetime=2.0,
              max_active=3, slo_mix={"latency_critical": 0.3,
                                     "best_effort": 0.3})
    assert ([e.__dict__ for e in TO.iter_poisson_churn(**kw)]
            == [e.__dict__ for e in RO.iter_poisson_churn(**kw)])
    kw = dict(seed=5, horizon=30.0, base_rate=8.0, mean_lifetime=0.7,
              zoo=(("bert-base", 8), ("resnet-50", 8)),
              request_rate=(0.25, 8.0), block=64)
    ours = [e.__dict__ for e in TO.iter_open_loop_churn(**kw)]
    assert len(ours) > 200
    assert ours == [e.__dict__ for e in RO.iter_open_loop_churn(**kw)]
    assert ([e.__dict__ for e in TO.iter_frame_cadence("xr6_ar_assistant",
                                                       0.3)]
            == [e.__dict__ for e in RO.iter_frame_cadence("xr6_ar_assistant",
                                                          0.3)])


def test_merge_is_partition_invariant():
    evs = list(T.get_trace("dc_fleet_smoke").events)
    parts = [evs[i::3] for i in range(3)]
    assert tuple(TO.merge_events(*parts)) == tuple(evs)
    assert tuple(TO.merge_events(*reversed(parts))) == tuple(evs)


def _trace_json(preset, q):
    import repro_torch.core as core
    q.put(json.dumps(core.get_trace(preset).to_json(), sort_keys=True))


@pytest.mark.parametrize("preset", ["dc_churn_smoke", "xr8_cadence"])
def test_trace_identical_in_a_spawned_process(preset):
    """Same seed -> byte-identical trace in a fresh ``spawn`` process, which
    never touches CUDA (the generators are host numpy)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_trace_json, args=(preset, q))
    p.start()
    child = q.get(timeout=120)
    p.join()
    assert child == json.dumps(T.get_trace(preset).to_json(), sort_keys=True)


# ------------------------ simulate vs the reference -------------------------

@pytest.mark.parametrize("preset,geo,cfg", [
    ("dc_churn_smoke", SMALL, SMALL_CFG),
    ("xr8_cadence", CADENCE, dict(path_cap=32, seg_cap=64)),
    ("xr8_cadence", CADENCE, {}),
])
def test_simulate_equals_reference_under_auto(preset, geo, cfg):
    ref = RO.simulate(R.get_trace(preset), cfg=R.SearchConfig(**cfg), **geo)
    ours = TO.simulate(T.get_trace(preset), cfg=T.SearchConfig(**cfg),
                       device="cpu", **geo)
    assert port_record(ours) == ref_record(ref)
    assert [(f.t, f.model, f.latency, f.missed, f.energy)
            for f in ours.frames] == [(f.t, f.model, f.latency, f.missed,
                                       f.energy) for f in ref.frames]


def test_smoke_float32_record_is_current():
    assert golden.reference_record(SMOKE_F32) == GOLDEN[SMOKE_F32]["record"]


@pytest.mark.parametrize("change", [{}, dict(algo="beam_jax")])
def test_float32_runs_meet_the_reference_float32_record(change):
    """``torch_ref`` (the kernel's plain version on every batch) and the
    fused ``beam_jax`` search against the reference's ``jax_ref`` run."""
    rec = golden.port_record(SMOKE_F32, "cpu", **change)
    want = GOLDEN[SMOKE_F32]["record"]
    diff, ties = golden.tie_departures(rec, want)
    assert diff == ties == []
    assert rec == want


def test_cadence_float32_runs_equal_reference_float32_run():
    """``xr8_cadence`` with every batch in float32: ``torch_ref`` and the
    fused ``beam_jax`` search against the reference's ``jax_ref`` run."""
    cfg = dict(path_cap=32, seg_cap=64)
    ref = RO.simulate(R.get_trace("xr8_cadence"),
                      cfg=R.SearchConfig(eval_backend="jax_ref", **cfg),
                      **CADENCE)
    for change in (dict(eval_backend="torch_ref"), dict(algo="beam_jax")):
        ours = TO.simulate(T.get_trace("xr8_cadence"),
                           cfg=T.SearchConfig(**change, **cfg),
                           device="cpu", **CADENCE)
        assert port_record(ours) == ref_record(ref)


@pytest.mark.parametrize("change", [{}, dict(eval_backend="torch_ref"),
                                    dict(algo="beam_jax")])
def test_warm_equals_cold_per_backend(change):
    """Every epoch of the committed churn fixture: the warm re-planner's
    plan and accounting are bit-identical to the cold oracle's."""
    trace = TO.Trace.load(str(FIXTURES / "trace_dc_churn_smoke.json"))
    cfg = T.SearchConfig(**SMALL_CFG, **change)
    cold = TO.simulate(trace, mode="cold", cfg=cfg, device="cpu", **SMALL)
    warm = TO.simulate(trace, mode="warm", cfg=cfg, device="cpu", **SMALL)
    assert warm.n_memo_hits >= 1 and cold.n_memo_hits == 0
    assert golden.without_memo(port_record(warm)) == \
        golden.without_memo(port_record(cold))


def test_cold_replan_drops_every_planning_cache():
    """Cold clears the CostDB memo, the path LRU and the device tables, and
    resets their counters (the disk layer's too)."""
    from repro_torch import obs
    from repro_torch.core import quantize
    trace = T.get_trace("dc_churn_smoke")
    TO.simulate(trace, mode="warm", device="cpu", **SMALL,
                cfg=T.SearchConfig(**SMALL_CFG, algo="beam_jax"))
    assert quantize._POW10_ON and obs.counters("costdb.")["costdb.cache_hit"]
    T.clear_caches()
    assert not quantize._POW10_ON
    assert all(v == 0 for v in obs.counters("costdb.").values())
    assert all(v == 0 for k, v in obs.counters().items()
               if k.endswith((".cache_hit", ".cache_miss")))


@pytest.mark.parametrize("change,per", [({}, "batch"),
                                        (dict(algo="beam_jax"), "window")])
def test_replan_ends_in_its_counted_fetches(change, per):
    """A cold re-plan fetches once per scoring batch (``beam``) or once per
    window (``beam_jax``), so its wall clock covers its device work."""
    from repro_torch import obs
    mcm = T.make_mcm(**SMALL)
    rs = TO.Rescheduler(mcm, cfg=T.SearchConfig(**SMALL_CFG, **change),
                        mode="cold", device="cpu")
    tenants = [(0, "bert-l", 3), (1, "resnet-50", 32)]
    obs.reset()
    platform.reset_sync_count()
    rec = rs.replan(tenants)
    syncs = platform.sync_count()
    if per == "batch":
        calls = sum(v for k, v in obs.counters("evaluator.eval_calls.")
                    .items())
        assert syncs == calls > 0
    else:
        assert syncs == len(rec.outcome.windows) > 0
    assert rec.wall_s > 0


# ----------------------- the re-planner ------------------------------------

def test_rescheduler_memo_hit_and_anchor_carryover():
    mcm = T.make_mcm(**SMALL)
    cfg = T.SearchConfig(**SMALL_CFG)
    rs = TO.Rescheduler(mcm, cfg=cfg, mode="warm", device="cpu")
    r0 = rs.replan([(0, "bert-l", 3)])
    assert not r0.memo_hit and r0.anchors == {}
    r1 = rs.replan([(0, "bert-l", 3), (1, "resnet-50", 4)])
    mi0 = r0.tenant_order.index(0)
    assert r1.anchors[0] == T.final_anchors(r0.outcome)[mi0]
    # the reference, same queries: same plans and anchors
    rr = RO.Rescheduler(R.make_mcm(**SMALL), cfg=R.SearchConfig(**SMALL_CFG))
    q0 = rr.replan([(0, "bert-l", 3)])
    q1 = rr.replan([(0, "bert-l", 3), (1, "resnet-50", 4)])
    assert plans_of(r0.outcome) == plans_of(q0.outcome)
    assert plans_of(r1.outcome) == plans_of(q1.outcome)
    assert r1.anchors == q1.anchors
    rs2 = TO.Rescheduler(mcm, cfg=cfg, mode="warm", device="cpu")
    a = rs2.replan([(5, "bert-l", 3)])
    rs2._last = None                    # an idle gap: no carried state
    b = rs2.replan([(9, "bert-l", 3)])
    assert not a.memo_hit and b.memo_hit
    assert plans_of(a.outcome) == plans_of(b.outcome)


def test_schedule_incremental_matches_schedule_with_anchors():
    from repro_torch.core.modelzoo import get_model
    from repro_torch.core.workload import Scenario
    mcm = T.make_mcm(**SMALL)
    cfg = T.SearchConfig(**SMALL_CFG)
    sc0 = Scenario("online[a]", (get_model("bert-l", 3),))
    prior = T.schedule(sc0, mcm, cfg, device="cpu")
    sc1 = Scenario("online[ab]", (get_model("bert-l", 3),
                                  get_model("googlenet", 4)))
    inc = T.schedule_incremental(sc1, mcm, cfg, prior=prior,
                                 persisting={0: 0}, device="cpu")
    direct = T.schedule(sc1, mcm, cfg, device="cpu",
                        prev_end={0: T.final_anchors(prior)[0]})
    assert plans_of(inc) == plans_of(direct)
    assert (inc.result.latency, inc.result.energy) == \
        (direct.result.latency, direct.result.energy)
    from repro.core.modelzoo import get_model as ref_model
    from repro.core.workload import Scenario as RefScenario
    rmcm = R.make_mcm(**SMALL)
    rcfg = R.SearchConfig(**SMALL_CFG)
    rprior = R.schedule(RefScenario("online[a]", (ref_model("bert-l", 3),)),
                        rmcm, rcfg)
    ref = R.schedule_incremental(
        RefScenario("online[ab]", (ref_model("bert-l", 3),
                                   ref_model("googlenet", 4))),
        rmcm, rcfg, prior=rprior, persisting={0: 0})
    assert plans_of(inc) == plans_of(ref)
    assert (inc.result.latency, inc.result.energy) == \
        (ref.result.latency, ref.result.energy)


def test_window_memo_is_bounded():
    mcm = T.make_mcm(**SMALL)
    rs = TO.Rescheduler(mcm, cfg=T.SearchConfig(**SMALL_CFG), mode="warm",
                        device="cpu", plan_memo_max=2)
    for tid, name in enumerate(("bert-l", "resnet-50", "googlenet")):
        rs._last = None
        rs.replan([(tid, name, 3)])
    assert len(rs._plan_memo) == 2
    rs._window_memo.update({("pad", i): None for i in range(20001)})
    rs._last = None
    rs.replan([(7, "u-net", 1)])
    assert len(rs._window_memo) < 100


def test_entry_points_raise_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace = T.get_trace("dc_churn_smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TO.simulate(trace, **SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TO.simulate_fleet(T.get_trace("dc_fleet_smoke"), 0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TO.Rescheduler(T.make_mcm(**SMALL))
    from repro_torch.launch import online_serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        online_serve.main(["--trace", "dc_churn_smoke"])
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TO.simulate(trace, device="cuda", **SMALL)


def test_online_serve_entry_point_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import online_serve
    out = tmp_path / "trace.json"
    res = online_serve.main(["--trace", "dc_churn_smoke", "--rows", "3",
                             "--cols", "3", "--n-pe", "1024", "--path-cap",
                             "32", "--seg-cap", "64", "--device", "cpu",
                             "--trace-out", str(out)])
    from repro_torch import obs
    obs.disable()
    text = capsys.readouterr().out
    assert "QoS (warm)" in text and "device=cpu" in text
    names = {ev["name"] for ev in json.loads(out.read_text())["traceEvents"]}
    assert {"epoch", "replan", "schedule"} <= names
    assert res["qos"].n_epochs == len(T.get_trace("dc_churn_smoke").events)


# ----------------------- accounting (as in the reference) ------------------

def test_churn_accounting_uses_exact_schedule_metrics():
    trace = TO.Trace.load(str(FIXTURES / "trace_dc_churn_smoke.json"))
    sim = TO.simulate(trace, mode="warm", cfg=T.SearchConfig(**SMALL_CFG),
                      device="cpu", **SMALL)
    for k, e in enumerate(sim.epochs):
        if e.outcome is None:
            assert e.energy == 0.0 and e.iterations == 0.0
            continue
        assert e.iterations == pytest.approx(
            (e.t_end - e.t_start) / e.outcome.result.latency)
        pml = per_model_latency(e.outcome)
        energy = e.iterations * e.outcome.result.energy
        frac = e.iterations - math.floor(e.iterations)
        if k + 1 < len(sim.epochs) and frac > 0:
            staying = {t[0] for t in sim.epochs[k + 1].tenants}
            total = sum(pml.values())
            energy -= sum(frac * e.outcome.result.energy * pml[mi] / total
                          for mi, tid in enumerate(e.tenant_order)
                          if tid not in staying)
        assert e.energy == pytest.approx(energy)
    rep = TO.qos_report(sim)
    assert rep.total_energy == pytest.approx(sum(e.energy
                                                 for e in sim.epochs))


def test_departing_tenant_inflight_iteration_matches_reference():
    def events(Ev):
        return (Ev(t=0.0, kind="arrive", model="bert-l", tenant=0, batch=3),
                Ev(t=0.0, kind="arrive", model="googlenet", tenant=1,
                   batch=4),
                Ev(t=0.05, kind="depart", model="bert-l", tenant=0, batch=3))
    ours = TO.simulate(TO.Trace(name="dep", kind="churn", horizon=0.08,
                                events=events(TO.Event)),
                       cfg=T.SearchConfig(**SMALL_CFG), device="cpu",
                       **SMALL)
    ref = RO.simulate(RO.Trace(name="dep", kind="churn", horizon=0.08,
                               events=events(RO.Event)),
                      cfg=R.SearchConfig(**SMALL_CFG), **SMALL)
    assert port_record(ours) == ref_record(ref)
    iters = ours.epochs[0].iterations
    assert iters - math.floor(iters) > 0
    dep_w = sum(w for _, w in ours.latency_samples.get("bert-l", []))
    assert dep_w == math.floor(iters)


def test_deadline_accounting_hand_computed_two_model_trace():
    evs = [TO.Event(t=k * 0.1, kind="frame", model=name, tenant=mi,
                    deadline=0.1)
           for k in range(3) for mi, name in ((0, "fast"), (1, "slow"))]
    trace = TO.Trace(name="hand", kind="cadence", horizon=0.3,
                     events=tuple(sorted(evs, key=TO.Event.sort_key)))
    frames = replay_cadence(trace, {0: 0.05, 1: 0.25}, {0: 1.0, 1: 2.0})
    slow = [f for f in frames if f.tenant == 1]
    assert [f.missed for f in frames if f.tenant == 0] == [False] * 3
    assert [f.missed for f in slow] == [True] * 3
    assert [f.latency for f in slow] == pytest.approx([0.25, 0.40, 0.55])


def test_weighted_percentile_and_report_match_reference():
    from repro.online.metrics import weighted_percentile as ref_wp
    for samples in ([(1.0, 1.0), (2.0, 1.0), (10.0, 2.0)], [(3.0, 1.0)],
                    [(0.5, 0.0), (0.2, 0.0)]):
        for p in (0.0, 50.0, 99.0, 100.0):
            assert weighted_percentile(samples, p) == ref_wp(samples, p)
    assert math.isnan(weighted_percentile([], 50.0))
    frames = [FrameRecord(t=0.0, model="m", tenant=0, latency=0.2,
                          deadline=0.1, missed=True, energy=1.5),
              FrameRecord(t=0.1, model="m", tenant=0, latency=0.05,
                          deadline=0.1, missed=False, energy=1.5)]
    sim = SimResult(trace=TO.Trace(name="t", kind="cadence", horizon=2.0,
                                   events=()),
                    mode="warm", epochs=[], frames=frames,
                    latency_samples={"m": [(0.2, 1.0), (0.05, 1.0)]},
                    total_energy=3.0, busy_s=2.0, replan_wall_s=0.5,
                    n_replans=1, n_memo_hits=0)
    rep = TO.qos_report(sim)
    assert rep.model("m").miss_rate == 0.5
    assert (rep.model("m").p50_latency, rep.model("m").p99_latency) == \
        (0.05, 0.2)
    assert rep.aggregate_edp == 6.0 and rep.overhead_ratio == 0.25
