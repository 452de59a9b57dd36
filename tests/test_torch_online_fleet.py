"""The port's fleet serving against the JAX reference: the provision fleet
functions, open-loop serving, streaming statistics and the streamed fleet
driver's memory bound (CPU, small sizes).  Every comparison is ``==``.
"""
import dataclasses
import importlib
import math
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

# the modules (``core/__init__`` re-exports the function ``provision``)
RP = importlib.import_module("repro.core.provision")
TP = importlib.import_module("repro_torch.core.provision")

FLEET = dict(pattern="het_cb", rows=2, cols=2, n_pe=256, n_packages=4)
FLEET_CFG = dict(path_cap=4, seg_cap=8, n_splits=2)
# bench_fleet_serving's open-loop trace, cut to a short horizon
BENCH_TRACE = dict(seed=5, base_rate=8.0, mean_lifetime=0.7,
                   zoo=(("bert-base", 8), ("resnet-50", 8)),
                   request_rate=(0.25, 8.0))


def fleets(**change):
    kw = dict(FLEET, **change)
    return (RO.FleetConfig(cfg=R.SearchConfig(**FLEET_CFG), **kw),
            TO.FleetConfig(cfg=T.SearchConfig(**FLEET_CFG), **kw))


@pytest.mark.parametrize("pattern,rows,n_pe", [
    ("het_cross", 6, 4096), ("het_cb", 2, 256), ("het_sides", 3, 1024)])
def test_provision_fleet_functions_match_reference(pattern, rows, n_pe):
    r = R.make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe)
    t = T.make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe)
    for fn in ("package_power_w", "package_idle_power_w",
               "package_area_mm2"):
        assert getattr(TP, fn)(t) == getattr(RP, fn)(r)
    assert TP.chiplet_peak_power_w(n_pe, t.pkg) == \
        RP.chiplet_peak_power_w(n_pe, r.pkg)
    for pw, area in ((math.inf, math.inf), (500.0, math.inf),
                     (math.inf, 900.0), (1.0, 1.0)):
        assert TP.max_affordable_packages(t, TP.PackageBudget(pw, area)) == \
            RP.max_affordable_packages(r, RP.PackageBudget(pw, area))
    with pytest.raises(ValueError):
        TP.PackageBudget(power_w=0.0)


def test_pick_package_matches_reference():
    cases = [([0.5, 0.2, 0.2, 1.0], [True, True, True, True]),
             ([0.5, 0.2, 0.2, 1.0], [True, False, True, True]),
             ([1.0, 1.0], [False, False]), ([], [])]
    for loads, caps in cases:
        for policy in ("least_loaded", "round_robin"):
            for cursor in range(3):
                assert TP.pick_package(loads, caps, policy, cursor) == \
                    RP.pick_package(loads, caps, policy, cursor)
    with pytest.raises(KeyError):
        TP.pick_package([0.0], [True], "random", 0)


@pytest.mark.parametrize("change", [
    dict(routing="least_loaded"), dict(routing="round_robin"),
    dict(max_tenants_per_package=1),
    dict(n_packages=1, max_packages=3, autoscale=True),
])
def test_fleet_smoke_equals_reference(change):
    rf, tf = fleets(**change)
    ref = RO.simulate_fleet(R.get_trace("dc_fleet_smoke"), 0.0, fleet=rf)
    ours = TO.simulate_fleet(T.get_trace("dc_fleet_smoke"), 0.0, fleet=tf,
                             device="cpu")
    assert golden.fleet_record(ours) == golden.fleet_record(ref)
    assert ours.n_events == 39 and ours.admitted_tenants > 0


def test_streamed_fleet_equals_reference_and_is_bounded():
    """The bench's open-loop trace, streamed over a 60 s horizon: the same
    report as the reference, never more than one event group a package
    buffered, and the trace never materialised."""
    rf, tf = fleets(routing="least_loaded")
    ref = RO.simulate_fleet(RO.iter_open_loop_churn(horizon=60.0,
                                                    **BENCH_TRACE),
                            60.0, fleet=rf)
    ours = TO.simulate_fleet(TO.iter_open_loop_churn(horizon=60.0,
                                                     **BENCH_TRACE),
                             60.0, fleet=tf, device="cpu")
    assert golden.fleet_record(ours) == golden.fleet_record(ref)
    assert ours.n_events > 1000
    assert ours.max_buffered_events <= 16


def test_stream_and_trace_give_one_report():
    _, tf = fleets()
    tr = T.get_trace("dc_fleet_smoke")
    a = TO.simulate_fleet(tr, 0.0, fleet=tf, device="cpu")
    events, horizon = T.iter_trace_events("dc_fleet_smoke")
    b = TO.simulate_fleet(events, horizon, fleet=tf, device="cpu")
    assert golden.fleet_record(a) == dict(golden.fleet_record(b),
                                          name=a.name)


def test_fleet_refuses_what_the_reference_refuses():
    _, tf = fleets()
    with pytest.raises(ValueError):
        TO.simulate_fleet(T.get_trace("xr8_cadence"), 0.0, fleet=tf,
                          device="cpu")
    with pytest.raises(KeyError):
        TO.FleetConfig(routing="random")
    small = dataclasses.replace(tf, budget=TP.PackageBudget(power_w=1.0))
    with pytest.raises(ValueError):
        TO.simulate_fleet(T.get_trace("dc_fleet_smoke"), 0.0, fleet=small,
                          device="cpu")


def test_streaming_stats_match_reference():
    from repro.online.metrics import StreamingStats as RefStats
    ours, ref = TO.StreamingStats(), RefStats()
    vals = [(1e-7, 1.0, 0.0), (0.003, 2.0, 2.0), (0.05, 0.5, 0.0),
            (math.inf, 3.0, 3.0), (2e3, 1.0, 1.0), (0.1, 0.0, 0.0)]
    for v in vals:
        ours.add(*v)
        ref.add(*v)
    for p in (0.0, 10.0, 50.0, 99.0, 100.0):
        assert ours.percentile(p) == ref.percentile(p)
    assert (ours.miss_rate, ours.attainment, ours.w_total) == \
        (ref.miss_rate, ref.attainment, ref.w_total)
    empty = TO.StreamingStats()
    assert math.isnan(empty.percentile(50.0)) and math.isnan(empty.miss_rate)
    other = TO.StreamingStats()
    other.add(0.01, 1.0)
    ours.merge(other)
    assert ours.w_total == ref.w_total + 1.0
    with pytest.raises(ValueError):
        ours.merge(TO.StreamingStats(n_bins=8))


@pytest.mark.parametrize("boundary", ["instant", "drain", "preempt"])
def test_open_loop_and_idle_power_match_reference(boundary):
    """Rated tenants (served demand-limited, instant boundary only) and
    idle power on one package, against the reference."""
    kw = dict(seed=23, horizon=30.0, base_rate=0.8, mean_lifetime=4.0,
              max_active=2, request_rate=(0.5, 8.0),
              slo_mix={"latency_critical": 0.35, "best_effort": 0.35},
              zoo=(("gpt-l", 1), ("bert-l", 3), ("bert-base", 24),
                   ("resnet-50", 32)))
    geo = dict(pattern="het_cross", rows=3, cols=3, n_pe=1024)
    cfg = dict(path_cap=32, seg_cap=64, n_splits=2)
    tr = TO.open_loop_churn_trace(**kw)
    if boundary != "instant":
        with pytest.raises(ValueError):
            TO.simulate(tr, policy=TO.OnlinePolicy(boundary=boundary),
                        cfg=T.SearchConfig(**cfg), device="cpu", **geo)
        return
    ref = RO.simulate(RO.open_loop_churn_trace(**kw),
                      policy=RO.OnlinePolicy(idle_power_w=3.15),
                      cfg=R.SearchConfig(**cfg), **geo)
    ours = TO.simulate(tr, policy=TO.OnlinePolicy(idle_power_w=3.15),
                       cfg=T.SearchConfig(**cfg), device="cpu", **geo)
    assert golden.sim_record(ours, TO.qos_report, TO.slo_report) == \
        golden.sim_record(ref, RO.qos_report, RO.slo_report)
    assert (ours.requests_offered, ours.requests_served, ours.idle_energy) \
        == (ref.requests_offered, ref.requests_served, ref.idle_energy)
    assert ours.idle_energy > 0 and ours.requests_offered > 0
