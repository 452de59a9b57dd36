"""Write the golden online-serving records the PyTorch port is held against.

Runs the JAX reference package's online layer (``repro.online.simulate`` /
``simulate_fleet``) on the CPU and records, for each run: every epoch's
start and end, tenants, every window's plan (per model: segment ends and
chiplets), the plan's float64 latency, energy and EDP, the iterations and
energy served, ``memo_hit``, ``switched``, ``pattern`` and ``n_preempted``;
every frame of a cadence run; and the ``qos_report`` / ``slo_report``
scalars (or the ``FleetReport`` scalars of a fleet run).  Floats are
``repr`` strings, so a reader compares them with ``==``.  Host wall times
(``replan_wall_s``, ``overhead_ratio``) are left out: they are not results.

The runs, at the JAX package's own bench and demo configurations (every
one simulated time, deterministic, warm):

* ``online_rescheduling_6x6/auto``: ``dc_churn_6x6`` on 6x6 ``het_cross``,
  4096 PE, ``path_cap=64``, ``seg_cap=128`` (``bench_online_rescheduling``);
  ``.../jax_ref`` the same with every batch scored in float32, the
  reference's counterpart of the port's ``cuda`` and ``beam_jax`` runs;
* ``online_slo_8x8/drain/auto`` and ``.../preempt_reconfig/auto``:
  ``dc_churn_8x8_slo`` on 8x8 ``het_cross``, ``drain``, and ``preempt``
  with reconfiguration over ``het_sides`` and ``het_cb`` at hysteresis 0.25
  (``bench_online_slo``);
* ``online_cadence/auto``: ``xr8_cadence`` on 3x3 ``het_sides``, 256 PE
  (``bench_online_cadence``);
* ``fleet/least_loaded`` and ``fleet/round_robin``: ``dc_fleet_smoke``
  through ``bench_fleet_serving``'s ``FleetConfig`` (2x2 ``het_cb``, 256 PE,
  4 packages, ``path_cap=4``, ``seg_cap=8``, ``n_splits=2``);
* ``smoke/dc_churn_smoke/jax_ref`` and
  ``smoke/dc_churn_slo_smoke/preempt_reconfig/jax_ref``: the 3x3 smoke
  traces (``het_cross``, 1024 PE, ``path_cap=32``, ``seg_cap=64``,
  ``n_splits=2``) in float32.

``chip_smoke.py`` reads the file to hold the port's runs on the card
against the reference without importing it; ``tests/test_torch_online_
golden.py`` and ``tests/test_torch_online_golden_f32.py`` regenerate it
and assert equality.

Usage: python scripts/make_torch_online_golden.py [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "tests", "fixtures", "torch_online_golden.json")

_6X6 = dict(pattern="het_cross", rows=6, cols=6, n_pe=4096)
_8X8 = dict(pattern="het_cross", rows=8, cols=8, n_pe=4096)
_3X3 = dict(pattern="het_cross", rows=3, cols=3, n_pe=1024)
_BENCH_CFG = dict(path_cap=64, seg_cap=128)
_SMALL_CFG = dict(path_cap=32, seg_cap=64, n_splits=2)
_PREEMPT = dict(boundary="preempt", reconfig_patterns=["het_sides", "het_cb"],
                reconfig_hysteresis=0.25)
_FLEET = dict(pattern="het_cb", rows=2, cols=2, n_pe=256, n_packages=4,
              autoscale=False)
_FLEET_CFG = dict(path_cap=4, seg_cap=8, n_splits=2)

# key -> run spec: what to simulate and how (the reference and the port
# read the same spec)
RUNS: dict[str, dict] = {
    "online_rescheduling_6x6/auto": dict(
        kind="sim", trace="dc_churn_6x6", mcm=_6X6, config=_BENCH_CFG),
    "online_rescheduling_6x6/jax_ref": dict(
        kind="sim", trace="dc_churn_6x6", mcm=_6X6,
        config=dict(_BENCH_CFG, eval_backend="jax_ref")),
    "online_slo_8x8/drain/auto": dict(
        kind="sim", trace="dc_churn_8x8_slo", mcm=_8X8, config=_BENCH_CFG,
        policy=dict(boundary="drain")),
    "online_slo_8x8/preempt_reconfig/auto": dict(
        kind="sim", trace="dc_churn_8x8_slo", mcm=_8X8, config=_BENCH_CFG,
        policy=_PREEMPT),
    "online_cadence/auto": dict(
        kind="sim", trace="xr8_cadence",
        mcm=dict(pattern="het_sides", rows=3, cols=3, n_pe=256), config={}),
    "fleet/least_loaded": dict(
        kind="fleet", trace="dc_fleet_smoke",
        fleet=dict(_FLEET, routing="least_loaded"), config=_FLEET_CFG),
    "fleet/round_robin": dict(
        kind="fleet", trace="dc_fleet_smoke",
        fleet=dict(_FLEET, routing="round_robin"), config=_FLEET_CFG),
    "smoke/dc_churn_smoke/jax_ref": dict(
        kind="sim", trace="dc_churn_smoke", mcm=_3X3,
        config=dict(_SMALL_CFG, eval_backend="jax_ref")),
    "smoke/dc_churn_slo_smoke/preempt_reconfig/jax_ref": dict(
        kind="sim", trace="dc_churn_slo_smoke", mcm=_3X3,
        config=dict(_SMALL_CFG, eval_backend="jax_ref"), policy=_PREEMPT),
}

# the reference's float32 backend and the port's names for the same float32
# scoring (the plain version on the CPU, the kernel on the card)
F32_BACKEND = {"cpu": "torch_ref", "cuda": "cuda"}


def _r(x: float) -> str:
    return repr(float(x))


def _plans(outcome) -> list:
    return [[[p.model_idx, list(p.seg_ends), list(p.chiplets)]
             for p in wr.plan.plans] for wr in outcome.windows]


def epoch_record(e) -> dict:
    """One ``EpochRecord`` (reference or port) as JSON-safe values."""
    res = None if e.outcome is None else e.outcome.result
    return {
        "t_start": _r(e.t_start), "t_end": _r(e.t_end),
        "tenants": [list(t) for t in e.tenants],
        "plans": None if e.outcome is None else _plans(e.outcome),
        "latency": None if res is None else _r(res.latency),
        "energy_plan": None if res is None else _r(res.energy),
        "edp": None if res is None else _r(res.edp),
        "iterations": _r(e.iterations), "energy": _r(e.energy),
        "memo_hit": bool(e.memo_hit), "switched": bool(e.switched),
        "pattern": e.pattern, "n_preempted": int(e.n_preempted),
        "serve_start": _r(e.serve_start), "serve_end": _r(e.serve_end),
    }


def _qos(m) -> dict:
    return {"model": m.model, "n_samples": _r(m.n_samples),
            "p50": _r(m.p50_latency), "p99": _r(m.p99_latency),
            "miss_rate": None if m.miss_rate is None else _r(m.miss_rate)}


def _cls(c) -> dict:
    return {"slo": c.slo, "weight": _r(c.weight),
            "n_samples": _r(c.n_samples), "p50": _r(c.p50_latency),
            "p99": _r(c.p99_latency), "miss_rate": _r(c.miss_rate),
            "attainment": _r(c.attainment)}


def sim_record(sim, qos_report, slo_report) -> dict:
    """A ``SimResult`` with its QoS and SLO reports (wall times left out)."""
    q = qos_report(sim)
    s = slo_report(sim)
    return {
        "epochs": [epoch_record(e) for e in sim.epochs],
        "frames": [[_r(f.t), f.model, f.tenant, _r(f.latency), bool(f.missed),
                    _r(f.energy)] for f in sim.frames],
        "qos": {"per_model": [_qos(m) for m in q.per_model],
                "total_energy": _r(q.total_energy), "busy_s": _r(q.busy_s),
                "aggregate_edp": _r(q.aggregate_edp),
                "n_epochs": q.n_epochs, "n_replans": q.n_replans,
                "n_memo_hits": q.n_memo_hits},
        "slo": {"per_class": [_cls(c) for c in s.per_class],
                "weighted_p50": _r(s.weighted_p50),
                "weighted_p99": _r(s.weighted_p99),
                "weighted_miss_rate": _r(s.weighted_miss_rate),
                "slo_attainment": _r(s.slo_attainment),
                "score": _r(s.score), "served_weight": _r(s.served_weight),
                "edp_per_iteration": _r(s.edp_per_iteration),
                "n_preemptions": s.n_preemptions,
                "n_switches": s.n_switches},
    }


def fleet_record(rep) -> dict:
    """A ``FleetReport``'s scalars (its planner wall time left out)."""
    out = {}
    for f in dataclasses.fields(rep):
        v = getattr(rep, f.name)
        if f.name == "replan_wall_s":
            continue
        if f.name == "per_class":
            v = [_cls(c) for c in v]
        elif f.name == "per_package":
            v = [{k: (_r(x) if isinstance(x, float) else x)
                  for k, x in dataclasses.asdict(p).items()} for p in v]
        elif isinstance(v, float):
            v = _r(v)
        out[f.name] = v
    return out


def without_memo(rec: dict) -> dict:
    """A run record with the warm-only fields dropped (a cold run's view)."""
    out = dict(rec, epochs=[{k: v for k, v in e.items() if k != "memo_hit"}
                            for e in rec["epochs"]])
    out["qos"] = {k: v for k, v in rec["qos"].items() if k != "n_memo_hits"}
    return out


def tie_departures(rec: dict, golden: dict) -> tuple[list, list]:
    """Epochs whose plans differ from ``golden``'s: (all, the exact ties).

    An exact tie is an epoch whose plan differs but whose float64 latency,
    energy and EDP are ``==`` the golden ones.
    """
    diff, ties = [], []
    for k, (a, b) in enumerate(zip(rec["epochs"], golden["epochs"])):
        if a["plans"] != b["plans"]:
            diff.append(k)
            if all(a[f] == b[f] for f in ("latency", "energy_plan", "edp")):
                ties.append(k)
    return diff, ties


def reference_record(key: str) -> dict:
    """Run the JAX reference for ``RUNS[key]`` and record it."""
    spec = RUNS[key]
    from repro.core import SearchConfig, get_trace
    from repro.online import (FleetConfig, OnlinePolicy, qos_report,
                              simulate, simulate_fleet, slo_report)
    cfg = SearchConfig(**spec["config"])
    if spec["kind"] == "fleet":
        fleet = FleetConfig(cfg=cfg, **spec["fleet"])
        return fleet_record(simulate_fleet(get_trace(spec["trace"]),
                                           horizon=0.0, fleet=fleet))
    pol = dict(spec.get("policy", {}))
    pol["reconfig_patterns"] = tuple(pol.get("reconfig_patterns", ()))
    sim = simulate(get_trace(spec["trace"]), cfg=cfg, mode="warm",
                   policy=OnlinePolicy(**pol), **spec["mcm"])
    return sim_record(sim, qos_report, slo_report)


def port_run(key: str, device, mode: str = "warm", **change):
    """Run the port on ``RUNS[key]`` with ``SearchConfig`` fields changed.

    Returns the ``SimResult`` (or ``FleetReport``).  A ``jax_ref`` config
    runs the port's float32 backend for ``device``.
    """
    import torch

    from repro_torch.core import SearchConfig, get_trace
    from repro_torch.online import (FleetConfig, OnlinePolicy, simulate,
                                    simulate_fleet)
    spec = RUNS[key]
    fields = dict(spec["config"])
    if fields.get("eval_backend") == "jax_ref":
        fields["eval_backend"] = F32_BACKEND[torch.device(device).type]
    fields.update(change)
    cfg = SearchConfig(**fields)
    if spec["kind"] == "fleet":
        fleet = FleetConfig(cfg=cfg, mode=mode, **spec["fleet"])
        return simulate_fleet(get_trace(spec["trace"]), horizon=0.0,
                              fleet=fleet, device=device)
    pol = dict(spec.get("policy", {}))
    pol["reconfig_patterns"] = tuple(pol.get("reconfig_patterns", ()))
    return simulate(get_trace(spec["trace"]), cfg=cfg, mode=mode,
                    policy=OnlinePolicy(**pol), device=device,
                    **spec["mcm"])


def port_record(key: str, device, mode: str = "warm", **change) -> dict:
    """``port_run`` recorded as ``reference_record`` records."""
    from repro_torch.online import qos_report, slo_report
    out = port_run(key, device, mode=mode, **change)
    if RUNS[key]["kind"] == "fleet":
        return fleet_record(out)
    return sim_record(out, qos_report, slo_report)


def golden() -> dict:
    return {"note": "written by scripts/make_torch_online_golden.py from the "
            "JAX reference on the CPU",
            "runs": {key: dict(spec=RUNS[key], record=reference_record(key))
                     for key in RUNS}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=GOLDEN)
    args = ap.parse_args()
    data = golden()
    with open(args.out, "w") as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {len(data['runs'])} runs to {args.out}")


if __name__ == "__main__":
    main()
