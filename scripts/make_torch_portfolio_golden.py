"""Write the golden sweep and pod-plan records the PyTorch port is held
against.

Runs the JAX reference package (``repro``) on the CPU and records:

* ``headline``: the paper's headline grid, every Table II scenario under
  every package of ``benchmarks/common.py::CONFIG_SET`` (the two
  standalone baselines, the two homogeneous and the three heterogeneous
  packages) on 3x3 at the paper's PE counts (4096 datacenter, 256 AR/VR),
  ``metric="edp"``: each point's plans and float64 latency, energy and EDP,
  and ``bench_headline``'s two EDP reductions per suite (heterogeneous best
  against the best and against the mean of the two homogeneous packages);
* ``large_mesh``: ``scripts/large_mesh_smoke.py``'s grid, ``dc4`` and
  ``xr7`` on ``het_cb`` and ``het_sides`` at 8x8 and 16x16 with
  ``path_cap=512``, ``seg_cap=128``, under the default search and under
  ``algo="beam_jax"``;
* ``pod``: ``repro.multimodel.plan`` of the orchestrator test's three
  requests (minitron-8b batch 8, qwen2-moe-a2.7b batch 16, xlstm-350m
  batch 32, sequence 2048) on the 16x16 ``het_sides`` pod: placements
  (window, chips, template) and the float64 metrics.

Floats are ``repr`` strings, so a reader compares them with ``==``.
``chip_smoke.py`` reads the file to hold the port's runs on the card
against the reference without importing it;
``tests/test_torch_portfolio.py`` and ``tests/test_torch_multimodel.py``
regenerate the headline and pod parts and assert equality (the large-mesh
part takes about 45 s of the reference on the CPU, so only the port's
card run reads it).  The functions that build records work on either
package's objects and import the reference only when asked for its runs.

Usage: python scripts/make_torch_portfolio_golden.py [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "tests", "fixtures", "torch_portfolio_golden.json")

# benchmarks/common.py::CONFIG_SET: (label, pattern, standalone)
CONFIG_SET = (
    ("standalone_nvdla", "simba_nvdla", True),
    ("standalone_shi", "simba_shi", True),
    ("simba_nvdla", "simba_nvdla", False),
    ("simba_shi", "simba_shi", False),
    ("het_cb", "het_cb", False),
    ("het_sides", "het_sides", False),
    ("het_cross", "het_cross", False),
)
HET = ("het_cb", "het_sides", "het_cross")
HOMOG = ("simba_nvdla", "simba_shi")

LARGE_SCENARIOS = ("dc4_lms_seg_image", "xr7_ar_gaming")
LARGE_PATTERNS = ("het_cb", "het_sides")
LARGE_MESHES = ("8x8", "16x16")
LARGE_CFG = {"path_cap": 512, "seg_cap": 128}
LARGE_ALGOS = {"auto": {}, "beam_jax": {"algo": "beam_jax"}}

# tests/test_multimodel.py::test_plan_places_all_models_disjointly
POD_REQUESTS = (("minitron-8b", 8, 2048), ("qwen2-moe-a2.7b", 16, 2048),
                ("xlstm-350m", 32, 2048))
POD = {"rows": 16, "cols": 16, "pattern": "het_sides", "metric": "edp"}


def npe_for(scenario: str) -> int:
    return 4096 if scenario.startswith("dc") else 256


def _reference_path() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def headline_jobs(portfolio, scenario_names, **job_kw) -> list:
    """The headline grid as ``SweepJob``s of ``portfolio`` (either
    package's ``core.portfolio``), labelled ``scenario/config``."""
    SearchConfig = portfolio.SearchConfig
    return [portfolio.SweepJob(scenario=scn, pattern=pattern,
                               n_pe=npe_for(scn), standalone=standalone,
                               cfg=SearchConfig(metric="edp"),
                               label=f"{scn}/{name}", **job_kw)
            for scn in scenario_names for name, pattern, standalone
            in CONFIG_SET]


def large_jobs(portfolio, **job_kw) -> dict:
    """``{algo: jobs}`` of the large-mesh grid."""
    return {algo: portfolio.sweep_grid(list(LARGE_SCENARIOS),
                                       list(LARGE_PATTERNS),
                                       meshes=list(LARGE_MESHES),
                                       **LARGE_CFG, **extra, **job_kw)
            for algo, extra in LARGE_ALGOS.items()}


def outcome_record(outcome) -> dict:
    """Plans and ``repr`` float64 metrics of a schedule outcome (either
    package)."""
    return {
        "plans": [[[p.model_idx, list(p.seg_ends), list(p.chiplets)]
                   for p in wr.plan.plans] for wr in outcome.windows],
        "latency": repr(outcome.result.latency),
        "energy": repr(outcome.result.energy),
        "edp": repr(outcome.result.edp),
    }


def results_record(results) -> dict:
    """``{job name: outcome record}`` of a portfolio run."""
    return {r.job.name: outcome_record(r.outcome) for r in results}


def reductions(records: dict, datacenter, arvr) -> dict:
    """``bench_headline``'s mean EDP reductions per suite, from the
    headline records: heterogeneous best against the best and against the
    mean of the two homogeneous packages."""
    import numpy as np
    out = {}
    for suite, names in (("datacenter", datacenter), ("arvr", arvr)):
        best, mean = [], []
        for scn in names:
            edp = {k: float(records[f"{scn}/{k}"]["edp"])
                   for k in HET + HOMOG}
            het = min(edp[k] for k in HET)
            best.append(1 - het / min(edp[k] for k in HOMOG))
            mean.append(1 - het / (0.5 * (edp[HOMOG[0]] + edp[HOMOG[1]])))
        out[suite] = {"vs_best_homog": repr(float(np.mean(best))),
                      "vs_mean_homog": repr(float(np.mean(mean)))}
    return out


def headline_record(portfolio, scenarios_mod, processes: int = 1,
                    **job_kw) -> dict:
    """The headline record of either package (``job_kw``: the port's
    ``device``)."""
    jobs = headline_jobs(portfolio, scenarios_mod.SCENARIO_NAMES, **job_kw)
    recs = results_record(portfolio.run_portfolio(jobs, processes=processes))
    return {"points": recs,
            "reductions": reductions(recs, scenarios_mod.DATACENTER,
                                     scenarios_mod.ARVR)}


def pod_record(pod) -> dict:
    """Placements and ``repr`` metrics of a ``PodPlan`` (either package)."""
    return {
        "placements": [[p.arch, p.window, list(p.chips), p.template]
                       for p in pod.placements],
        "latency": repr(pod.outcome.result.latency),
        "energy": repr(pod.outcome.result.energy),
        "edp": repr(pod.outcome.result.edp),
    }


def reference_headline() -> dict:
    _reference_path()
    from repro.core import portfolio, scenarios
    return headline_record(portfolio, scenarios)


def reference_large() -> dict:
    _reference_path()
    from repro.core import portfolio
    return {algo: results_record(portfolio.run_portfolio(jobs, processes=1))
            for algo, jobs in large_jobs(portfolio).items()}


def reference_pod() -> dict:
    _reference_path()
    from repro.core.scheduler import SearchConfig
    from repro.multimodel import ServeRequest, plan
    reqs = [ServeRequest(*r) for r in POD_REQUESTS]
    pod = plan(reqs, rows=POD["rows"], cols=POD["cols"],
               pattern=POD["pattern"],
               cfg=SearchConfig(metric=POD["metric"]))
    return pod_record(pod)


def golden() -> dict:
    """The whole golden file's content."""
    return {"source": "repro (JAX reference) on the CPU, "
                      "scripts/make_torch_portfolio_golden.py",
            "headline": reference_headline(),
            "large_mesh": reference_large(),
            "pod": {"requests": [list(r) for r in POD_REQUESTS], **POD,
                    **reference_pod()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=GOLDEN)
    args = ap.parse_args()
    with open(args.out, "w") as fh:
        json.dump(golden(), fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
