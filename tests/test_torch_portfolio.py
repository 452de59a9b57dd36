"""The port's portfolio runner against the JAX reference (CPU).

* ``sweep_grid`` / ``trace_sweep_grid`` give the reference's job lists:
  names and every field (the port's jobs add ``device``);
* the paper's headline grid (ten Table II scenarios x the seven packages of
  ``benchmarks/common.py::CONFIG_SET``, 3x3, the paper's PE counts) run
  inline gives the reference's plans and float64 latency, energy and EDP,
  and ``bench_headline``'s two EDP reductions, all ``==``: through the
  committed record of ``scripts/make_torch_portfolio_golden.py``, which is
  regenerated from the reference here, so it cannot go stale; so does the
  large-mesh grid (8x8 and 16x16) against its committed record;
* a ``spawn`` pool of two workers on the CPU gives the inline results for
  sweep jobs and for the trace jobs of the reference's
  ``tests/test_online.py::test_trace_portfolio_inline_and_parallel_parity``,
  and its merged telemetry has one process track per batch;
* a job whose ``device`` is ``None`` asks for the card and raises without
  one.
"""
import dataclasses
import json
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_portfolio_golden as golden  # noqa: E402

import repro.core.portfolio as RP  # noqa: E402
import repro.online as RO  # noqa: E402
import repro_torch.core.portfolio as TP  # noqa: E402
import repro_torch.core.scenarios as TS  # noqa: E402
import repro_torch.online as TO  # noqa: E402
from repro_torch import obs  # noqa: E402

with open(golden.GOLDEN) as fh:
    COMMITTED = json.load(fh)


def fields(job) -> dict:
    d = dataclasses.asdict(job)
    d.pop("device", None)
    return d


# ------------------------------- grids --------------------------------------

def test_sweep_grid_matches_reference():
    kw = dict(metrics=["edp", "latency"], standalone_patterns=["simba_nvdla"],
              meshes=["8x8", (2, 3)], path_cap=64, seg_cap=32)
    ref = RP.sweep_grid(["dc1_lms", "xr8_outdoors"], ["het_sides", "het_cb"],
                        **kw)
    ours = TP.sweep_grid(["dc1_lms", "xr8_outdoors"], ["het_sides", "het_cb"],
                         **kw)
    assert [j.name for j in ours] == [j.name for j in ref]
    assert [fields(j) for j in ours] == [fields(j) for j in ref]
    assert all(j.device is None for j in ours)
    assert {j.device for j in TP.sweep_grid(["dc1_lms"], ["het_cb"],
                                            device="cpu")} == {"cpu"}


def test_large_mesh_grid_matches_reference():
    ref, ours = golden.large_jobs(RP), golden.large_jobs(TP)
    assert sorted(ours) == sorted(ref) == sorted(COMMITTED["large_mesh"])
    for algo in ref:
        assert [fields(j) for j in ours[algo]] == \
            [fields(j) for j in ref[algo]]
        assert [j.name for j in ours[algo]] == \
            sorted(COMMITTED["large_mesh"][algo], key=[
                j.name for j in ref[algo]].index)


def test_trace_sweep_grid_matches_reference():
    kw = dict(rows=3, cols=3, n_pe=1024, modes=("warm", "cold"),
              meshes=[(3, 3), "8x8"], path_cap=32, seg_cap=64)
    ref = RP.trace_sweep_grid(
        ["dc_churn_smoke", "xr8_cadence"], ["het_cross"],
        policies=(None, RO.OnlinePolicy(boundary="drain")), **kw)
    ours = TP.trace_sweep_grid(
        ["dc_churn_smoke", "xr8_cadence"], ["het_cross"],
        policies=(None, TO.OnlinePolicy(boundary="drain")), **kw)
    assert [j.name for j in ours] == [j.name for j in ref]
    assert [fields(j) for j in ours] == [fields(j) for j in ref]


# ------------------------------ headline ------------------------------------

def test_committed_headline_is_current():
    assert golden.reference_headline() == COMMITTED["headline"]


def test_headline_grid_inline_equals_reference():
    """Seventy sweep points, plans and float64 metrics ``==``, and the two
    reductions per suite ``==``."""
    ours = golden.headline_record(TP, TS, device="cpu")
    ref = COMMITTED["headline"]
    assert sorted(ours["points"]) == sorted(ref["points"])
    for name, rec in ref["points"].items():
        assert ours["points"][name] == rec, name
    assert ours["reductions"] == ref["reductions"]
    # the paper's direction: heterogeneous packages lower the EDP
    for suite in ("datacenter", "arvr"):
        assert float(ours["reductions"][suite]["vs_mean_homog"]) > 0


def test_large_mesh_grid_inline_equals_reference():
    """``scripts/large_mesh_smoke.py``'s grid (8x8 and 16x16, ``path_cap``
    512) under the default search and ``beam_jax``, on the CPU: the
    committed reference records, ``==``."""
    for algo, jobs in golden.large_jobs(TP, device="cpu").items():
        ours = golden.results_record(TP.run_portfolio(jobs, processes=1))
        assert ours == COMMITTED["large_mesh"][algo], algo


def test_chip_smoke_imports_of_the_golden_script_are_port_only():
    """What ``chip_smoke.py`` takes from the golden script and the port's
    portfolio and orchestrator imports neither ``jax`` nor ``repro``."""
    import os
    import subprocess
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
            "import make_torch_portfolio_golden as g\n"
            "import repro_torch.core.portfolio as TP\n"
            "import repro_torch.multimodel\n"
            "import repro_torch.launch.multimodel_serve\n"
            "jobs = g.headline_jobs(TP, ['xr8_outdoors'], device='cpu')\n"
            "recs = g.results_record(TP.run_portfolio(jobs[-2:], 1))\n"
            "assert len(recs) == 2\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


# ------------------------------ spawn pool ----------------------------------

def _sweep_jobs():
    return TP.sweep_grid(["xr10_vr_gaming", "xr8_outdoors"], ["het_cb"],
                         standalone_patterns=["simba_nvdla"], device="cpu")


def _trace_jobs():
    """The reference's trace-portfolio parity test's jobs."""
    jobs = TP.trace_sweep_grid(["dc_churn_smoke"], ["het_cross"],
                               rows=3, cols=3, n_pe=1024, modes=("warm",),
                               path_cap=32, seg_cap=64, n_splits=2,
                               device="cpu")
    jobs.append(TP.TraceJob(trace="xr8_cadence", pattern="het_sides",
                            rows=3, cols=3, n_pe=256,
                            cfg=TP.SearchConfig(path_cap=32, seg_cap=64),
                            device="cpu"))
    return jobs


@pytest.fixture(scope="module")
def pooled():
    """One traced spawn pool of two workers over sweep and trace jobs, and
    the same jobs inline."""
    jobs = _sweep_jobs() + _trace_jobs()
    inline = TP.run_portfolio(jobs, processes=1)
    was = obs.enabled()
    obs.enable()
    obs.reset()
    try:
        par = TP.run_portfolio(jobs, processes=2)
        events = list(obs.tracer().events)
    finally:
        if not was:
            obs.disable()
    return jobs, inline, par, events


def test_spawn_pool_sweep_jobs_equal_inline(pooled):
    jobs, inline, par, _ = pooled
    n = len(_sweep_jobs())
    for a, b in zip(inline[:n], par[:n]):
        assert a.job == b.job
        assert golden.outcome_record(a.outcome) == \
            golden.outcome_record(b.outcome)
        assert a.launches == b.launches == {"scar_eval": 0,
                                            "scar_search": 0}


def test_spawn_pool_trace_jobs_equal_inline(pooled):
    jobs, inline, par, _ = pooled
    n = len(_sweep_jobs())
    assert [r.job for r in par] == jobs
    for a, b in zip(inline[n:], par[n:]):
        assert a.job == b.job
        assert a.report.aggregate_edp == b.report.aggregate_edp
        assert a.report.per_model == b.report.per_model


def test_spawn_pool_merges_one_process_track_per_batch(pooled):
    jobs, _, _, events = pooled
    groups = {}
    for j in jobs:
        groups.setdefault(TP._db_affinity(j), []).append(j)
    cap = math.ceil(len(jobs) / 2)
    n_batches = sum(math.ceil(len(g) / cap) for g in groups.values())
    job_evs = [e for e in events if e["name"] == "job"]
    assert {e["pid"] for e in job_evs} == set(range(1, n_batches + 1))
    assert sorted(e["args"]["job"] for e in job_evs) == \
        sorted(j.name for j in jobs)
    sids = {e["sid"] for e in events}
    assert all(e["parent"] in sids for e in events if e["name"] == "schedule")


def test_default_processes_reads_the_environment(monkeypatch):
    monkeypatch.setenv("SCAR_PORTFOLIO_PROCS", "3")
    assert TP.default_processes() == 3 == RP.default_processes()
    monkeypatch.setenv("SCAR_PORTFOLIO_PROCS", "0")
    assert TP.default_processes() == 1


def test_job_without_a_device_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    job = TP.SweepJob(scenario="xr8_outdoors", pattern="het_cb", n_pe=256)
    assert job.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.run_portfolio([job], processes=1)
