"""The committed golden schedules: fresh from the reference, met by the port.

``tests/fixtures/torch_port_golden.json`` (written by
``scripts/make_torch_golden.py``) is what ``chip_smoke.py`` holds the
port's GPU run against without importing the JAX package.  Each case is
regenerated here from the reference, so the file cannot go stale, and the
port's CPU run must reproduce every case exactly under the case's own
configuration (analytic and congestion comm models, the stochastic
engines, refinement): same plans, and float64 latency, energy and EDP
whose ``repr`` strings compare ``==``.
"""
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_golden as golden  # noqa: E402

import repro_torch.core as T  # noqa: E402

with open(golden.GOLDEN) as fh:
    COMMITTED = json.load(fh)


def test_committed_cases_are_the_script_cases():
    assert sorted(COMMITTED["cases"]) == sorted(k for k, *_ in golden.CASES)


@pytest.mark.parametrize("key", [k for k, *_ in golden.CASES])
def test_golden_case_is_current(key):
    assert golden.reference_record(key) == COMMITTED["cases"][key]


@pytest.mark.parametrize("key", [k for k, *_ in golden.CASES])
def test_port_cpu_run_meets_golden(key):
    from repro_torch.core.scenarios import noc_config
    case = COMMITTED["cases"][key]
    out = T.schedule(T.get_scenario(case["scenario"]),
                     T.make_mcm(case["pattern"], rows=case["rows"],
                                cols=case["cols"], n_pe=case["n_pe"],
                                noc=noc_config(case["noc"]) if case["noc"]
                                else None),
                     T.SearchConfig(**golden.case_config(case)),
                     device="cpu")
    assert golden.outcome_record(out) == {
        k: case[k] for k in ("plans", "latency", "energy", "edp")}
