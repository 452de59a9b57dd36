"""The committed online golden records: fresh from the reference, met by
the port.

``tests/fixtures/torch_online_golden.json`` (written by
``scripts/make_torch_online_golden.py``) is what ``chip_smoke.py`` phase 9
holds the port's runs on the card against without importing the JAX
package.  Each float64 (``auto``) record is regenerated here from the
reference, so the file cannot go stale, and the port's CPU run must
reproduce it exactly: every epoch (tenants, plans, float64 metrics,
iterations, energy, memo hits, patterns, preemptions), every frame, and
the QoS, SLO and fleet report scalars, ``repr`` for ``repr``.  The float32
records are checked in ``tests/test_torch_online_golden_f32.py`` and in
the smoke test files.
"""
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_online_golden as golden  # noqa: E402

with open(golden.GOLDEN) as fh:
    COMMITTED = json.load(fh)["runs"]

AUTO = sorted(k for k, spec in golden.RUNS.items()
              if "eval_backend" not in spec["config"])


def test_committed_runs_are_the_script_runs():
    assert sorted(COMMITTED) == sorted(golden.RUNS)
    for key, spec in golden.RUNS.items():
        assert COMMITTED[key]["spec"] == json.loads(json.dumps(spec))


@pytest.mark.parametrize("key", AUTO)
def test_golden_run_is_current(key):
    assert golden.reference_record(key) == COMMITTED[key]["record"]


@pytest.mark.parametrize("key", AUTO)
def test_port_cpu_run_meets_golden(key):
    assert golden.port_record(key, "cpu") == COMMITTED[key]["record"]


def test_cold_run_meets_golden_6x6():
    """The cold oracle (every cache cleared before each re-plan) gives the
    warm record's plans and accounting on the 6x6 bench trace."""
    key = "online_rescheduling_6x6/auto"
    assert golden.without_memo(golden.port_record(key, "cpu", mode="cold")) \
        == golden.without_memo(COMMITTED[key]["record"])
