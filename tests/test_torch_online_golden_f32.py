"""The reference's float32 record of the 6x6 online bench trace, fresh,
and the port's float32 runs against it.

``online_rescheduling_6x6/jax_ref`` in ``tests/fixtures/torch_online_
golden.json`` is the reference's run of ``dc_churn_6x6`` with every batch
scored in float32.  The port's counterparts (``torch_ref`` here, ``cuda``
on the card, and the fused ``beam_jax`` search) must give its plans epoch
for epoch, except on exact ties: epochs whose plan differs while the
float64 latency, energy and EDP are ``==`` (ROADMAP.md §3 lists them).
The float64 ``auto`` record is not the yardstick for these runs: the
reference's own float32 run departs from it on epochs 6 and 8 by an ulp
of energy.
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

KEY = "online_rescheduling_6x6/jax_ref"
# epochs of dc_churn_6x6 where the port breaks an exact tie the other way
TIES = {"torch_ref": [9, 48, 50], "beam_jax": [9, 48, 50, 56, 62, 64]}


def test_float32_golden_run_is_current():
    assert golden.reference_record(KEY) == COMMITTED[KEY]["record"]


@pytest.mark.parametrize("path", sorted(TIES))
def test_port_float32_run_departs_only_on_exact_ties(path):
    change = {"algo": "beam_jax"} if path == "beam_jax" else {}
    rec = golden.port_record(KEY, "cpu", **change)
    want = COMMITTED[KEY]["record"]
    diff, ties = golden.tie_departures(rec, want)
    assert diff == ties == TIES[path]
    assert [e["tenants"] for e in rec["epochs"]] == \
        [e["tenants"] for e in want["epochs"]]
