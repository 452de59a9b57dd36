"""Write the golden schedules the PyTorch port is held against.

Runs the JAX reference package (``repro``) on the CPU and records, for each
case: every window's plan (per model: segment ends and chiplets) and the
float64 latency, energy and EDP as ``repr`` strings, so a reader can
compare them with ``==``, beside the case's configuration (scenario,
package, NoC preset and the ``SearchConfig`` fields it sets).  The cases:

* the ten Table II scenarios on the paper's 6x6 ``het_cross`` package, and
  ``dc4_lms_seg_image`` on the 16x16 ``het_cb`` production pod at
  ``path_cap=1024``, with the defaults (analytic comm model, ``brute``);
* the congestion comm model: the ten 6x6 scenarios with the ``het_rows``
  NoC preset and the 16x16 case with ``narrow``, ``algo="beam"``;
* the stochastic engines: ``evolutionary`` and ``anneal`` on 6x6
  ``dc4_lms_seg_image`` and ``xr10_vr_gaming``, ``anneal`` on the 16x16
  case;
* refinement: ``beam`` with ``refine_iters=300`` on those two 6x6
  scenarios, analytic and congestion (``het_rows``).

``chip_smoke.py`` reads the file to hold the port's run on the GPU against
the reference without importing it; ``tests/test_torch_golden.py``
regenerates it and asserts equality.

Usage: python scripts/make_torch_golden.py [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro.core import SCENARIO_NAMES, SearchConfig, get_scenario, make_mcm
from repro.core import schedule
from repro.core.scenarios import noc_config

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "tests", "fixtures", "torch_port_golden.json")

PROD = "dc4_lms_seg_image"
PAPER_6X6 = ("het_cross", 6, 128)
POD_16X16 = ("het_cb", 16, 1024)
CONGESTION = {"comm_model": "congestion", "algo": "beam"}
REFINE = {"algo": "beam", "refine_iters": 300}
STOCHASTIC_6X6 = ("dc4_lms_seg_image", "xr10_vr_gaming")


def _case(prefix, scenario, package, noc=None, **config):
    pattern, rows, path_cap = package
    return (f"{prefix}/{scenario}", scenario, pattern, rows, path_cap, noc,
            config)


# (key, scenario, pattern, rows, path_cap, NoC preset, SearchConfig fields)
CASES = (
    [_case("het_cross_6x6", s, PAPER_6X6) for s in SCENARIO_NAMES]
    + [_case("het_cb_16x16_cap1024", PROD, POD_16X16)]
    + [_case("het_cross_6x6_congestion_het_rows", s, PAPER_6X6, "het_rows",
             **CONGESTION) for s in SCENARIO_NAMES]
    + [_case("het_cb_16x16_cap1024_congestion_narrow", PROD, POD_16X16,
             "narrow", **CONGESTION)]
    + [_case(f"het_cross_6x6_{algo}", s, PAPER_6X6, algo=algo)
       for algo in ("evolutionary", "anneal") for s in STOCHASTIC_6X6]
    + [_case("het_cb_16x16_cap1024_anneal", PROD, POD_16X16, algo="anneal")]
    + [_case("het_cross_6x6_refine300", s, PAPER_6X6, **REFINE)
       for s in STOCHASTIC_6X6]
    + [_case("het_cross_6x6_refine300_congestion_het_rows", s, PAPER_6X6,
             "het_rows", **REFINE, comm_model="congestion")
       for s in STOCHASTIC_6X6])


def n_pe_of(scenario: str) -> int:
    """Chiplet size the repo's sweeps use: 4096 PEs datacenter, 256 AR/VR."""
    return 4096 if scenario.startswith("dc") else 256


def outcome_record(outcome) -> dict:
    """Plans and ``repr`` float64 metrics of a schedule outcome.

    Works on an outcome of either package: both expose the same fields.
    """
    return {
        "plans": [[[p.model_idx, list(p.seg_ends), list(p.chiplets)]
                   for p in wr.plan.plans] for wr in outcome.windows],
        "latency": repr(outcome.result.latency),
        "energy": repr(outcome.result.energy),
        "edp": repr(outcome.result.edp),
    }


def case_config(case: dict) -> dict:
    """The ``SearchConfig`` keyword arguments of a golden case record."""
    return dict(path_cap=case["path_cap"], **case["config"])


def reference_record(key: str) -> dict:
    """The JAX package's record of one golden case."""
    _, scn, pattern, rows, path_cap, noc, config = next(
        c for c in CASES if c[0] == key)
    out = schedule(get_scenario(scn),
                   make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe_of(scn),
                            noc=noc_config(noc) if noc else None),
                   SearchConfig(path_cap=path_cap, **config))
    return dict(scenario=scn, pattern=pattern, rows=rows, cols=rows,
                n_pe=n_pe_of(scn), path_cap=path_cap, noc=noc,
                config=config, **outcome_record(out))


def golden() -> dict:
    """The whole golden file's content."""
    return {"source": "repro (JAX reference) on the CPU, "
                      "scripts/make_torch_golden.py",
            "cases": {key: reference_record(key) for key, *_ in CASES}}


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
