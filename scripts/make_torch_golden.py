"""Write the golden schedules the PyTorch port is held against.

Runs the JAX reference package (``repro``) on the CPU and records, for the
ten Table II scenarios on the paper's 6x6 ``het_cross`` package and for
``dc4_lms_seg_image`` on the 16x16 ``het_cb`` production pod at
``path_cap=1024``: every window's plan (per model: segment ends and
chiplets) and the float64 latency, energy and EDP as ``repr`` strings, so
a reader can compare them with ``==``.  ``chip_smoke.py`` reads the file to
hold the port's run on the GPU against the reference without importing it;
``tests/test_torch_golden.py`` regenerates it and asserts equality.

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

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "tests", "fixtures", "torch_port_golden.json")

# (key, scenario, pattern, rows, path_cap): the paper's package for every
# scenario, then the production pod for the largest datacenter mix.
CASES = ([(f"het_cross_6x6/{s}", s, "het_cross", 6, 128)
          for s in SCENARIO_NAMES]
         + [("het_cb_16x16_cap1024/dc4_lms_seg_image", "dc4_lms_seg_image",
             "het_cb", 16, 1024)])


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


def reference_record(key: str) -> dict:
    """The JAX package's record of one golden case."""
    _, scn, pattern, rows, path_cap = next(c for c in CASES if c[0] == key)
    out = schedule(get_scenario(scn),
                   make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe_of(scn)),
                   SearchConfig(path_cap=path_cap))
    return dict(scenario=scn, pattern=pattern, rows=rows, cols=rows,
                n_pe=n_pe_of(scn), path_cap=path_cap, **outcome_record(out))


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
