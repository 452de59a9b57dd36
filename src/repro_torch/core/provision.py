"""Provisioner engine (PROV): per-window chiplet-node allocation (Sec. IV-B).

Eq. (2): nodes are distributed proportionally to each model's expected share
of the optimisation metric in the window, with (a) a >=1-node-per-model repair
loop and (b) Heuristic 2's node cap (no model gets more nodes than layers, or
than the user-specified cap).

Fleet extension (``online.fleet``): the same proportional-share reasoning
one level up — packages instead of chiplet nodes.  ``PackageBudget`` bounds
a fleet by total power/area, ``package_power_w`` / ``package_area_mm2`` /
``package_idle_power_w`` estimate one MCM package's envelope from the
Table I technology constants (an MPSoC-style budget split: per-chiplet MAC
dynamic + SRAM dynamic + static leakage), and ``max_affordable_packages`` /
``pick_package`` are the pure autoscaling/routing decisions the fleet
driver applies.  The per-chiplet constants are documented extra-paper
values chosen to land a 36-chiplet package in the tens-of-watts range.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .chiplet import MCM
from .maestro import CostDB, expected_energy, expected_latency


def expected_metric(db: CostDB, class_counts: np.ndarray,
                    metric: str) -> np.ndarray:
    """E[P(l)] per layer for P in {latency, energy, edp}."""
    e_lat = expected_latency(db, class_counts)
    if metric == "latency":
        return e_lat
    e_e = expected_energy(db, class_counts)
    if metric == "energy":
        return e_e
    if metric == "edp":
        return e_lat * e_e
    raise KeyError(metric)


def provision(db: CostDB, class_counts: np.ndarray,
              window_ranges: dict[int, tuple[int, int]],
              n_chiplets: int, metric: str = "edp",
              max_nodes_per_model: int | None = None) -> dict[int, int]:
    """Eq. (2) allocation for one window: {model_idx: n_nodes}."""
    if not window_ranges:
        return {}
    e_p = expected_metric(db, class_counts, metric)
    models = sorted(window_ranges)
    shares = np.array([e_p[s:e].sum() for s, e in
                       (window_ranges[m] for m in models)], dtype=np.float64)
    total = shares.sum()
    if total <= 0:
        alloc = np.ones(len(models), dtype=np.int64)
    else:
        alloc = np.round(shares / total * n_chiplets).astype(np.int64)

    # Heuristic 2 cap: never more nodes than layers (or the user cap).
    n_layers = np.array([window_ranges[m][1] - window_ranges[m][0]
                         for m in models], dtype=np.int64)
    cap = n_layers if max_nodes_per_model is None else np.minimum(
        n_layers, max_nodes_per_model)

    alloc = np.minimum(alloc, cap)
    alloc = np.maximum(alloc, 1)
    # repair: iteratively take from the largest until the budget is met
    while alloc.sum() > n_chiplets:
        donor = int(np.argmax(alloc))
        if alloc[donor] <= 1:
            # more models than chiplets: time-share, clamp everything to 1
            alloc[:] = 1
            break
        alloc[donor] -= 1
    # spend leftover nodes on the largest-share models (still capped)
    while alloc.sum() < min(n_chiplets, int(cap.sum())):
        order = np.argsort(-shares)
        grew = False
        for i in order:
            if alloc[i] < cap[i]:
                alloc[i] += 1
                grew = True
                break
        if not grew:
            break
        if alloc.sum() >= n_chiplets:
            break
    return {m: int(a) for m, a in zip(models, alloc)}


# ---------------------------------------------------------------------------
# fleet-level provisioning: package power/area budgets + routing decisions
# ---------------------------------------------------------------------------

# Extra-paper per-chiplet envelope constants (28 nm class, same family as
# PackageParams' documented extras).  Static power per chiplet and the PE /
# L2-SRAM area densities are MPSoC-budget-style scalars: coarse, but enough
# to rank fleet sizes under a power cap deterministically.
CHIPLET_STATIC_W = 0.35        # leakage + always-on per chiplet (W)
PE_AREA_MM2 = 0.0006           # int8 MAC PE + RF area (mm^2 / PE)
SRAM_AREA_MM2_PER_MB = 0.45    # L2 SRAM macro area (mm^2 / MB)
PACKAGE_OVERHEAD_MM2 = 25.0    # interposer fan-out, DRAM PHYs, misc


@dataclasses.dataclass(frozen=True)
class PackageBudget:
    """Fleet-level envelope: total power/area the fleet may provision.

    ``power_w`` caps the sum of provisioned packages' peak power
    (``package_power_w``); ``area_mm2`` caps summed package area.  Either
    may be ``inf`` (unconstrained).  The fleet autoscaler refuses to
    provision a package that would breach either cap.
    """

    power_w: float = float("inf")
    area_mm2: float = float("inf")

    def __post_init__(self) -> None:
        if self.power_w <= 0 or self.area_mm2 <= 0:
            raise ValueError("budgets must be positive")


def chiplet_peak_power_w(n_pe: int, pkg) -> float:
    """Peak dynamic + static power of one chiplet (W).

    Dynamic: every PE issues one int8 MAC per cycle plus the chiplet L2
    streaming at its full bytes/cycle — both priced with the Table I /
    DESIGN energy constants at the package clock.  Static:
    ``CHIPLET_STATIC_W``.
    """
    mac_w = n_pe * pkg.mac_e_pj * 1e-12 * pkg.clock_hz
    sram_w = (pkg.l2_bytes_per_cycle * 8 * pkg.sram_e_pj_per_bit
              * 1e-12 * pkg.clock_hz)
    return mac_w + sram_w + CHIPLET_STATIC_W


def package_power_w(mcm: MCM) -> float:
    """Peak power envelope of one MCM package (sum over chiplets, W)."""
    return sum(chiplet_peak_power_w(mcm.classes[i].n_pe, mcm.pkg)
               for i in mcm.class_map)


def package_idle_power_w(mcm: MCM) -> float:
    """Static (idle) power of one provisioned package (W).

    What an idle-but-provisioned package burns: per-chiplet leakage only.
    This is the value the fleet feeds ``OnlinePolicy.idle_power_w`` so
    policies that spread load thin pay for the packages they keep warm.
    """
    return CHIPLET_STATIC_W * mcm.n_chiplets


def package_area_mm2(mcm: MCM) -> float:
    """Silicon area of one MCM package (mm^2): PEs + L2 + overhead."""
    area = PACKAGE_OVERHEAD_MM2
    for i in mcm.class_map:
        c = mcm.classes[i]
        area += c.n_pe * PE_AREA_MM2
        area += (c.sz_mem / 2**20) * SRAM_AREA_MM2_PER_MB
    return area


def max_affordable_packages(mcm: MCM, budget: PackageBudget) -> int:
    """How many copies of ``mcm`` fit inside ``budget`` (0 if even one
    doesn't; unbounded budgets return a large sentinel)."""
    pw, pa = package_power_w(mcm), package_area_mm2(mcm)
    n = float("inf")
    if budget.power_w != float("inf"):
        n = min(n, budget.power_w // pw)
    if budget.area_mm2 != float("inf"):
        n = min(n, budget.area_mm2 // pa)
    return int(n) if n != float("inf") else 1 << 20


def pick_package(loads: list[float], capacity_left: list[bool],
                 policy: str, rr_cursor: int) -> tuple[int, int]:
    """Pure routing decision: choose a package for one arriving tenant.

    ``loads[i]`` is package *i*'s current offered load, ``capacity_left[i]``
    whether it can admit another tenant.  ``least_loaded`` picks the
    admissible package with the smallest (load, index); ``round_robin`` —
    the naive baseline — cycles ``rr_cursor`` through packages regardless
    of load, skipping only full ones.  Returns ``(package index, next
    cursor)``; index -1 when no package can admit (caller rejects or
    scales up).
    """
    n = len(loads)
    if policy == "least_loaded":
        best = -1
        for i in range(n):
            if capacity_left[i] and (best < 0 or loads[i] < loads[best]):
                best = i
        return best, rr_cursor
    if policy == "round_robin":
        for off in range(n):
            i = (rr_cursor + off) % n
            if capacity_left[i]:
                return i, (i + 1) % n
        return -1, rr_cursor
    raise KeyError(f"unknown routing policy {policy!r}")
