"""Provisioner engine (PROV): per-window chiplet-node allocation (Sec. IV-B).

Eq. (2): nodes are distributed proportionally to each model's expected share
of the optimisation metric in the window, with (a) a >=1-node-per-model repair
loop and (b) Heuristic 2's node cap (no model gets more nodes than layers, or
than the user-specified cap).
"""
from __future__ import annotations

import numpy as np

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
