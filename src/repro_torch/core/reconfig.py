"""MCM-Reconfig engine: time-window characterisation + greedy layer packing.

Implements Sec. IV-A: Eq. (1) dataflow-marginalised expected latency, periodic
window boundaries over the worst-case model horizon, and Algorithm 1
(first-fit greedy packing).  Also provides the uniform-packing baseline used
in the paper's ablation and the layer-optimal cut-point search of Fig. 4.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from .maestro import CostDB, expected_latency


@dataclasses.dataclass(frozen=True)
class WindowAssignment:
    """L2W: per-window, per-model contiguous flat layer ranges.

    ``ranges[w][m] = (start, end)`` flat CostDB indices; absent model keys mean
    the model has no layers in window ``w``.  Windows with no layers at all
    are dropped (the paper: "skipping trivial windows").
    """

    ranges: tuple[dict[int, tuple[int, int]], ...]
    boundaries: tuple[float, ...]     # rho: cumulative window end times

    @property
    def n_windows(self) -> int:
        return len(self.ranges)


def periodic_boundaries(db: CostDB, class_counts: np.ndarray,
                        n_splits: int) -> np.ndarray:
    """rho[k]: periodic boundaries over the worst-case model horizon."""
    e_lat = expected_latency(db, class_counts)
    horizon = max(float(e_lat[db.model_slice(i)].sum())
                  for i in range(db.n_models))
    n_windows = n_splits + 1
    return np.cumsum(np.full(n_windows - 1, horizon / n_windows))


def greedy_pack(db: CostDB, class_counts: np.ndarray, n_splits: int,
                boundaries: Optional[np.ndarray] = None) -> WindowAssignment:
    """Algorithm 1: first-fit greedy layer packing into periodic windows."""
    e_lat = expected_latency(db, class_counts)
    rho = (periodic_boundaries(db, class_counts, n_splits)
           if boundaries is None else np.asarray(boundaries, dtype=np.float64))
    n_windows = len(rho) + 1
    l2w: list[dict[int, tuple[int, int]]] = [dict() for _ in range(n_windows)]
    for mi in range(db.n_models):
        sl = db.model_slice(mi)
        start = sl.start
        win_idx = 0
        used = 0.0
        seg_start = start
        for li in range(sl.start, sl.stop):
            lat = float(e_lat[li])
            while True:
                slack = None if win_idx == len(rho) else float(rho[win_idx]) - used
                if slack is None or lat <= slack:
                    used += lat
                    break
                # close the current window for this model, defer layer
                if li > seg_start:
                    l2w[win_idx][mi] = (seg_start, li)
                seg_start = li
                used = float(rho[win_idx])
                win_idx += 1
        if sl.stop > seg_start:
            l2w[win_idx][mi] = (seg_start, sl.stop)
    # drop trivial windows (dynamic window-count control, Sec. IV-A)
    kept = [(w, r) for w, r in enumerate(l2w) if r]
    ranges = tuple(r for _, r in kept)
    bounds = tuple(float(rho[w]) if w < len(rho) else float("inf")
                   for w, _ in kept)
    return WindowAssignment(ranges=ranges, boundaries=bounds)


def uniform_pack(db: CostDB, n_splits: int) -> WindowAssignment:
    """Ablation baseline: evenly split each model's layers across windows."""
    n_windows = n_splits + 1
    l2w: list[dict[int, tuple[int, int]]] = [dict() for _ in range(n_windows)]
    for mi in range(db.n_models):
        sl = db.model_slice(mi)
        n = sl.stop - sl.start
        cuts = np.linspace(0, n, n_windows + 1).round().astype(int)
        for w in range(n_windows):
            s, e = sl.start + cuts[w], sl.start + cuts[w + 1]
            if e > s:
                l2w[w][mi] = (int(s), int(e))
    kept = [r for r in l2w if r]
    return WindowAssignment(ranges=tuple(kept),
                            boundaries=tuple(float("inf") for _ in kept))


def validate_assignment(db: CostDB, wa: WindowAssignment) -> None:
    """Theorem 2: windows partition the workload (coverage + exclusivity)."""
    seen = np.zeros(db.n_layers, dtype=bool)
    for r in wa.ranges:
        for mi, (s, e) in r.items():
            msl = db.model_slice(mi)
            if not (msl.start <= s < e <= msl.stop):
                raise ValueError(f"window range ({s},{e}) outside model {mi}")
            if seen[s:e].any():
                raise ValueError("layer assigned to two windows")
            seen[s:e] = True
    if not seen.all():
        raise ValueError("layers missing from all windows")
