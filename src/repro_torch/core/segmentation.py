"""Segmentation engine (SEG): layer-to-segment partitioning (Sec. IV-C).

A segmentation of a model's window slice [start, end) with up to N nodes is a
choice of <= N-1 split points among the end-1-start interior positions
(segments are contiguous, Theorem 1).  Heuristic 1 scores each model's
segmentation space *independently* with a placement-agnostic score and keeps
the top-k, reducing O(prod_i |L_i| x |N_i|) to O(max_i |L_i| x |N_i|); the
cross product of per-model top-k's is handed to SCHED.
"""
from __future__ import annotations

import itertools

import numpy as np

from .chiplet import MCM
from .maestro import CostDB
from .quantize import quantize_scores


def enumerate_segmentations(n_layers: int, max_segments: int,
                            cap: int = 4096) -> list[tuple[int, ...]]:
    """All segmentations of ``n_layers`` into <= ``max_segments`` runs.

    Returned as tuples of *relative* end offsets (1..n_layers, last ==
    n_layers).  Deterministically subsampled to ``cap`` if the space is
    larger (Heuristic 2 keeps this from exploding in practice).
    """
    max_segments = max(1, min(max_segments, n_layers))
    out: list[tuple[int, ...]] = []
    for k in range(max_segments):  # k split points -> k+1 segments
        for cuts in itertools.combinations(range(1, n_layers), k):
            out.append(cuts + (n_layers,))
            if len(out) >= 4 * cap:
                break
        if len(out) >= 4 * cap:
            break
    if len(out) > cap:
        idx = np.linspace(0, len(out) - 1, cap).astype(int)
        out = [out[i] for i in idx]
    return out


def score_segmentations_batch(db: CostDB, mcm: MCM, start: int,
                              segs: list[tuple[int, ...]],
                              metric: str = "edp") -> np.ndarray:
    """Placement-agnostic solo scores of a candidate segmentation list.

    One ``np.add.reduceat`` pass over the candidate-tiled window slice
    scores every candidate at once, exactly as the reference does.
    """
    pkg = mcm.pkg
    n = len(segs)
    if n == 0:
        return np.zeros(0)
    n_segs = np.array([len(se) for se in segs], dtype=np.int64)
    S = int(n_segs.max())
    Lw = int(segs[0][-1])
    if any(int(se[-1]) != Lw for se in segs):
        # the tiling below runs each candidate's last segment to its tile
        # end, so unequal totals would silently absorb extra layers
        raise ValueError("all segmentations must cover the same window "
                         "length (relative last end)")
    ends = np.zeros((n, S), dtype=np.int64)          # relative, 0-padded
    for i, se in enumerate(segs):
        ends[i, :len(se)] = se
    valid = np.arange(S)[None, :] < n_segs[:, None]
    starts = np.concatenate([np.zeros((n, 1), dtype=np.int64),
                             ends[:, :-1]], axis=1)

    # Segment sums via one reduceat over the candidate-tiled window slice:
    # each candidate's segments exactly tile its copy, so consecutive flat
    # start indices delimit every segment (no prefix-sum cancellation).
    sl = slice(start, start + Lw)
    flat_starts = (np.arange(n)[:, None] * Lw + starts)[valid]
    seg_lat_c = np.zeros((n, S, db.lat.shape[1]))
    seg_e_c = np.zeros_like(seg_lat_c)
    w = np.zeros((n, S))
    seg_lat_c[valid] = np.add.reduceat(
        np.tile(db.lat[sl], (n, 1)), flat_starts, axis=0)
    seg_e_c[valid] = np.add.reduceat(
        np.tile(db.energy[sl], (n, 1)), flat_starts, axis=0)
    w[valid] = np.add.reduceat(np.tile(db.w_bytes[sl], n), flat_starts)

    # padded rows are all-zero; force them out of the argmin/max with +inf
    seg_lat_c[~valid] = np.inf
    cls = np.argmin(seg_lat_c, axis=2)                             # [n, S]
    lat_best = np.take_along_axis(seg_lat_c, cls[:, :, None],
                                  axis=2)[:, :, 0]                 # [n, S]
    e_best = np.take_along_axis(seg_e_c, cls[:, :, None],
                                axis=2)[:, :, 0]
    load = w / pkg.dram_bw + pkg.dram_lat_s
    seg_lat = np.where(valid, lat_best + load, -np.inf)
    seg_e = np.where(valid, e_best + w * 8.0 * pkg.dram_e_pj_per_bit * 1e-12,
                     0.0)
    # max == sum for single-segment candidates, so pipelined max covers both
    lat = seg_lat.max(axis=1)
    energy = seg_e.sum(axis=1)
    if metric == "latency":
        return lat
    if metric == "energy":
        return energy
    return lat * energy


def top_k_segmentations(db: CostDB, mcm: MCM, start: int, end: int,
                        n_nodes: int, k: int = 4, cap: int = 1024,
                        metric: str = "edp") -> list[tuple[int, ...]]:
    """Heuristic 1 step 1: per-model top-k segmentations by solo score."""
    cands = enumerate_segmentations(end - start, n_nodes, cap=cap)
    scores = quantize_scores(
        score_segmentations_batch(db, mcm, start, cands, metric))
    order = np.argsort(scores, kind="stable")[:k]
    return [cands[i] for i in order]
