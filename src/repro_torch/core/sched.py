"""Scheduling engine (SCHED): segment -> chiplet mapping (Sec. IV-D).

The search space is a forest of scheduling trees: tree nodes are chiplets,
edges are XY-mesh adjacencies, subtree roots are constrained to (i) chiplets
with a direct DRAM interface (left/right package columns) or (ii) the model's
ending chiplet from the previous window (cross-window data locality).  The
path space is enumerated by the batched frontier expansion in ``paths.py``;
per-model candidates are scored by ``evaluator.eval_candidates`` on the
caller's device, and ``engine.BeamEngine`` combines disjoint per-model paths
into the window schedule.  This module owns candidate *construction*.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .chiplet import MCM
from .cost import BatchedModelCandidates
from .engine import ModelCandidateSet, WindowSearchResult
from .evaluator import eval_candidates
from .maestro import CostDB
from .paths import frontier_paths
from .quantize import SCORE_SIG, quantize_scores

__all__ = ["assemble_candidates", "build_candidates", "ModelCandidateSet",
           "WindowSearchResult"]


def assemble_candidates(mcm: MCM, model_idx: int,
                        rng_range: tuple[int, int],
                        segmentations: list[tuple[int, ...]],
                        prev_end: Optional[int],
                        path_cap: int = 256,
                        frontier_cap: Optional[int] = None
                        ) -> tuple[BatchedModelCandidates, np.ndarray, tuple]:
    """Candidate *construction* only, no scoring.

    Returns ``(cand, tiers[B], (words[B, W], chips[B, S], seg_arr[B, S]))``.

    The (segmentation x tier x path) tensor assembly of ``build_candidates``
    without the scoring stage, so benchmarks and tests can time/exercise the
    evaluator backends on exactly the production candidate batches.
    """
    start, end = rng_range
    starts = list(mcm.dram_ports())
    if prev_end is not None and prev_end not in starts:
        starts = [prev_end] + starts
    # Tier-2 roots: every remaining chiplet.  Only consulted by the combiner
    # when all tree-constrained candidates violate exclusive occupancy (the
    # extra hops to a DRAM port are charged by the cost model).
    fallback_starts = [c for c in range(mcm.n_chiplets) if c not in starts]
    Lw = end - start

    # Feasibility fallback: the trivial single-segment plan can occupy any
    # one free chiplet, so a disjoint combination always exists.
    if (Lw,) not in segmentations:
        segmentations = list(segmentations) + [(Lw,)]

    by_len: dict[int, list[tuple[np.ndarray, np.ndarray]]] = {}
    for seg in segmentations:
        n_seg = len(seg)
        if n_seg not in by_len:
            by_len[n_seg] = [
                frontier_paths(mcm.rows, mcm.cols, n_seg, starts,
                               cap=path_cap, frontier_cap=frontier_cap),
                frontier_paths(mcm.rows, mcm.cols, n_seg, fallback_starts,
                               cap=path_cap, frontier_cap=frontier_cap),
            ]

    # One block per (segmentation, tier): every path of that length paired
    # with the segmentation's layer split.  Blocks are concatenated in the
    # same (seg, tier, path) order the DFS-era assembly used, so the final
    # (tier, score) lexsort yields an identical candidate ordering.
    S = 0
    blocks: list[tuple[tuple[int, ...], int, np.ndarray, np.ndarray]] = []
    for seg in segmentations:
        for tier, (pool, pool_words) in enumerate(by_len[len(seg)]):
            if pool.shape[0] == 0:
                continue
            blocks.append((seg, tier, pool, pool_words))
            S = max(S, len(seg))
    if not blocks:
        raise RuntimeError(f"no placement candidates for model {model_idx}")

    chips_parts, words_parts, tier_parts = [], [], []
    segid_parts, segarr_parts, nseg_parts = [], [], []
    for seg, tier, pool, pool_words in blocks:
        n_seg = len(seg)
        n_paths = pool.shape[0]
        blk = np.full((n_paths, S), -1, dtype=np.int16)
        blk[:, :n_seg] = pool
        chips_parts.append(blk)
        words_parts.append(pool_words)
        tier_parts.append(np.full(n_paths, tier, dtype=np.int64))
        seg_rel = np.asarray(seg, dtype=np.int64)
        seg_row = np.repeat(np.arange(n_seg, dtype=np.int64),
                            np.diff(np.concatenate([[0], seg_rel])))
        segid_parts.append(np.broadcast_to(seg_row, (n_paths, Lw)))
        ends_row = np.full(S, -1, dtype=np.int64)
        ends_row[:n_seg] = start + seg_rel
        segarr_parts.append(np.broadcast_to(ends_row, (n_paths, S)))
        nseg_parts.append(np.full(n_paths, n_seg, dtype=np.int64))

    chips = np.concatenate(chips_parts)                    # [B, S] int16
    words = np.concatenate(words_parts)                    # [B, W] uint64
    tiers = np.concatenate(tier_parts)
    seg_id = np.concatenate(segid_parts)                   # [B, Lw]
    seg_arr = np.concatenate(segarr_parts)                 # [B, S]
    n_segs = np.concatenate(nseg_parts)

    cand = BatchedModelCandidates(model_idx=model_idx, start=start, end=end,
                                  seg_id=seg_id,
                                  chiplets=chips.astype(np.int64),
                                  n_segs=n_segs, seg_ends=seg_arr)
    return cand, tiers, (words, chips, seg_arr)


def build_candidates(db: CostDB, mcm: MCM, model_idx: int,
                     rng_range: tuple[int, int],
                     segmentations: list[tuple[int, ...]],
                     n_active: int,
                     prev_end: Optional[int],
                     path_cap: int = 256,
                     keep: int = 64,
                     metric: str = "edp",
                     frontier_cap: Optional[int] = None,
                     backend: Optional[str] = None,
                     comm_model: str = "analytic",
                     link_occ: Optional[np.ndarray] = None, *,
                     device: Optional[torch.device] = None
                     ) -> ModelCandidateSet:
    """Enumerate (segmentation x path) candidates for one model, keep top-k.

    Fully tensorised: path pools come out of ``paths.frontier_paths`` as
    ``[N, L]`` int16 / ``[N, W]`` uint64 arrays, per-segmentation blocks are
    assembled with broadcasts, and the resulting ``ModelCandidateSet``
    carries the tensors straight through to the search engines — no Python
    tuple is built per candidate anywhere on this path.

    ``backend`` selects the scoring evaluator (``core.evaluator``: float64
    oracle | plain float32 | CUDA kernel; ``None``/"auto" dispatches on
    batch size) and ``device`` where it runs.  Ordering determinism: scores
    are quantised to 6 significant digits before the stable (tier, score)
    lexsort, so the order is (i) deterministic per backend, and (ii) for
    *exactly* tied candidates — structural duplicates, repeated blocks —
    the enumeration order, identically on every backend.  Near-ties whose
    float32 and float64 scores land across a quantisation boundary may
    still swap between backends; such swaps are score-equivalent within the
    documented f32 tolerance.

    ``comm_model="congestion"`` makes the scoring congestion-aware:
    ``link_occ`` carries the interposer byte occupancy of the models already
    placed in this window (``scheduler.build_window_sets`` threads it), so
    candidates whose routes overlap the established traffic rank lower —
    this is the placement co-search half of the congestion model.
    """
    start, end = rng_range
    cand, tiers, (words, chips, seg_arr) = assemble_candidates(
        mcm, model_idx, rng_range, segmentations, prev_end,
        path_cap=path_cap, frontier_cap=frontier_cap)
    n_segs = cand.n_segs
    lat, energy = eval_candidates(db, mcm, cand, n_active=n_active,
                                  prev_end=prev_end, backend=backend,
                                  comm_model=comm_model, link_occ=link_occ,
                                  device=device)
    if metric == "latency":
        score = lat
    elif metric == "energy":
        score = energy
    else:
        score = lat * energy
    # Keep ALL candidates sorted by (tier, score); the combiner expands the
    # first ``keep`` per beam item and falls back deeper (eventually into the
    # unconstrained-root tier) only when blocked by exclusive occupancy.
    order = np.lexsort((quantize_scores(score, sig=SCORE_SIG), tiers))
    return ModelCandidateSet(
        model_idx=model_idx, start=start, end=end,
        lat=lat[order], energy=energy[order], keep=keep,
        mask_words=words[order], chips=chips[order],
        n_segs=n_segs[order], seg_arr=seg_arr[order])
