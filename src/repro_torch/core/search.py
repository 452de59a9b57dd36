"""Search algorithms over the SCHED combination space (Sec. IV-D, V-A).

The paper uses brute force on the 3x3 MCM and an evolutionary algorithm
(population 10, 4 generations) on the 6x6.  Both operate over the
``2 x |M|``-length encoding: per model a segmentation choice and a
segment->chiplet mapping choice.  Per-model candidates are pre-scored
vectorised (``ModelCandidateSet``); the search picks one candidate per model
subject to exclusive chiplet occupancy.

The EA itself lives in ``engine.EvolutionaryEngine`` (population fitness
and overlap penalty evaluated in one batched tensor pass).  This module
keeps the ``evolutionary_combine`` entry point and the scalar ``_fitness``
reference the engine's batched fitness is tested against, as the
reference's ``core/search.py`` does.
"""
from __future__ import annotations

import numpy as np

from .chiplet import MCM
from .engine import (EvolutionaryEngine, ModelCandidateSet,
                     WindowSearchResult)
from .maestro import CostDB

__all__ = ["evolutionary_combine"]


def _fitness(sets: list[ModelCandidateSet], picks: np.ndarray,
             metric: str) -> float:
    """Scalar reference for ``engine.batched_fitness`` (kept for tests)."""
    lmax, esum = 0.0, 0.0
    mask = 0
    overlap = 0
    for cs, ci in zip(sets, picks):
        m = cs.mask_ints()[int(ci)]
        overlap += bin(mask & m).count("1")
        mask |= m
        lmax = max(lmax, float(cs.lat[int(ci)]))
        esum += float(cs.energy[int(ci)])
    if metric == "latency":
        base = lmax
    elif metric == "energy":
        base = esum
    else:
        base = lmax * esum
    return base * (1.0 + 10.0 * overlap)


def evolutionary_combine(db: CostDB, mcm: MCM,
                         sets: list[ModelCandidateSet],
                         prev_end: dict[int, int],
                         metric: str = "edp",
                         population: int = 10, generations: int = 4,
                         mutation_rate: float = 0.3,
                         seed: int = 0) -> WindowSearchResult:
    """(mu + lambda) EA with uniform crossover and overlap-penalty fitness.

    A wrapper around ``engine.EvolutionaryEngine``; an overlapping best
    individual falls back to a beam-search repair inside the engine.
    """
    return EvolutionaryEngine(population=population, generations=generations,
                              mutation_rate=mutation_rate, seed=seed).combine(
        db, mcm, sets, prev_end, metric=metric)
