"""Vectorized candidate-tensor window combination (SCHED).

SCAR's hot path is window combination: pick one scored placement candidate
per model subject to exclusive chiplet occupancy.  The port keeps the
reference's host numpy engines, which are bit-identical to its Python
oracle:

* ``CandidateTensors`` packs a window's per-model ``ModelCandidateSet`` list
  into ``[M, N, W]`` uint64 occupancy-mask words plus ``[M, N]`` latency /
  energy tables (``W = ceil(n_chiplets / 64)`` words, so packages beyond 64
  chiplets — e.g. 16x16 pods — keep exact masks); ``batched_fitness``
  scores picks over them.
* ``BeamEngine`` is the vectorized beam search: beam x candidate
  disjointness via one broadcast ``mask & masks == 0`` pass, stable top-k
  via ``argsort``.  It reproduces ``reference_combine`` bit-identically.

``get_engine`` maps ``SearchConfig.algo`` to an engine.  The reference's
device beam (``beam_jax``) and its stochastic engines (``evolutionary``,
``anneal``) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np

from repro_torch import obs

from .chiplet import MCM
from .cost import ModelWindowPlan, WindowPlan, WindowResult, evaluate_window
from .maestro import CostDB

_MASK64 = (1 << 64) - 1

@dataclasses.dataclass(frozen=True)
class ModelCandidateSet:
    """Scored placement candidates of one model in one window.

    Candidates are sorted by (tier, score) at build time: tier 0 are
    scheduling-tree-rooted paths (DRAM ports / locality anchors), tier 1 the
    unconstrained fallback roots consulted only when tier 0 is fully blocked
    by exclusive occupancy.

    Two interchangeable representations are supported.  The hot path
    (``sched.build_candidates``) fills the *tensor* fields — ``chips`` /
    ``n_segs`` / ``seg_arr`` / ``mask_words`` — and never materialises a
    Python object per candidate; the legacy *list* fields (``paths`` /
    ``masks`` / ``seg_ends_abs``) may be passed instead (tests, ad-hoc
    construction) and either form is derived lazily from the other on first
    access, cached on the instance.
    """

    model_idx: int
    start: int
    end: int
    lat: np.ndarray
    energy: np.ndarray
    seg_ends_abs: list[tuple[int, ...]] | None = None   # per candidate
    paths: list[tuple[int, ...]] | None = None
    masks: list[int] | None = None
    keep: int = 64                           # preferred expansion width
    mask_words: np.ndarray | None = None     # [N, W] uint64 (lazy if None)
    chips: np.ndarray | None = None          # [N, S] int16, -1 padded
    n_segs: np.ndarray | None = None         # [N]
    seg_arr: np.ndarray | None = None        # [N, S] abs layer ends, -1 pad

    @property
    def n_cands(self) -> int:
        """Candidate count (representation-independent)."""
        return int(self.lat.shape[0])

    def words(self, n_words: int) -> np.ndarray:
        """Packed occupancy words, computed at build time or on demand."""
        mw = self.mask_words
        if mw is None or mw.shape[1] < n_words:
            mw = _pack_masks(self.mask_ints(), n_words)
            object.__setattr__(self, "mask_words", mw)
        return mw

    def path(self, i: int) -> tuple[int, ...]:
        """Candidate ``i``'s chiplet path as a tuple (single-row unpack)."""
        if self.paths is not None:
            return self.paths[i]
        row = self.chips[i]
        return tuple(int(c) for c in row[: int(self.n_segs[i])])

    def seg_end(self, i: int) -> tuple[int, ...]:
        """Candidate ``i``'s absolute segment ends as a tuple."""
        if self.seg_ends_abs is not None:
            return self.seg_ends_abs[i]
        row = self.seg_arr[i]
        return tuple(int(e) for e in row[: int(self.n_segs[i])])

    def path_list(self) -> list[tuple[int, ...]]:
        """All paths as tuples (materialised lazily, cached)."""
        if self.paths is None:
            object.__setattr__(
                self, "paths", [self.path(i) for i in range(self.n_cands)])
        return self.paths

    def mask_ints(self) -> list[int]:
        """Occupancy masks as Python ints (materialised lazily, cached).

        Only the scalar oracles (``reference_combine``, ``search._fitness``)
        need this form; the engines stay on ``mask_words``.
        """
        if self.masks is None:
            mw = self.mask_words
            if mw is not None:
                ints = [0] * mw.shape[0]
                for w in range(mw.shape[1]):
                    shift = 64 * w
                    col = mw[:, w].tolist()
                    ints = [m | (v << shift) for m, v in zip(ints, col)]
            else:                            # list-form set without masks
                ints = []
                for p in self.path_list():
                    m = 0
                    for c in p:
                        m |= 1 << int(c)
                    ints.append(m)
            object.__setattr__(self, "masks", ints)
        return self.masks


@dataclasses.dataclass
class WindowSearchResult:
    plan: WindowPlan
    result: WindowResult
    explored: list[tuple[float, float]]   # (lat, energy) cloud for Pareto


def _pack_masks(masks: list[int], n_words: int) -> np.ndarray:
    """Python-int occupancy masks -> [N, W] uint64 words."""
    out = np.empty((len(masks), n_words), dtype=np.uint64)
    for w in range(n_words):
        shift = 64 * w
        out[:, w] = np.array([(m >> shift) & _MASK64 for m in masks],
                             dtype=np.uint64)
    return out


@dataclasses.dataclass(frozen=True)
class CandidateTensors:
    """A window's candidate sets as padded tensors (the engine currency).

    ``masks``: [M, N_max, W] uint64 occupancy words (padding = all ones so a
    padded candidate conflicts with everything).
    ``lat``/``energy``: [M, N_max] float64 (+inf padding keeps padded rows
    out of any argmin).  ``sizes``: [M] true candidate counts.
    """

    sets: tuple[ModelCandidateSet, ...]
    masks: np.ndarray
    lat: np.ndarray
    energy: np.ndarray
    sizes: np.ndarray
    n_words: int

    @classmethod
    def from_sets(cls, sets: list[ModelCandidateSet],
                  n_chiplets: int) -> "CandidateTensors":
        n_words = max(1, (n_chiplets + 63) // 64)
        m_models = len(sets)
        sizes = np.array([cs.n_cands for cs in sets], dtype=np.int64)
        n_max = int(sizes.max()) if m_models else 0
        masks = np.full((m_models, n_max, n_words), _MASK64, dtype=np.uint64)
        lat = np.full((m_models, n_max), np.inf)
        energy = np.full((m_models, n_max), np.inf)
        for m, cs in enumerate(sets):
            n = cs.n_cands
            masks[m, :n] = cs.words(n_words)
            lat[m, :n] = cs.lat
            energy[m, :n] = cs.energy
        return cls(sets=tuple(sets), masks=masks, lat=lat, energy=energy,
                   sizes=sizes, n_words=n_words)


def metric_score(lat, energy, metric: str):
    """Scalar or vectorized schedule metric (edp is the default)."""
    if metric == "latency":
        return lat
    if metric == "energy":
        return energy
    return lat * energy


def batched_fitness(ct: CandidateTensors, picks: np.ndarray, metric: str
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Population fitness in one batched pass.

    ``picks``: [P, M] candidate index per model.  Returns ``(fitness, lmax,
    esum, overlap)``, each [P].  Accumulates across the model axis in order
    so floats match the scalar reference (``search._fitness``) bit-for-bit.
    """
    n_pop = picks.shape[0]
    lmax = np.zeros(n_pop)
    esum = np.zeros(n_pop)
    overlap = np.zeros(n_pop, dtype=np.int64)
    occ = np.zeros((n_pop, ct.n_words), dtype=np.uint64)
    for m in range(len(ct.sets)):
        idx = picks[:, m]
        mw = ct.masks[m][idx]                                    # [P, W]
        overlap += np.bitwise_count(occ & mw).sum(axis=1).astype(np.int64)
        occ |= mw
        lmax = np.maximum(lmax, ct.lat[m][idx])
        esum = esum + ct.energy[m][idx]
    base = metric_score(lmax, esum, metric)
    return base * (1.0 + 10.0 * overlap), lmax, esum, overlap


def _plans_from_picks(sets, picks) -> WindowPlan:
    plans = []
    for cs, ci in zip(sets, picks):
        ci = int(ci)
        plans.append(ModelWindowPlan(
            model_idx=cs.model_idx, start=cs.start, end=cs.end,
            seg_ends=cs.seg_end(ci), chiplets=cs.path(ci),
            pipelined=True))
    return WindowPlan(plans=tuple(sorted(plans, key=lambda p: p.model_idx)))


class SearchEngine(Protocol):
    """One window-combination solver: pick one candidate per model."""

    def combine(self, db: CostDB, mcm: MCM, sets: list[ModelCandidateSet],
                prev_end: dict[int, int],
                metric: str = "edp") -> WindowSearchResult: ...


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BeamEngine:
    """Vectorized beam search over disjoint per-model path combinations.

    Per model stage, disjointness of every (beam item, candidate) pair is one
    broadcast AND over the packed mask words; the reference loop's per-item
    ``keep`` width and the global expansion budget are reproduced with
    cumulative-sum bookkeeping so results stay bit-identical to
    ``reference_combine``.
    """

    beam: int = 64
    max_expansions: int = 20000
    comm_model: str = "analytic"

    def combine(self, db: CostDB, mcm: MCM, sets: list[ModelCandidateSet],
                prev_end: dict[int, int],
                metric: str = "edp") -> WindowSearchResult:
        with obs.span("combine", cat="engine", engine="beam",
                      models=len(sets), beam=self.beam):
            return self._combine(db, mcm, sets, prev_end, metric)

    def _combine(self, db: CostDB, mcm: MCM, sets: list[ModelCandidateSet],
                 prev_end: dict[int, int],
                 metric: str = "edp") -> WindowSearchResult:
        # order models by compute weight (largest first: hardest to place)
        sets = sorted(sets, key=lambda s: -float(np.min(s.lat)))
        n_words = max(1, (mcm.n_chiplets + 63) // 64)

        b_mask = np.zeros((1, n_words), dtype=np.uint64)
        b_lat = np.zeros(1)
        b_energy = np.zeros(1)
        b_picks = np.zeros((1, 0), dtype=np.int64)
        explored: list[tuple[float, float]] = []
        expansions = 0
        for cs in sets:
            with obs.span("beam_stage", cat="engine", model=cs.model_idx,
                          cands=cs.n_cands):
                n_cand = cs.n_cands
                cand_masks = cs.words(n_words)                    # [N, W]
                if n_words == 1:
                    disjoint = (b_mask[:, 0, None]
                                & cand_masks[None, :, 0]) == 0    # [B, N]
                else:
                    disjoint = ((b_mask[:, None, :]
                                 & cand_masks[None, :, :]) == 0).all(axis=-1)
                # per-beam-item expansion width (candidates are (tier, score)
                # sorted, so "first keep disjoint" == "best keep disjoint")
                if cs.keep < n_cand:
                    rank = np.add.accumulate(disjoint, axis=1, dtype=np.int32)
                    sel = disjoint & (rank <= cs.keep)
                else:
                    sel = disjoint
                total = int(np.count_nonzero(sel))
                if total == 0:
                    raise RuntimeError(
                        f"no disjoint placement for model {cs.model_idx} "
                        f"even after scanning all {n_cand} candidates; "
                        f"increase path_cap or reduce provisioned nodes")
                if expansions + total > self.max_expansions:
                    # global expansion budget, row-major acceptance order;
                    # the first acceptance of a stage always goes through
                    flat_sel = sel.ravel()
                    before = np.cumsum(flat_sel) - flat_sel
                    okf = flat_sel & (
                        (expansions + before < self.max_expansions)
                        | (before == 0))
                    sel = okf.reshape(sel.shape)
                    total = int(np.count_nonzero(sel))
                expansions += total
                rows, cand_idx = np.nonzero(sel)
                new_lat = np.maximum(b_lat[rows], cs.lat[cand_idx])
                new_energy = b_energy[rows] + cs.energy[cand_idx]
                # scarlint: ignore[SL004] -- f64 host beam ordering, stable
                # by construction; the device protocol program mirrors this
                # exact argsort (quantising here would fork the bit-parity)
                order = np.argsort(metric_score(new_lat, new_energy, metric),
                                   kind="stable")[:self.beam]
                rows, cand_idx = rows[order], cand_idx[order]
                b_mask = b_mask[rows] | cand_masks[cand_idx]
                b_lat, b_energy = new_lat[order], new_energy[order]
                b_picks = np.concatenate(
                    [b_picks[rows], cand_idx[:, None]], axis=1)
                explored.extend(zip(b_lat.tolist(), b_energy.tolist()))

        plan = _plans_from_picks(sets, b_picks[0])
        result = evaluate_window(db, mcm, plan, prev_end, validate=True,
                                 comm_model=self.comm_model)
        return WindowSearchResult(plan=plan, result=result, explored=explored)


def reference_combine(db: CostDB, mcm: MCM, sets: list[ModelCandidateSet],
                      prev_end: dict[int, int], metric: str = "edp",
                      beam: int = 64,
                      max_expansions: int = 20000,
                      comm_model: str = "analytic") -> WindowSearchResult:
    """Reference Python beam search (the seed implementation).

    Kept as the oracle for ``BeamEngine`` parity tests and as the baseline
    for ``bench_sched_throughput``; not used on the scheduling hot path.
    """
    sets = sorted(sets, key=lambda s: -float(np.min(s.lat)))
    # beam items: (mask, lat_max, energy_sum, [choice indices])
    items: list[tuple[int, float, float, list[int]]] = [(0, 0.0, 0.0, [])]
    explored: list[tuple[float, float]] = []
    expansions = 0
    for cs in sets:
        cs_masks = cs.mask_ints()
        nxt: list[tuple[int, float, float, list[int]]] = []
        for mask, lmax, esum, picks in items:
            found = 0
            for ci in range(cs.n_cands):
                if (expansions >= max_expansions or found >= cs.keep) and nxt:
                    break
                if mask & cs_masks[ci]:
                    continue
                expansions += 1
                found += 1
                nl = max(lmax, float(cs.lat[ci]))
                ne = esum + float(cs.energy[ci])
                nxt.append((mask | cs_masks[ci], nl, ne, picks + [ci]))
        if not nxt:
            raise RuntimeError(
                f"no disjoint placement for model {cs.model_idx} even after "
                f"scanning all {cs.n_cands} candidates; "
                f"increase path_cap or reduce provisioned nodes")
        nxt.sort(key=lambda it: metric_score(it[1], it[2], metric))
        explored.extend((l, e) for _, l, e, _ in nxt[:beam])
        items = nxt[:beam]

    plan = _plans_from_picks(sets, items[0][3])
    result = evaluate_window(db, mcm, plan, prev_end, validate=True,
                             comm_model=comm_model)
    return WindowSearchResult(plan=plan, result=result, explored=explored)


# Engines of the reference that this port has not reached yet, with the
# ROADMAP.md item each waits on.
_UNPORTED_ALGOS = {
    "beam_jax": "queue 1 item 7 (fused device search and scar_search)",
    "evolutionary": "queue 1 item 6b (EvolutionaryEngine)",
    "anneal": "queue 1 item 6b (AnnealEngine)",
}


def get_engine(cfg, seed: int = 0) -> SearchEngine:
    """Engine factory keyed on ``SearchConfig.algo``.

    ``brute`` and ``beam`` select the host ``BeamEngine``.  ``seed`` is the
    per-window seed of the stochastic engines, which are not ported yet.
    """
    algo = cfg.algo
    if algo in ("brute", "beam"):
        return BeamEngine(beam=cfg.beam,
                          comm_model=getattr(cfg, "comm_model", "analytic"))
    if algo in _UNPORTED_ALGOS:
        raise NotImplementedError(
            f"algo={algo!r} is not ported yet (ROADMAP.md "
            f"{_UNPORTED_ALGOS[algo]})")
    raise KeyError(f"unknown search algo {algo!r}; "
                   "have brute|beam|beam_jax|evolutionary|anneal")
