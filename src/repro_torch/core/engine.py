"""Vectorized candidate-tensor window combination (SCHED).

SCAR's hot path is window combination: pick one scored placement candidate
per model subject to exclusive chiplet occupancy.  The port keeps the
reference's engines, each bit-identical to its Python oracle where the
reference's is:

* ``CandidateTensors`` packs a window's per-model ``ModelCandidateSet`` list
  into ``[M, N, W]`` uint64 occupancy-mask words plus ``[M, N]`` latency /
  energy tables (``W = ceil(n_chiplets / 64)`` words, so packages beyond 64
  chiplets — e.g. 16x16 pods — keep exact masks); ``batched_fitness``
  scores picks over them.
* ``BeamEngine`` is the vectorized beam search: beam x candidate
  disjointness via one broadcast ``mask & masks == 0`` pass, stable top-k
  via ``argsort``.  It reproduces ``reference_combine`` bit-identically.
* ``DeviceBeamEngine`` (``algo="beam_jax"``) moves the window search onto
  the device (``core.device_search``): scoring, disjointness screening
  (the ``scar_search`` kernel), beam expansion and top-k run between one
  upload and one fetch per window.  Its protocol-form ``combine`` is
  bit-identical to ``reference_combine`` in float64.
* ``EvolutionaryEngine`` keeps the paper's (mu + lambda) EA trajectory (the
  reference's numpy RNG call sequence) and scores the population with one
  ``batched_fitness`` pass a generation.
* ``AnnealEngine`` runs vectorized parallel simulated-annealing chains over
  the same tensors (beyond-paper; ``SearchConfig.algo = "anneal"``).

The stochastic engines stay on the host: their numpy ``Generator`` streams
and float64 fitness follow the reference's trajectories step for step.
``get_engine`` maps ``SearchConfig.algo`` to an engine.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Protocol

import numpy as np
import torch

from repro_torch import obs
from repro_torch.launch import platform
from repro_torch.launch.platform import resolve_device

from .chiplet import MCM
from .cost import ModelWindowPlan, WindowPlan, WindowResult, evaluate_window
from .maestro import CostDB

_MASK64 = (1 << 64) - 1

# Anneal move accounting (always-on registry counters).  EA/beam don't
# propose/accept moves, so only the stochastic chains engine feeds these.
_ANNEAL_PROPOSED = obs.counter("engine.anneal.moves_proposed")
_ANNEAL_ACCEPTED = obs.counter("engine.anneal.moves_accepted")


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


# ---------------------------------------------------------------------------
# Whole-search-on-device beam
# ---------------------------------------------------------------------------

def _raise_no_disjoint(model_idx: int, n_cands: int):
    # the exact BeamEngine / reference_combine failure contract
    raise RuntimeError(
        f"no disjoint placement for model {model_idx} even "
        f"after scanning all {n_cands} candidates; "
        f"increase path_cap or reduce provisioned nodes")


def _backtrack(parents: np.ndarray, cands: np.ndarray) -> np.ndarray:
    """Per-stage picks of beam row 0 from the device scan's link tables.

    Walks the ([M, beam] each) (parent, cand) links backwards from the
    best final beam item.
    """
    m = parents.shape[0]
    picks = np.zeros(m, dtype=np.int64)
    row = 0
    for st in range(m - 1, -1, -1):
        picks[st] = cands[st, row]
        row = int(parents[st, row])
    return picks


def _explored(tlats: np.ndarray, tes: np.ndarray,
              counts: np.ndarray) -> list[tuple[float, float]]:
    """Per-stage (lat, energy) cloud, first ``counts[m]`` beam rows each.

    The rows past a stage's live count are top-k filler.
    """
    explored: list[tuple[float, float]] = []
    for m in range(tlats.shape[0]):
        n = int(counts[m])
        explored.extend(zip(tlats[m, :n].tolist(), tes[m, :n].tolist()))
    return explored


@dataclasses.dataclass(frozen=True)
class DeviceBeamEngine:
    """Beam search whose window combine runs on the device.

    Two entry points share ``core.device_search.beam_scan``:

    * ``combine`` — the ``SearchEngine`` protocol form.  Consumes
      host-scored candidate sets and runs the *combination*
      (disjointness screen via the ``kernels.scar_search`` kernel,
      keep/budget accounting, beam expansion, top-k) on the device in
      float64, with the reference's exact IEEE operations and its
      lowest-index tie rule, so plans, metrics and the explored cloud are
      bit-identical to ``reference_combine``.
    * ``combine_window`` — the fused form ``scheduler.schedule`` routes
      ``algo="beam_jax"`` through.  The host constructs candidates (PROV +
      SEG + tensor assembly) and uploads them; scoring (``scar_eval``),
      quantised (tier, score) candidate ordering, model ordering, the beam
      scan and top-k then run on the device in float32, and the window's
      result returns in one counted ``launch.platform.device_fetch``.  The
      final plan is re-scored and validated by the float64 host accounting
      (``evaluate_window``), so reported metrics stay exact.

    ``device`` is where both run (CUDA unless the caller asks for the
    CPU).  ``use_kernel=None`` launches the CUDA kernels on a CUDA device
    and runs their plain torch versions on the CPU; ``True`` on the CPU
    raises.
    """

    beam: int = 64
    max_expansions: int = 20000
    use_kernel: Optional[bool] = None
    comm_model: str = "analytic"
    device: Optional[str | torch.device] = None

    def _setup(self) -> tuple[torch.device, bool]:
        dev = resolve_device(self.device)
        if self.use_kernel is None:
            return dev, dev.type == "cuda"
        if self.use_kernel and dev.type != "cuda":
            raise RuntimeError("use_kernel=True needs a CUDA device; the "
                               f"engine runs on {dev}")
        return dev, self.use_kernel

    def combine(self, db: CostDB, mcm: MCM, sets: list[ModelCandidateSet],
                prev_end: dict[int, int],
                metric: str = "edp") -> WindowSearchResult:
        from . import device_search as ds

        dev, use_kernel = self._setup()
        sets = sorted(sets, key=lambda s: -float(np.min(s.lat)))
        n_words = max(1, (mcm.n_chiplets + 63) // 64)
        m_models = len(sets)
        n_pad = ds.bucket_size(max(cs.n_cands for cs in sets))
        masks = np.zeros((m_models, n_pad, 2 * n_words), dtype=np.uint32)
        lat = np.full((m_models, n_pad), np.inf)
        energy = np.full((m_models, n_pad), np.inf)
        valid = np.zeros((m_models, n_pad), dtype=bool)
        for m, cs in enumerate(sets):
            n = cs.n_cands
            masks[m, :n] = ds.split_words_u32(cs.words(n_words))
            lat[m, :n] = cs.lat
            energy[m, :n] = cs.energy
            valid[m, :n] = True
        with obs.span("device_combine", cat="engine", engine="beam_jax",
                      models=m_models, n_pad=n_pad):
            full = platform.device_upload(
                {"words": masks.view(np.int32), "lat": lat,
                 "energy": energy, "valid": valid}, dev)
            out = ds.beam_scan(
                tuple(full[k] for k in ("words", "lat", "energy", "valid")),
                [cs.keep for cs in sets], beam=self.beam, metric=metric,
                max_exp=self.max_expansions, use_kernel=use_kernel)
            # the single host transfer of the whole combination
            parents, cands, tlats, tes, counts, fails = \
                platform.device_fetch(*out)
        failed = np.flatnonzero(fails)
        if failed.size:
            cs = sets[int(failed[0])]
            _raise_no_disjoint(cs.model_idx, cs.n_cands)
        plan = _plans_from_picks(sets, _backtrack(parents, cands))
        result = evaluate_window(db, mcm, plan, prev_end, validate=True,
                                 comm_model=self.comm_model)
        return WindowSearchResult(plan=plan, result=result,
                                  explored=_explored(tlats, tes, counts))

    def window_inputs(self, db: CostDB, mcm: MCM, cfg,
                      ranges: dict[int, tuple[int, int]],
                      prev_end: dict[int, int]) -> tuple[tuple, list, int]:
        """Host half of ``combine_window``: build and upload one window.

        PROV + SEG + candidate assembly on the host, then every input of
        the window's device program copied to the device in one copy per
        dtype (``platform.device_upload``; the copies block the host, the
        program itself then makes no sync).  Returns ``(window, built,
        n_pad)``: ``fused_program``'s input, the per-model
        ``(cand, chips, seg_arr)`` host arrays the plan is rebuilt from,
        and the padded candidate width.
        """
        from repro_torch.kernels.scar_eval import (WindowBatch, model_inputs,
                                                   window_arrays)

        from . import device_search as ds
        from .provision import provision
        from .quantize import pow10_table
        from .sched import assemble_candidates
        from .segmentation import top_k_segmentations

        dev, _ = self._setup()
        alloc = provision(db, mcm.class_counts(), ranges, mcm.n_chiplets,
                          metric=cfg.metric,
                          max_nodes_per_model=cfg.max_nodes_per_model)
        models, words, tiers, built = [], [], [], []
        for mi, (s, e) in sorted(ranges.items()):
            with obs.span("window_build", cat="engine", model=mi,
                          layers=e - s):
                segs = top_k_segmentations(db, mcm, s, e, alloc[mi],
                                           k=cfg.seg_top_k, cap=cfg.seg_cap,
                                           metric=cfg.metric)
                cand, tier, (word, chips, seg_arr) = assemble_candidates(
                    mcm, mi, (s, e), segs, prev_end.get(mi),
                    path_cap=cfg.path_cap, frontier_cap=cfg.frontier_cap)
                models.append(model_inputs(db, cand, prev_end.get(mi)))
                words.append(ds.split_words_u32(word))
                tiers.append(tier)
                built.append((cand, chips, seg_arr))
        with obs.span("window_build", cat="engine", models=len(models)):
            # a zero row after the last candidate: the padding rows' words
            words.append(np.zeros((1, words[0].shape[1]), np.uint32))
            tiers.append(np.zeros(1, np.int32))
            arrays, slots = window_arrays(models, mcm.class_map)
            up = platform.device_upload(
                {**arrays, "words": np.concatenate(words).view(np.int32),
                 "tiers": np.concatenate(tiers).astype(np.int32)}, dev)
            batch = WindowBatch(**{k: up[k] for k in arrays}, models=slots,
                                pkg=mcm.pkg, cols=mcm.cols,
                                n_active=len(ranges), rows=mcm.rows,
                                noc=mcm.noc)
            pow10_table(dev, torch.float32)      # the quantiser's table
        n_pad = ds.bucket_size(max(s.n_cand for s in slots))
        return (batch, up["words"], up["tiers"]), built, n_pad

    def combine_window(self, db: CostDB, mcm: MCM, cfg,
                       ranges: dict[int, tuple[int, int]],
                       prev_end: dict[int, int],
                       metric: Optional[str] = None) -> WindowSearchResult:
        metric = metric or cfg.metric
        with obs.span("combine_window", cat="engine", engine="beam_jax",
                      models=len(ranges), beam=self.beam):
            return self._combine_window(db, mcm, cfg, ranges, prev_end,
                                        metric)

    def _combine_window(self, db: CostDB, mcm: MCM, cfg,
                        ranges: dict[int, tuple[int, int]],
                        prev_end: dict[int, int],
                        metric: str) -> WindowSearchResult:
        from . import device_search as ds

        _, use_kernel = self._setup()
        window, built, n_pad = self.window_inputs(db, mcm, cfg, ranges,
                                                  prev_end)
        with obs.span("device_combine", cat="engine", engine="beam_jax",
                      models=len(built), n_pad=n_pad):
            out = ds.fused_program(
                window, beam=self.beam, keep=int(cfg.keep_per_model),
                metric=metric, max_exp=self.max_expansions, n_pad=n_pad,
                use_kernel=use_kernel,
                congestion=self.comm_model == "congestion")
            # the single counted host transfer of the whole window search
            (morder, parents, cands, tlats, tes,
             counts, fails) = platform.device_fetch(*out)
        failed = np.flatnonzero(fails)
        if failed.size:
            cand = built[int(morder[int(failed[0])])][0]
            _raise_no_disjoint(cand.model_idx, cand.seg_id.shape[0])
        picks = _backtrack(parents, cands)
        plans = []
        for st in range(len(built)):
            cand, chips, seg_arr = built[int(morder[st])]
            # the scan emits assembled-candidate row indices directly
            r = int(picks[st])
            ns = int(cand.n_segs[r])
            plans.append(ModelWindowPlan(
                model_idx=cand.model_idx, start=cand.start, end=cand.end,
                seg_ends=tuple(int(x) for x in seg_arr[r, :ns]),
                chiplets=tuple(int(c) for c in chips[r, :ns]),
                pipelined=True))
        plan = WindowPlan(plans=tuple(sorted(plans,
                                             key=lambda p: p.model_idx)))
        result = evaluate_window(db, mcm, plan, prev_end, validate=True,
                                 comm_model=self.comm_model)
        return WindowSearchResult(plan=plan, result=result,
                                  explored=_explored(tlats, tes, counts))


# ---------------------------------------------------------------------------
# Evolutionary search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EvolutionaryEngine:
    """(mu + lambda) EA with uniform crossover and overlap-penalty fitness.

    The RNG call sequence is the reference's, so seeded runs follow its
    trajectory exactly; the whole population is scored per generation
    with one ``batched_fitness`` pass.
    """

    population: int = 10
    generations: int = 4
    mutation_rate: float = 0.3
    seed: int = 0
    comm_model: str = "analytic"

    def combine(self, db: CostDB, mcm: MCM, sets: list[ModelCandidateSet],
                prev_end: dict[int, int],
                metric: str = "edp") -> WindowSearchResult:
        rng = np.random.default_rng(self.seed)
        ct = CandidateTensors.from_sets(sets, mcm.n_chiplets)
        n_models = len(sets)
        sizes = np.array([cs.n_cands for cs in sets])
        pop = np.stack([rng.integers(0, sizes)
                        for _ in range(self.population)])
        pop[0] = 0  # seed with per-model greedy best
        explored: list[tuple[float, float]] = []

        outer = obs.span("combine", cat="engine", engine="evolutionary",
                         models=n_models, population=self.population)
        with outer:
            fit, lmax, esum, _ = batched_fitness(ct, pop, metric)
            for gen in range(self.generations):
                with obs.span("ea_generation", cat="engine", generation=gen):
                    children = []
                    for _ in range(self.population):
                        i, j = rng.integers(0, self.population, size=2)
                        a = pop[i] if fit[i] < fit[j] else pop[j]
                        p, q = rng.integers(0, self.population, size=2)
                        b = pop[p] if fit[p] < fit[q] else pop[q]
                        xover = rng.random(n_models) < 0.5
                        child = np.where(xover, a, b)
                        mut = rng.random(n_models) < self.mutation_rate
                        child = np.where(mut, rng.integers(0, sizes), child)
                        children.append(child)
                    cpop = np.stack(children)
                    cfit, clmax, cesum, _ = batched_fitness(ct, cpop, metric)
                    allp = np.concatenate([pop, cpop])
                    allf = np.concatenate([fit, cfit])
                    order = np.argsort(allf, kind="stable")[:self.population]
                    pop, fit = allp[order], allf[order]
                    lmax = np.concatenate([lmax, clmax])[order]
                    esum = np.concatenate([esum, cesum])[order]
                    explored.extend(zip(lmax.tolist(), esum.tolist()))

        best = pop[0]
        _, _, _, overlap = batched_fitness(ct, best[None, :], metric)
        if int(overlap[0]) > 0:
            # repair residual overlap greedily via the beam combiner
            res = BeamEngine(comm_model=self.comm_model).combine(
                db, mcm, sets, prev_end, metric=metric)
            res.explored.extend(explored)
            return res

        plan = _plans_from_picks(sets, best)
        result = evaluate_window(db, mcm, plan, prev_end, validate=True,
                                 comm_model=self.comm_model)
        return WindowSearchResult(plan=plan, result=result, explored=explored)


# ---------------------------------------------------------------------------
# Simulated annealing (beyond-paper)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AnnealEngine:
    """Parallel simulated-annealing chains over the candidate tensors.

    ``chains`` independent walkers mutate one model's pick per step; all
    proposals are scored with a single ``batched_fitness`` call per step.
    Chain 0 starts from the per-model greedy best, the rest from random
    picks.  Any residual occupancy overlap is repaired with the beam engine,
    so the result is always a valid window plan.
    """

    iters: int = 200
    chains: int = 24
    temperature: float = 0.05
    seed: int = 0
    comm_model: str = "analytic"

    def combine(self, db: CostDB, mcm: MCM, sets: list[ModelCandidateSet],
                prev_end: dict[int, int],
                metric: str = "edp") -> WindowSearchResult:
        with obs.span("combine", cat="engine", engine="anneal",
                      models=len(sets), chains=self.chains,
                      iters=self.iters):
            return self._combine(db, mcm, sets, prev_end, metric)

    def _combine(self, db: CostDB, mcm: MCM, sets: list[ModelCandidateSet],
                 prev_end: dict[int, int],
                 metric: str = "edp") -> WindowSearchResult:
        rng = np.random.default_rng(self.seed)
        ct = CandidateTensors.from_sets(sets, mcm.n_chiplets)
        n_models = len(sets)
        n_chains = self.chains
        picks = np.stack([rng.integers(0, ct.sizes)
                          for _ in range(n_chains)])
        picks[0] = 0
        fit, lmax, esum, _ = batched_fitness(ct, picks, metric)
        best_picks, best_fit = picks.copy(), fit.copy()
        explored: list[tuple[float, float]] = list(
            zip(lmax.tolist(), esum.tolist()))
        rows = np.arange(n_chains)
        for it in range(self.iters):
            with obs.span("anneal_iter", cat="engine", iter=it):
                t = self.temperature * (1.0 - it / max(1, self.iters))
                col = rng.integers(0, n_models, size=n_chains)
                new_val = rng.integers(0, ct.sizes[col])
                prop = picks.copy()
                prop[rows, col] = new_val
                pfit, plm, pes, _ = batched_fitness(ct, prop, metric)
                with np.errstate(over="ignore"):
                    accept = (pfit < fit) | (
                        rng.random(n_chains)
                        < np.exp(-(pfit / fit - 1.0) / max(t, 1e-9)))
                picks = np.where(accept[:, None], prop, picks)
                fit = np.where(accept, pfit, fit)
                improved = fit < best_fit
                best_picks = np.where(improved[:, None], picks, best_picks)
                best_fit = np.where(improved, fit, best_fit)
                _ANNEAL_PROPOSED.inc(n_chains)
                _ANNEAL_ACCEPTED.inc(int(np.count_nonzero(accept)))
                explored.extend(zip(plm[accept].tolist(),
                                    pes[accept].tolist()))

        best = best_picks[int(np.argmin(best_fit))]
        _, _, _, overlap = batched_fitness(ct, best[None, :], metric)
        if int(overlap[0]) > 0:
            res = BeamEngine(comm_model=self.comm_model).combine(
                db, mcm, sets, prev_end, metric=metric)
            res.explored.extend(explored)
            return res
        plan = _plans_from_picks(sets, best)
        result = evaluate_window(db, mcm, plan, prev_end, validate=True,
                                 comm_model=self.comm_model)
        return WindowSearchResult(plan=plan, result=result, explored=explored)


def get_engine(cfg, seed: int = 0,
               device: Optional[str | torch.device] = None) -> SearchEngine:
    """Engine factory keyed on ``SearchConfig.algo``.

    ``brute`` and ``beam`` select the host ``BeamEngine``, ``beam_jax`` the
    ``DeviceBeamEngine`` on ``device``, ``evolutionary`` and ``anneal``
    the host stochastic engines.  ``seed`` is the per-window seed
    (``cfg.seed + window_index``) so the stochastic engines decorrelate
    across windows, as in the reference.

    The ``SCAR_SEARCH_BACKEND`` env var overrides the beam-family choice
    (``brute``/``beam`` -> host, ``beam_jax`` -> device), as in the
    reference, and is ignored for the stochastic engines, whose
    trajectories are algorithm-specific; an unknown name raises
    ``KeyError``.
    """
    algo = cfg.algo
    comm_model = getattr(cfg, "comm_model", "analytic")
    env = os.environ.get("SCAR_SEARCH_BACKEND", "").strip()
    if env and algo in ("brute", "beam", "beam_jax"):
        algo = env
    if algo in ("brute", "beam"):
        return BeamEngine(beam=cfg.beam, comm_model=comm_model)
    if algo == "beam_jax":
        return DeviceBeamEngine(beam=cfg.beam, comm_model=comm_model,
                                device=device)
    if algo == "evolutionary":
        return EvolutionaryEngine(population=cfg.ea_population,
                                  generations=cfg.ea_generations,
                                  seed=seed, comm_model=comm_model)
    if algo == "anneal":
        return AnnealEngine(iters=cfg.anneal_iters,
                            chains=cfg.anneal_chains,
                            temperature=cfg.anneal_temperature,
                            seed=seed, comm_model=comm_model)
    raise KeyError(f"unknown search algo {algo!r}; "
                   "have brute|beam|beam_jax|evolutionary|anneal")
