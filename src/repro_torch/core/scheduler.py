"""End-to-end SCAR scheduler (Fig. 3 framework flow).

Pipeline per scenario x MCM x optimisation target:
  MCM-Reconfig (windows, greedy packing) -> per window: PROV (Eq. 2) ->
  SEG (Heuristic 1 top-k) -> SCHED (tree search / EA) -> scored schedule.

Also provides the paper's two baselines: ``standalone`` (one chiplet per
model, no pipelining) and Simba-like pipelining (= the full scheduler on a
homogeneous MCM; just pass a homogeneous pattern).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import os
import pickle
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.launch.platform import resolve_device

from .chiplet import MCM, make_mcm
from .cost import (ModelWindowPlan, ScheduleResult, WindowPlan,
                   check_comm_model, evaluate_schedule, n_interposer_links,
                   plan_link_bytes)
from .maestro import CostDB, build_cost_db
from .engine import WindowSearchResult, get_engine
from .reconfig import WindowAssignment, greedy_pack, uniform_pack
from .provision import provision
from .sched import build_candidates
from .segmentation import top_k_segmentations
from .workload import Scenario


@dataclasses.dataclass
class SearchConfig:
    metric: str = "edp"                 # latency | energy | edp
    n_splits: int = 4                   # paper default (5 windows)
    packing: str = "greedy"             # greedy | uniform (ablation)
    algo: str = "brute"                 # brute|beam (host numpy BeamEngine)
    #                                     | beam_jax (fused device search,
    #                                     DeviceBeamEngine; the reference's
    #                                     name) | evolutionary | anneal
    seg_top_k: int = 4
    seg_cap: int = 512
    path_cap: int = 128
    frontier_cap: Optional[int] = None  # path-builder frontier bound (None =
    #                                     paths.DEFAULT heuristic; large
    #                                     meshes stratified-sample above it)
    keep_per_model: int = 48
    beam: int = 48
    max_nodes_per_model: Optional[int] = 6   # Heuristic 2 user cap
    ea_population: int = 10             # paper Sec. V-A
    ea_generations: int = 4
    anneal_iters: int = 200             # algo="anneal" knobs (beyond-paper);
    anneal_chains: int = 48             # tuned on 6x6/8x8 dc4 via
    anneal_temperature: float = 0.05    # bench_engine_comparison: 48 chains
    #                                     edges out 24 at modest cost; more
    #                                     iters / hotter chains don't pay
    seed: int = 0
    refine_iters: int = 0               # beyond-paper anneal refinement
    #                                     (core.refine)
    eval_backend: str = "auto"          # candidate evaluator backend
    #                                     (repro_torch.core.evaluator): torch
    #                                     float64 oracle | torch_ref plain
    #                                     float32 | cuda kernel; "auto" keeps
    #                                     small batches on the oracle and
    #                                     routes large ones (16x16
    #                                     path_cap=1024 territory) through
    #                                     the kernel on a GPU
    comm_model: str = "analytic"        # analytic (paper hop geometry) |
    #                                     congestion (routed interposer-link
    #                                     occupancy, MCM.noc bandwidths,
    #                                     congestion-aware candidate scoring;
    #                                     see cost.congestion_correction)


@dataclasses.dataclass
class ScheduleOutcome:
    scenario: str
    mcm: str
    config: SearchConfig
    result: ScheduleResult
    windows: list[WindowSearchResult]
    assignment: WindowAssignment
    explored: list[tuple[float, float]]   # (lat, energy) cloud across windows

    @property
    def edp(self) -> float:
        return self.result.edp


# Per-process CostDB memo.  LRU-bounded so long online traces (one distinct
# active set per churn epoch) can't grow it without bound.  Hit/miss
# accounting lives in the telemetry registry (repro_torch.obs) alongside the
# window-memo, candidate-memo and frontier-path counters.
_DB_CACHE: "collections.OrderedDict[tuple, CostDB]" = collections.OrderedDict()
_DB_CACHE_MAX = 128
_DB_HIT = obs.counter("costdb.cache_hit")
_DB_MISS = obs.counter("costdb.cache_miss")
_DB_DISK_HIT = obs.counter("costdb.disk_hit")
_DB_DISK_MISS = obs.counter("costdb.disk_miss")

# Salt of the on-disk CostDB cache's file key: the package that wrote the
# pickle and the layout version.  A directory shared with the JAX reference
# (the same ``SCAR_COSTDB_CACHE``) then never hands one package the other's
# pickle; bump the version when the cost model or the CostDB layout changes.
_COSTDB_DISK_SALT = ("repro_torch", 1)


def costdb_cache_dir() -> Optional[str]:
    """Shared on-disk CostDB cache directory (``SCAR_COSTDB_CACHE``).

    Unset (the default) disables the disk layer.  When set, cost databases
    are pickled under the directory keyed by a content hash of
    ``cost_db_key`` and ``_COSTDB_DISK_SALT``, so processes that build the
    same CostDB share it.  The directory is user-managed: safe to delete at
    any time, and to be wiped when switching versions whose cost model
    differs (the salt guards the package and the layout only).
    """
    d = os.environ.get("SCAR_COSTDB_CACHE", "").strip()
    return d or None


def _disk_cache_path(cache_dir: str, key: tuple) -> str:
    digest = hashlib.sha256(
        repr((_COSTDB_DISK_SALT, key)).encode()).hexdigest()[:32]
    return os.path.join(cache_dir, f"costdb_{digest}.pkl")


def _disk_cache_load(path: str) -> Optional[CostDB]:
    try:
        with open(path, "rb") as fh:
            db = pickle.load(fh)
    except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
            ImportError):
        return None
    return db if isinstance(db, CostDB) else None


def _disk_cache_store(path: str, db: CostDB) -> None:
    # atomic publish (tmp + rename): processes racing on one key never
    # expose a torn file
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=".costdb_tmp_")
    try:
        with os.fdopen(fd, "wb") as fh:
            pickle.dump(db, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
_CAND_HIT = obs.counter("candidates.cache_hit")
_CAND_MISS = obs.counter("candidates.cache_miss")
_WIN_HIT = obs.counter("window_memo.cache_hit")
_WIN_MISS = obs.counter("window_memo.cache_miss")


def cost_db_key(sc: Scenario, mcm: MCM) -> tuple:
    """Cache identity of a (scenario, MCM) cost database.

    Content-based, so identical model mixes share an entry regardless of
    object identity.
    """
    return (sc.name,
            tuple((m.name, len(m.layers), m.batch) for m in sc.models),
            tuple((c.dataflow.value, c.n_pe) for c in mcm.classes),
            mcm.pkg)  # PackageParams is frozen -> hashable


def get_cost_db(sc: Scenario, mcm: MCM) -> CostDB:
    """Memoised ``build_cost_db`` keyed on ``cost_db_key`` (LRU-bounded).

    With ``SCAR_COSTDB_CACHE`` set, a process-shared disk layer sits under
    the in-memory LRU: a miss first tries the pickled store and builds only
    on a double miss, then publishes atomically for other processes
    (``costdb.disk_hit`` / ``costdb.disk_miss`` count the layer).
    """
    key = cost_db_key(sc, mcm)
    if key not in _DB_CACHE:
        _DB_MISS.inc()
        cache_dir = costdb_cache_dir()
        db = None
        if cache_dir:
            path = _disk_cache_path(cache_dir, key)
            db = _disk_cache_load(path)
            (_DB_DISK_HIT if db is not None else _DB_DISK_MISS).inc()
        if db is None:
            with obs.span("costdb_build", cat="scheduler", scenario=sc.name,
                          mcm=mcm.name):
                db = build_cost_db(sc, mcm.classes, mcm.pkg)
            if cache_dir:
                _disk_cache_store(path, db)
        _DB_CACHE[key] = db
        while len(_DB_CACHE) > _DB_CACHE_MAX:
            _DB_CACHE.popitem(last=False)
    else:
        _DB_HIT.inc()
        _DB_CACHE.move_to_end(key)
    return _DB_CACHE[key]


def clear_caches() -> None:
    """Drop every per-process scheduling cache.

    The CostDB memo, the frontier-path LRU and the device-resident tables
    kept between calls (the quantiser's powers of ten,
    ``quantize.pow10_table``).  This is what the online re-scheduler's
    ``cold`` oracle calls before each epoch so its re-plan really is a
    from-scratch re-schedule.  The registry-backed cache counters
    (``obs.cache_stats()``, the disk layer's too) reset with the caches, so
    hit rates always describe the caches' current lifetime.  The built CUDA
    kernels stay loaded: they are not a planning cache.
    """
    from .paths import path_cache_clear
    from .quantize import pow10_table_clear
    _DB_CACHE.clear()
    path_cache_clear()
    pow10_table_clear()
    for c in (_DB_HIT, _DB_MISS, _DB_DISK_HIT, _DB_DISK_MISS,
              _CAND_HIT, _CAND_MISS, _WIN_HIT, _WIN_MISS):
        c.reset()


def build_window_sets(db: CostDB, mcm: MCM, cfg: SearchConfig,
                      ranges: dict[int, tuple[int, int]],
                      prev_end: dict[int, int],
                      memo: Optional[dict] = None,
                      memo_base: Optional[tuple] = None, *,
                      device: torch.device) -> list:
    """PROV + SEG + candidate construction for one window.

    The stage feeding the search engine, shared by ``schedule`` and the
    tests so they exercise the exact production pipeline.  Candidate
    scoring runs on ``device``.

    ``memo`` (with ``memo_base`` identifying the (scenario, MCM, config,
    device)) memoises each model's candidate set on its exact subproblem —
    window range, provisioned nodes, active-model count, locality anchor —
    which fully determines it, so a hit returns bit-identical candidates.

    Under ``cfg.comm_model="congestion"`` candidate scoring is placement
    co-searched: models are processed in index order, each scored against
    the link-byte occupancy of the earlier models' greedy-best plans
    (``cost.plan_link_bytes``), so later tenants are priced for routing
    over the interposer links earlier tenants already load.  The memo key
    then includes that background, which is itself a pure function of the
    window subproblem.
    """
    alloc = provision(db, mcm.class_counts(), ranges, mcm.n_chiplets,
                      metric=cfg.metric,
                      max_nodes_per_model=cfg.max_nodes_per_model)
    sets = []
    n_active = len(ranges)
    congestion = cfg.comm_model == "congestion"
    link_occ = (np.zeros(n_interposer_links(mcm.rows, mcm.cols))
                if congestion else None)
    for mi, (s, e) in sorted(ranges.items()):
        key = None
        if memo is not None:
            key = ("cands", memo_base, mi, (s, e), int(alloc[mi]), n_active,
                   prev_end.get(mi))
            if congestion:
                key = key + (link_occ.tobytes(),)
            if key in memo:
                _CAND_HIT.inc()
                cs = memo[key]
                sets.append(cs)
                if congestion:
                    link_occ = link_occ + plan_link_bytes(
                        db, mcm, _greedy_best_plan(cs), prev_end)
                continue
            _CAND_MISS.inc()
        with obs.span("window_build", cat="scheduler", model=mi,
                      layers=e - s):
            segs = top_k_segmentations(db, mcm, s, e, alloc[mi],
                                       k=cfg.seg_top_k, cap=cfg.seg_cap,
                                       metric=cfg.metric)
            cs = build_candidates(
                db, mcm, mi, (s, e), segs, n_active=n_active,
                prev_end=prev_end.get(mi), path_cap=cfg.path_cap,
                keep=cfg.keep_per_model, metric=cfg.metric,
                frontier_cap=cfg.frontier_cap, backend=cfg.eval_backend,
                comm_model=cfg.comm_model, link_occ=link_occ, device=device)
        if key is not None:
            memo[key] = cs
        sets.append(cs)
        if congestion:
            link_occ = link_occ + plan_link_bytes(
                db, mcm, _greedy_best_plan(cs), prev_end)
    return sets


def _greedy_best_plan(cs) -> ModelWindowPlan:
    """Rank-0 candidate of a sorted ``ModelCandidateSet`` as a window plan.

    The placement co-search uses it as the provisional placement whose
    interposer traffic later models are scored against (the fused device
    search picks the same candidate on the device via the packed order
    key).
    """
    k = int(cs.n_segs[0])
    return ModelWindowPlan(
        model_idx=cs.model_idx, start=cs.start, end=cs.end,
        seg_ends=tuple(int(x) for x in cs.seg_arr[0][:k]),
        chiplets=tuple(int(c) for c in cs.chips[0][:k]))


def check_config(cfg: SearchConfig, prev_end=None) -> None:
    """Raise for a configuration the reference refuses too.

    Unknown engines (``KeyError``) and comm models (``ValueError``), and,
    as the reference does, ``refine_iters`` with warm-start anchors
    (``NotImplementedError``).
    """
    get_engine(cfg)
    check_comm_model(cfg.comm_model)
    if cfg.refine_iters > 0 and prev_end:
        raise NotImplementedError(
            "refine_iters does not support warm-start anchors yet")


def schedule(sc: Scenario, mcm: MCM,
             cfg: Optional[SearchConfig] = None, *,
             db: Optional[CostDB] = None,
             prev_end: Optional[dict[int, int]] = None,
             window_memo: Optional[dict] = None,
             device: Optional[torch.device | str] = None) -> ScheduleOutcome:
    """Run the full SCAR pipeline and return the optimised schedule.

    ``device`` is where candidate scoring runs: CUDA by default (raising
    when there is none), the CPU only when asked for.  ``prev_end`` seeds
    the cross-window data-locality anchors before the first window (model
    index -> chiplet), as the online re-scheduler does.  ``db`` bypasses
    the per-process CostDB memo.  ``window_memo``, when given, is a dict
    reused across calls: window search results are memoised on the exact
    window subproblem (ranges + the anchors visible to it + config), which
    is a pure function of those inputs, so memoised plans are bit-identical
    to recomputed ones (see ``schedule_incremental``).
    """
    cfg = cfg or SearchConfig()
    check_config(cfg, prev_end)
    dev = resolve_device(device)
    with obs.span("schedule", cat="scheduler", scenario=sc.name,
                  mcm=mcm.name, algo=cfg.algo, metric=cfg.metric,
                  device=str(dev)):
        return _schedule_inner(sc, mcm, cfg, db=db, prev_end=prev_end,
                               window_memo=window_memo, device=dev)


def _schedule_inner(sc: Scenario, mcm: MCM, cfg: SearchConfig, *,
                    db: Optional[CostDB],
                    prev_end: Optional[dict[int, int]],
                    window_memo: Optional[dict],
                    device: torch.device) -> ScheduleOutcome:
    """Body of ``schedule`` (split out so the whole run sits in one span)."""
    if db is None:
        db = get_cost_db(sc, mcm)
    counts = mcm.class_counts()
    if cfg.packing == "greedy":
        wa = greedy_pack(db, counts, cfg.n_splits)
    elif cfg.packing == "uniform":
        wa = uniform_pack(db, cfg.n_splits)
    else:
        raise KeyError(cfg.packing)

    # memo identity must cover the package topology too: two patterns can
    # share a CostDB (same class set + pkg) yet place classes differently
    memo_base = (cost_db_key(sc, mcm), mcm.rows, mcm.cols,
                 tuple(mcm.class_map), _cfg_key(cfg), str(device)) \
        if window_memo is not None else None
    window_results: list[WindowSearchResult] = []
    anchors: dict[int, int] = dict(prev_end or {})
    explored: list[tuple[float, float]] = []
    for w, ranges in enumerate(wa.ranges):
        key = None
        if memo_base is not None:
            # a window result depends on anchors only through the models it
            # actually places, so restrict the key to those
            vis = tuple(sorted((mi, anchors[mi]) for mi in ranges
                               if mi in anchors))
            key = (memo_base, w, tuple(sorted(
                (mi, s, e) for mi, (s, e) in ranges.items())), vis)
        if key is not None and key in window_memo:
            _WIN_HIT.inc()
            wr = window_memo[key]
        else:
            if key is not None:
                _WIN_MISS.inc()
            with obs.span("window_combine", cat="scheduler", window=w,
                          models=len(ranges)):
                engine = get_engine(cfg, seed=cfg.seed + w, device=device)
                if hasattr(engine, "combine_window"):
                    # fused device path: PROV + SEG + candidate construction
                    # stay on the host; scoring, ordering, beam combination
                    # and top-k run on the device with a single fetch per
                    # window (engine.DeviceBeamEngine.combine_window)
                    wr = engine.combine_window(db, mcm, cfg, ranges, anchors,
                                               metric=cfg.metric)
                else:
                    sets = build_window_sets(db, mcm, cfg, ranges, anchors,
                                             memo=window_memo,
                                             memo_base=memo_base,
                                             device=device)
                    wr = engine.combine(db, mcm, sets, anchors,
                                        metric=cfg.metric)
            if key is not None:
                window_memo[key] = wr
        window_results.append(wr)
        explored.extend(wr.explored)
        anchors = dict(anchors)
        anchors.update(wr.result.end_chiplet)

    with obs.span("evaluate_schedule", cat="scheduler",
                  windows=len(window_results)):
        result = evaluate_schedule(db, mcm,
                                   [wr.plan for wr in window_results],
                                   validate=True, prev_end=prev_end,
                                   comm_model=cfg.comm_model)
    outcome = ScheduleOutcome(scenario=sc.name, mcm=mcm.name, config=cfg,
                              result=result, windows=window_results,
                              assignment=wa, explored=explored)
    if cfg.refine_iters > 0:
        from .refine import refine  # local import: refine uses this module
        outcome = refine(sc, mcm, outcome, metric=cfg.metric,
                         iters=cfg.refine_iters, seed=cfg.seed,
                         backend=cfg.eval_backend,
                         comm_model=cfg.comm_model, device=device)
    return outcome


def _cfg_key(cfg: SearchConfig) -> tuple:
    """Hashable identity of every field that shapes a window search."""
    return tuple(getattr(cfg, f.name) for f in dataclasses.fields(cfg))


def final_anchors(outcome: ScheduleOutcome) -> dict[int, int]:
    """Model index -> chiplet its last window segment ended on.

    The data-locality state at the schedule's final window boundary.
    """
    anchors: dict[int, int] = {}
    for wr in outcome.result.windows:
        anchors.update(wr.end_chiplet)
    return anchors


def schedule_incremental(sc: Scenario, mcm: MCM,
                         cfg: Optional[SearchConfig] = None,
                         prior: Optional[ScheduleOutcome] = None,
                         persisting: Optional[dict[int, int]] = None,
                         window_memo: Optional[dict] = None, *,
                         device: Optional[torch.device | str] = None
                         ) -> ScheduleOutcome:
    """Warm-startable re-scheduling entry point for the online subsystem.

    Re-plans scenario ``sc`` (the *changed* active model set) from the
    current window boundary of ``prior``: ``persisting`` maps model indices
    of ``sc`` to the corresponding model indices of the prior schedule's
    scenario, and each persisting model inherits the chiplet it ended on
    (its data-locality anchor), so its first-segment activations are charged
    as on-package transfers instead of DRAM reloads.  ``window_memo``
    (caller-owned, as an online re-scheduler keeps one across epochs) lets
    unchanged window subproblems reuse their search results across epochs;
    results are bit-identical to a from-scratch ``schedule`` call with the
    same anchors because memoised entries are keyed on every input of the
    window search.
    """
    carried: dict[int, int] = {}
    if prior is not None and persisting:
        final = final_anchors(prior)
        carried = {new_mi: final[old_mi]
                   for new_mi, old_mi in persisting.items() if old_mi in final}
    return schedule(sc, mcm, cfg, prev_end=carried, window_memo=window_memo,
                    device=device)


def standalone_schedule(sc: Scenario, mcm: MCM) -> ScheduleOutcome:
    """Baseline: one chiplet per model, single window, no pipelining."""
    db = get_cost_db(sc, mcm)
    ports = mcm.dram_ports()
    order = sorted(range(db.n_models),
                   key=lambda mi: -float(db.lat[db.model_slice(mi), 0].sum()))
    if db.n_models > mcm.n_chiplets:
        raise ValueError("more models than chiplets in standalone mode")
    chosen: list[int] = []
    pool = ports + [c for c in range(mcm.n_chiplets) if c not in ports]
    for mi in order:
        chosen.append(pool[len(chosen)])
    plans = []
    for mi, cid in zip(order, chosen):
        sl = db.model_slice(mi)
        plans.append(ModelWindowPlan(model_idx=mi, start=sl.start,
                                     end=sl.stop, seg_ends=(sl.stop,),
                                     chiplets=(cid,), pipelined=False))
    plan = WindowPlan(plans=tuple(sorted(plans, key=lambda p: p.model_idx)))
    result = evaluate_schedule(db, mcm, [plan], validate=True)
    wa = WindowAssignment(
        ranges=({mi: (db.model_slice(mi).start, db.model_slice(mi).stop)
                 for mi in range(db.n_models)},),
        boundaries=(float("inf"),))
    return ScheduleOutcome(scenario=sc.name, mcm=mcm.name,
                           config=SearchConfig(), result=result,
                           windows=[], assignment=wa,
                           explored=[(result.latency, result.energy)])


def run_config(scenario: Scenario, pattern: str, rows: int = 3, cols: int = 3,
               n_pe: int = 4096, cfg: Optional[SearchConfig] = None,
               standalone: bool = False, *,
               device: Optional[torch.device | str] = None
               ) -> ScheduleOutcome:
    """Convenience wrapper: pattern name -> outcome."""
    mcm = make_mcm(pattern, rows=rows, cols=cols, n_pe=n_pe)
    if standalone:
        return standalone_schedule(scenario, mcm)
    return schedule(scenario, mcm, cfg, device=device)
