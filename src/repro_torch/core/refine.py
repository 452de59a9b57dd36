"""Beyond-paper: local-search refinement of SCAR schedules.

The port of ``repro/core/refine.py``: the same moves, the same numpy RNG
call sequence and the same float64 acceptance, so a seeded refinement
follows the reference's trajectory; the relocate screen scores its targets
through the port's ``core.evaluator.eval_candidates`` on the caller's
device (on a GPU with ``backend="cuda"``, one ``scar_eval`` launch a
screen).

The paper's SCHED engine optimises each time window greedily and constrains
placements to XY-contiguous chiplet paths rooted at DRAM ports — both are
search heuristics, not hardware requirements (the cost model charges hop
distance wherever chiplets sit).  This pass takes the paper-faithful
schedule and applies accept-if-better local moves over the *whole* schedule
(cross-window effects included via data-locality anchors):

  * ``boundary``: shift one model's segment boundary by one layer;
  * ``relocate``: move one segment of one model to the best free chiplet —
    all free targets are scored in one ``eval_candidates`` batched
    pass over the candidate tensors (drops the contiguity heuristic; comm
    costs follow the hop metric);
  * ``rewindow``: move one layer between a model's adjacent windows
    (undoes greedy-packing decisions the per-window search can't);
  * ``decongest`` (congestion model only): relocate a segment of the plan
    loading the window's busiest interposer link.

Simulated-annealing acceptance with a small temperature escapes per-window
local minima; every accept is validated against Theorems 1-2.  Schedule
metrics are maintained *incrementally*: a move touching window ``w`` only
re-evaluates ``w`` plus the windows whose data-locality anchor it feeds,
instead of the whole schedule.
"""
from __future__ import annotations

import dataclasses
import math

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.launch.platform import resolve_device

from .chiplet import MCM
from .cost import (BatchedModelCandidates, ModelWindowPlan, WindowPlan,
                   WindowResult, evaluate_schedule, evaluate_window,
                   link_bandwidths, n_interposer_links, plan_link_bytes)
from .engine import metric_score
from .evaluator import eval_candidates
from .quantize import SCORE_SIG, quantize_scores
from .maestro import CostDB
from .scheduler import ScheduleOutcome, get_cost_db


def _from_window_plans(wps: list[WindowPlan]) -> list[list[ModelWindowPlan]]:
    return [[p for p in wp.plans] for wp in wps]


def _clone_windows(windows: list[list[ModelWindowPlan]]
                   ) -> list[list[ModelWindowPlan]]:
    return [list(ps) for ps in windows]


def _to_plans(windows: list[list[ModelWindowPlan]]) -> list[WindowPlan]:
    return [WindowPlan(plans=tuple(sorted(ps, key=lambda p: p.model_idx)))
            for ps in windows if ps]


@dataclasses.dataclass
class _Move:
    windows: list[list[ModelWindowPlan]]
    touched: tuple[int, ...]                 # window indices with new plans


class _IncrementalEvaluator:
    """Schedule metrics with per-move incremental window re-evaluation.

    A window's result depends only on its own plans and the data-locality
    anchors (``prev_end``) of each of its models, i.e. the *previous* window
    containing that model.  Changing window ``w`` therefore invalidates only
    ``w`` itself and, per model in ``w``, the next window containing that
    model — everything else is served from cache.  Totals are recomputed as
    the same ordered ``float(sum(...))`` as ``evaluate_schedule``, so the
    annealer sees bit-identical metrics at a fraction of the cost.
    """

    def __init__(self, db: CostDB, mcm: MCM,
                 windows: list[list[ModelWindowPlan]],
                 comm_model: str = "analytic"):
        self.db, self.mcm = db, mcm
        self.comm_model = comm_model
        self.results: list[WindowResult] = []
        prev_end: dict[int, int] = {}
        for ps in windows:
            res = evaluate_window(db, mcm, _to_plans([ps])[0], prev_end,
                                  validate=True, comm_model=comm_model)
            self.results.append(res)
            prev_end = dict(prev_end)
            prev_end.update(res.end_chiplet)

    def _affected(self, windows, touched: tuple[int, ...]) -> list[int]:
        aff = set(touched)
        for w in touched:
            for m in {p.model_idx for p in windows[w]}:
                for w2 in range(w + 1, len(windows)):
                    if any(p.model_idx == m for p in windows[w2]):
                        aff.add(w2)
                        break
        return sorted(aff)

    def prev_end_at(self, w: int, results=None) -> dict[int, int]:
        results = self.results if results is None else results
        pe: dict[int, int] = {}
        for i in range(w):
            pe.update(results[i].end_chiplet)
        return pe

    def propose(self, mv: _Move) -> tuple[list[WindowResult], float, float]:
        """Evaluate a move; raises ValueError if any touched plan is invalid."""
        results = list(self.results)
        for w in self._affected(mv.windows, mv.touched):
            plan = _to_plans([mv.windows[w]])[0]
            results[w] = evaluate_window(
                self.db, self.mcm, plan, self.prev_end_at(w, results),
                validate=True, comm_model=self.comm_model)
        lat = float(sum(r.latency for r in results))
        energy = float(sum(r.energy for r in results))
        return results, lat, energy

    def accept(self, results: list[WindowResult]) -> None:
        self.results = results


def _try_boundary(rng, windows, ctx) -> _Move | None:
    w = rng.integers(len(windows))
    ps = windows[w]
    if not ps:
        return None
    i = rng.integers(len(ps))
    p = ps[i]
    if p.n_segments < 2:
        return None
    si = int(rng.integers(p.n_segments - 1))
    delta = int(rng.choice([-1, 1]))
    ends = list(p.seg_ends)
    new_end = ends[si] + delta
    lo = p.start if si == 0 else ends[si - 1]
    if not (lo < new_end < ends[si + 1]):
        return None
    ends[si] = new_end
    new = dataclasses.replace(p, seg_ends=tuple(ends))
    return _Move(_clone_windows_replace(windows, w, i, new), (int(w),))


def _screen_relocate(rng, windows, ctx, w, i, si, free) -> _Move:
    """Batched relocate screening: score every free target in one pass.

    Under ``comm_model="congestion"`` the screen scores each target against
    the *other* window plans' routed byte occupancy, so free chiplets whose
    routes dodge the contended links rank first — the refinement half of
    the placement co-search.
    """
    db, mcm, ev, metric, backend, comm_model, device = ctx
    ps = windows[w]
    p = ps[i]
    n_free = len(free)
    lw = p.end - p.start
    seg_id_row = np.zeros(lw, dtype=np.int64)
    prev = p.start
    for s_idx, e_abs in enumerate(p.seg_ends):
        seg_id_row[prev - p.start:e_abs - p.start] = s_idx
        prev = e_abs
    chips = np.tile(np.asarray(p.chiplets, dtype=np.int64), (n_free, 1))
    chips[:, si] = free
    cand = BatchedModelCandidates(
        model_idx=p.model_idx, start=p.start, end=p.end,
        seg_id=np.tile(seg_id_row, (n_free, 1)), chiplets=chips,
        n_segs=np.full(n_free, p.n_segments, dtype=np.int64),
        seg_ends=np.tile(np.asarray(p.seg_ends, dtype=np.int64),
                         (n_free, 1)))
    pe = ev.prev_end_at(w)
    link_occ = None
    if comm_model == "congestion":
        link_occ = np.zeros(n_interposer_links(mcm.rows, mcm.cols))
        for j, q in enumerate(ps):
            if j != i:
                link_occ += plan_link_bytes(db, mcm, q, pe)
    lat, energy = eval_candidates(
        db, mcm, cand, n_active=len(ps),
        prev_end=pe.get(p.model_idx),
        pipelined=p.pipelined, backend=backend,
        comm_model=comm_model, link_occ=link_occ, device=device)
    # sample among the screened top-k: pure argmin starves the annealer of
    # proposal diversity and gets stuck re-proposing one target.  Scores are
    # quantised to the shared candidate-ordering grain so the screen picks
    # the same top-k set on every evaluator backend (f32 noise absorbed).
    score = quantize_scores(metric_score(lat, energy, metric), sig=SCORE_SIG)
    k = min(4, n_free)
    top = np.argpartition(score, k - 1)[:k]
    pick = int(top[int(rng.integers(k))])
    new_chips = list(p.chiplets)
    new_chips[si] = free[pick]
    new = dataclasses.replace(p, chiplets=tuple(new_chips))
    return _Move(_clone_windows_replace(windows, w, i, new), (w,))


def _try_relocate(rng, windows, ctx) -> _Move | None:
    """Move one segment to the best free chiplet (batched screening).

    Every free target is scored in one vectorized ``eval_candidates``
    pass (backend-selectable; see ``core.evaluator``); the winner
    becomes the proposal, which the annealer still accepts or rejects on the
    exact schedule-level metric.
    """
    db, mcm, ev, metric, backend, comm_model, _ = ctx
    w = int(rng.integers(len(windows)))
    ps = windows[w]
    if not ps:
        return None
    i = int(rng.integers(len(ps)))
    p = ps[i]
    used = {c for q in ps for c in q.chiplets}
    free = [c for c in range(mcm.n_chiplets) if c not in used]
    if not free:
        return None
    si = int(rng.integers(p.n_segments))
    if len(free) <= 4:
        # tiny meshes: batched screening costs more than it saves — keep the
        # seed's random-walk proposal
        new_chips = list(p.chiplets)
        new_chips[si] = int(rng.choice(free))
        new = dataclasses.replace(p, chiplets=tuple(new_chips))
        return _Move(_clone_windows_replace(windows, w, i, new), (w,))
    return _screen_relocate(rng, windows, ctx, w, i, si, free)


def _try_decongest(rng, windows, ctx) -> _Move | None:
    """Congestion-only move: pull traffic off the busiest interposer link.

    Finds the window's bottleneck link (highest background serialization
    time), takes the plan pushing the most bytes over it, and relocates one
    of its segments through the congestion-aware batched screen — a
    directed counterpart to ``_try_relocate``'s random walk.  Only in the
    move mix when ``refine(comm_model="congestion")``.
    """
    db, mcm, ev, metric, backend, comm_model, _ = ctx
    w = int(rng.integers(len(windows)))
    ps = windows[w]
    if len(ps) < 2:
        return None
    pe = ev.prev_end_at(w)
    occs = [plan_link_bytes(db, mcm, q, pe) for q in ps]
    total = np.sum(occs, axis=0)
    if total.size == 0:
        return None
    hot = int(np.argmax(total / link_bandwidths(mcm)))
    contrib = np.array([o[hot] for o in occs])
    if contrib.max() <= 0.0:
        return None  # no interposer traffic anywhere: nothing to move
    i = int(np.argmax(contrib))
    p = ps[i]
    used = {c for q in ps for c in q.chiplets}
    free = [c for c in range(mcm.n_chiplets) if c not in used]
    if not free:
        return None
    si = int(rng.integers(p.n_segments))
    if len(free) <= 4:
        new_chips = list(p.chiplets)
        new_chips[si] = int(rng.choice(free))
        new = dataclasses.replace(p, chiplets=tuple(new_chips))
        return _Move(_clone_windows_replace(windows, w, i, new), (w,))
    return _screen_relocate(rng, windows, ctx, w, i, si, free)


def _try_rewindow(rng, windows, ctx) -> _Move | None:
    """Move one boundary layer between a model's adjacent windows."""
    w = int(rng.integers(len(windows)))
    ps = windows[w]
    if not ps:
        return None
    i = int(rng.integers(len(ps)))
    p = ps[i]
    # find this model's plan in the next window
    for w2 in range(w + 1, len(windows)):
        js = [j for j, q in enumerate(windows[w2])
              if q.model_idx == p.model_idx]
        if js:
            break
    else:
        return None
    j = js[0]
    q = windows[w2][j]
    if q.start != p.end:
        return None  # not adjacent ranges (shouldn't happen)
    if bool(rng.integers(2)):
        # give the last layer of w to w2
        if p.end - p.start < 2:
            return None
        new_p = _shrink_tail(p)
        new_q = _grow_head(q)
    else:
        if q.end - q.start < 2:
            return None
        new_p = _grow_tail(p)
        new_q = _shrink_head(q)
    out = _clone_windows(windows)
    out[w][i] = new_p
    out[w2][j] = new_q
    return _Move(out, (w, w2))


def _shrink_tail(p: ModelWindowPlan) -> ModelWindowPlan:
    ends = [min(e, p.end - 1) for e in p.seg_ends]
    ends[-1] = p.end - 1
    # deduplicate collapsed segments
    ends2, chips2, prev = [], [], p.start
    for e, c in zip(ends, p.chiplets):
        if e > prev:
            ends2.append(e)
            chips2.append(c)
            prev = e
    return dataclasses.replace(p, end=p.end - 1, seg_ends=tuple(ends2),
                               chiplets=tuple(chips2))


def _grow_tail(p: ModelWindowPlan) -> ModelWindowPlan:
    ends = list(p.seg_ends)
    ends[-1] = p.end + 1
    return dataclasses.replace(p, end=p.end + 1, seg_ends=tuple(ends))


def _grow_head(q: ModelWindowPlan) -> ModelWindowPlan:
    return dataclasses.replace(q, start=q.start - 1)


def _shrink_head(q: ModelWindowPlan) -> ModelWindowPlan:
    ends = [e for e in q.seg_ends if e > q.start + 1]
    chips = q.chiplets[len(q.seg_ends) - len(ends):]
    return dataclasses.replace(q, start=q.start + 1, seg_ends=tuple(ends),
                               chiplets=tuple(chips))


def _clone_windows_replace(windows, w, i, new_plan):
    out = _clone_windows(windows)
    out[w][i] = new_plan
    return out


def refine(sc, mcm: MCM, outcome: ScheduleOutcome, metric: str = "edp",
           iters: int = 600, seed: int = 0,
           temperature: float = 0.02,
           backend: str = "auto",
           comm_model: str = "analytic", *,
           device: Optional[str | torch.device] = None) -> ScheduleOutcome:
    """Anneal-refine a schedule; returns an outcome that is never worse.

    ``backend`` selects the relocate-screening evaluator
    (``core.evaluator``) and ``device`` where it runs (CUDA unless the
    caller asks for the CPU); acceptance always uses the exact scalar
    accounting regardless of backend.  ``comm_model`` must match the model
    the schedule was built under: it selects the window evaluation
    (``cost.evaluate_window``) everywhere in the annealer, makes the
    relocate screen congestion-aware, and (under ``"congestion"``) adds the
    directed ``_try_decongest`` move to the mix.
    """
    dev = resolve_device(device)
    db = get_cost_db(sc, mcm)
    rng = np.random.default_rng(seed)
    windows = _from_window_plans([w.plan for w in outcome.windows])
    if not windows:
        return outcome
    # Move accounting: always-on registry counters, one per move kind plus
    # the accepted/rejected totals.
    accepted_c = obs.counter("refine.moves.accepted")
    rejected_c = obs.counter("refine.moves.rejected")
    with obs.span("refine", cat="refine", scenario=outcome.scenario,
                  iters=iters, metric=metric):
        ev = _IncrementalEvaluator(db, mcm, windows, comm_model=comm_model)
        ctx = (db, mcm, ev, metric, backend, comm_model, dev)
        cur_m = metric_score(float(sum(r.latency for r in ev.results)),
                             float(sum(r.energy for r in ev.results)), metric)
        best_windows, best_m = windows, cur_m
        moves = [_try_boundary, _try_relocate, _try_rewindow]
        if comm_model == "congestion":
            moves = moves + [_try_decongest]
        move_counters = {fn: obs.counter(
            "refine.moves." + fn.__name__.removeprefix("_try_"))
            for fn in moves}
        for it in range(iters):
            mv_fn = moves[int(rng.integers(len(moves)))]
            try:
                mv = mv_fn(rng, windows, ctx)
                if mv is None:
                    continue
                results, lat, energy = ev.propose(mv)
            except (ValueError, IndexError):
                continue
            t = temperature * (1.0 - it / iters)
            new_m = metric_score(lat, energy, metric)
            accept = new_m < cur_m or (
                t > 0 and rng.random() < math.exp(-(new_m / cur_m - 1.0)
                                                  / max(t, 1e-9)))
            if accept:
                accepted_c.inc()
                move_counters[mv_fn].inc()
                windows, cur_m = mv.windows, new_m
                ev.accept(results)
                if new_m < best_m:
                    best_windows, best_m = mv.windows, new_m
            else:
                rejected_c.inc()
    final_plans = _to_plans(best_windows)
    final = evaluate_schedule(db, mcm, final_plans, validate=True,
                              comm_model=comm_model)
    wrs = []
    from .engine import WindowSearchResult
    prev_end: dict[int, int] = {}
    for wp in final_plans:
        res = evaluate_window(db, mcm, wp, prev_end, comm_model=comm_model)
        wrs.append(WindowSearchResult(plan=wp, result=res, explored=[]))
        prev_end = dict(prev_end)
        prev_end.update(res.end_chiplet)
    return ScheduleOutcome(scenario=outcome.scenario, mcm=outcome.mcm,
                           config=outcome.config, result=final, windows=wrs,
                           assignment=outcome.assignment,
                           explored=outcome.explored)
