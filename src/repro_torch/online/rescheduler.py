"""Incremental re-scheduling at epoch boundaries (warm) + cold oracle.

``Rescheduler`` answers one query: *given the tenants active after this
arrival/departure epoch and where the persisting ones left their
activations, what is the package schedule from the current window boundary
onward?*  Two modes sharing identical planning semantics:

* ``warm`` — the production path.  Reuses every per-process cache across
  epochs (CostDB memo, frontier-path LRU), memoises candidate sets and
  window search results on their exact subproblem (``scheduler.schedule``'s
  ``window_memo``), and short-circuits whole re-plans when an
  (active-set, anchors) state recurs — datacenter churn over a finite model
  zoo revisits mixes constantly.
* ``cold`` — the oracle.  Clears every cache (``scheduler.clear_caches``)
  and re-plans from scratch each epoch.  Note the cleared caches are
  process-global, so don't interleave cold replays with unrelated
  scheduling work that wants warm caches in the same process.

The anchors are computed here (tenant-id-keyed) and fed straight to
``scheduler.schedule(prev_end=...)`` — one code path for memo key and plan
input.  ``scheduler.schedule_incremental`` is the standalone
"prior Schedule + changed model set" wrapper for external callers.

Because the planner is a deterministic pure function of
(active set, anchors, MCM, config), every warm reuse returns a plan
bit-identical to what the cold oracle recomputes — pinned per-epoch by
``tests/test_torch_online.py`` (and on the card by ``chip_smoke.py``).
The candidate evaluator backend (``SearchConfig.eval_backend``;
``repro_torch.core.evaluator``) and the search engine are part of that
config identity, so warm/cold parity holds per backend.  The built CUDA
kernels, which ``clear_caches`` leaves loaded (they are not a SCAR
planning cache), amortise across epochs; every planning cache, the
device-resident ones included, is dropped.

Each re-planner plans on one ``device`` (``schedule(..., device=)``):
CUDA unless the caller asks for the CPU, raising without a card.  A
re-plan's wall time covers its device work: every re-plan ends in the
counted ``device_fetch`` of its last scoring batch (``beam``) or window
(``beam_jax``), and the float64 accounting after it runs on the host.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.chiplet import MCM
from repro_torch.core.modelzoo import get_model
from repro_torch.core.scheduler import (ScheduleOutcome, SearchConfig,
                                        clear_caches, final_anchors,
                                        schedule)
from repro_torch.core.workload import Scenario
from repro_torch.launch.platform import resolve_device

# One running tenant: (tenant id, model name, batch).
Tenant = tuple[int, str, int]

# Whole-replan memo accounting (always-on; the window/candidate memos inside
# ``scheduler.schedule`` have their own ``window_memo.*`` counters).
_PLAN_HIT = obs.counter("online.replan.memo_hit")
_PLAN_MISS = obs.counter("online.replan.memo_miss")
_SWITCHES = obs.counter("online.reconfig.switches")


def active_scenario(tenants: list[Tenant]) -> tuple[Scenario, list[int]]:
    """Canonical Scenario for an active tenant set.

    Tenants are ordered by (model, batch, tenant id) and the scenario is
    named after the (model, batch) multiset only, so recurring mixes hit the
    same CostDB cache entry regardless of which tenant ids compose them.
    Returns the scenario plus the tenant id at each model index.
    """
    order = sorted(tenants, key=lambda tn: (tn[1], tn[2], tn[0]))
    mix = ",".join(f"{name}x{batch}" for _, name, batch in order)
    sc = Scenario(f"online[{mix}]",
                  tuple(get_model(name, batch) for _, name, batch in order))
    return sc, [tid for tid, _, _ in order]


@dataclasses.dataclass
class ReplanRecord:
    """One epoch's re-plan: the outcome plus how it was produced."""

    outcome: ScheduleOutcome
    tenant_order: list[int]            # tenant id per model index
    anchors: dict[int, int]            # tenant id -> carried chiplet
    wall_s: float                      # planner wall time (0-ish on memo hit)
    memo_hit: bool
    pattern: Optional[str] = None      # MCM pattern the plan targets (set by
    #                                    SLORescheduler; None on the base)
    switched: bool = False             # did this epoch reconfigure the MCM?


class Rescheduler:
    """Stateful epoch-boundary re-planner for one (MCM, SearchConfig)."""

    def __init__(self, mcm: MCM, cfg: Optional[SearchConfig] = None,
                 mode: str = "warm", plan_memo_max: int = 256, *,
                 device: Optional[str | torch.device] = None):
        if mode not in ("warm", "cold"):
            raise KeyError(f"unknown rescheduler mode {mode!r}")
        self.device = resolve_device(device)
        self.mcm = mcm
        self.cfg = cfg or SearchConfig()
        self.mode = mode
        self._plan_memo: collections.OrderedDict[tuple, ScheduleOutcome] = \
            collections.OrderedDict()
        self._plan_memo_max = plan_memo_max
        self._window_memo: dict = {}
        self._last: Optional[ReplanRecord] = None

    # ---- epoch state ------------------------------------------------------
    def carried_anchors(self, tenants: list[Tenant]) -> dict[int, int]:
        """Tenant id -> chiplet anchor from the previous epoch's plan, for
        the tenants of ``tenants`` that persisted across the boundary."""
        if self._last is None:
            return {}
        prior_final = final_anchors(self._last.outcome)
        prior_idx = {tid: mi
                     for mi, tid in enumerate(self._last.tenant_order)}
        out = {}
        for tid, _, _ in tenants:
            mi = prior_idx.get(tid)
            if mi is not None and mi in prior_final:
                out[tid] = prior_final[mi]
        return out

    # ---- the query --------------------------------------------------------
    def replan(self, tenants: list[Tenant],
               anchors: Optional[dict[int, int]] = None,
               slo_of: Optional[dict[int, str]] = None,
               commit: bool = True) -> ReplanRecord:
        """Plan the new active set from the current window boundary.

        ``anchors`` (tenant id -> chiplet) overrides the carried anchors:
        ``SLORescheduler`` passes ``{}`` to score reconfiguration
        candidates anchor-free (a reconfigured package reloads from DRAM).
        The preemptive simulator never needs an override — a preempted
        iteration's deferred chunks finish on their original placement, so
        the prior plan's ``final_anchors`` remain the true data-locality
        state by the time the tenant is served under the new plan.
        ``commit=False`` runs the same memoised planning query without
        recording it as this re-scheduler's serving state — how the
        SLO-aware layer scores reconfiguration candidates without corrupting
        their epoch history.  ``slo_of`` (tenant id -> class name) is unused
        by the class-blind base planner; ``SLORescheduler`` consumes it.
        """
        del slo_of  # class-blind base: plan identity ignores classes
        sc, tenant_order = active_scenario(tenants)
        if anchors is None:
            anchors = self.carried_anchors(tenants)
        carried = {mi: anchors[tid] for mi, tid in enumerate(tenant_order)
                   if tid in anchors}
        key = (sc.name, tuple(sorted(carried.items())))
        t0 = time.perf_counter()
        hit = self.mode == "warm" and key in self._plan_memo
        (_PLAN_HIT if hit else _PLAN_MISS).inc()
        with obs.span("replan", cat="online", tenants=len(tenants),
                      mode=self.mode, memo_hit=hit):
            if hit:
                outcome = self._plan_memo[key]
                self._plan_memo.move_to_end(key)
            else:
                if self.mode == "cold":
                    clear_caches()
                    self._window_memo.clear()
                elif len(self._window_memo) > 20000:
                    # bound memory on endless traces
                    self._window_memo.clear()
                outcome = schedule(
                    sc, self.mcm, self.cfg, prev_end=carried,
                    window_memo=(self._window_memo
                                 if self.mode == "warm" else None),
                    device=self.device)
                if self.mode == "warm":
                    self._plan_memo[key] = outcome
                    while len(self._plan_memo) > self._plan_memo_max:
                        self._plan_memo.popitem(last=False)
        rec = ReplanRecord(outcome=outcome, tenant_order=tenant_order,
                           anchors=anchors,
                           wall_s=time.perf_counter() - t0, memo_hit=hit)
        if commit:
            self._last = rec
        return rec

    def reset(self) -> None:
        """Forget epoch state (prior plan + memos), keep mode/config."""
        self._plan_memo.clear()
        self._window_memo.clear()
        self._last = None


def _pattern_of(mcm: MCM) -> str:
    """MCM pattern name (``make_mcm`` names packages ``<pattern>_RxC``)."""
    name = mcm.name
    if "_" in name and name.rsplit("_", 1)[1].count("x") == 1:
        return name.rsplit("_", 1)[0]
    return name


class SLORescheduler:
    """SLO-aware epoch re-planner: class-weighted trace-driven MCM
    reconfiguration over a small candidate pattern set.

    The paper's core premise is that the heterogeneous reconfiguration
    pattern should track the workload; the online layer freezes it for a
    whole trace.  This planner keeps one warm ``Rescheduler`` per candidate
    pattern (all sharing the per-process content-keyed CostDB memo, so
    switching back to a previously-served pattern reuses its warm caches —
    the same affinity machinery the portfolio exploits) and, each committed
    epoch, scores the current pattern's plan against every candidate's
    anchor-free plan under the class-weighted objective
    (``slo.class_weighted_score``).  It reconfigures when the projected
    relative gain clears ``hysteresis``:

        switch  iff  best_candidate_score < current_score * (1 - hysteresis)

    Candidates are scored *without* data-locality anchors — a reconfigured
    package reloads every tenant from DRAM, so the switch pays its real
    cost inside the comparison, a natural extra hysteresis.  On a switch
    the returned plan carries no anchors and ``switched=True``.

    ``hysteresis=inf`` (the default) never evaluates candidates at all:
    behaviour, caches and wall time are *identical* to the fixed-pattern
    ``Rescheduler`` — the differential reduction pinned by
    ``tests/test_torch_online_slo.py``.
    """

    def __init__(self, mcm: MCM, cfg: Optional[SearchConfig] = None,
                 mode: str = "warm", plan_memo_max: int = 256,
                 patterns: tuple[str, ...] = (),
                 hysteresis: float = float("inf"), *,
                 device: Optional[str | torch.device] = None):
        from repro_torch.core.chiplet import make_mcm
        self.device = resolve_device(device)
        self.cfg = cfg or SearchConfig()
        self.mode = mode
        self.hysteresis = float(hysteresis)
        base = _pattern_of(mcm)
        self.patterns = tuple(dict.fromkeys((base,) + tuple(patterns)))
        n_pe = mcm.classes[0].n_pe
        self._planners: dict[str, Rescheduler] = {
            base: Rescheduler(mcm, cfg=self.cfg, mode=mode,
                              plan_memo_max=plan_memo_max,
                              device=self.device)}
        for pat in self.patterns[1:]:
            self._planners[pat] = Rescheduler(
                make_mcm(pat, rows=mcm.rows, cols=mcm.cols, n_pe=n_pe),
                cfg=self.cfg, mode=mode, plan_memo_max=plan_memo_max,
                device=self.device)
        self.pattern = base
        self.n_switches = 0
        self.switch_log: list[tuple[str, str]] = []   # (from, to) per switch

    @property
    def mcm(self) -> MCM:
        return self._planners[self.pattern].mcm

    def carried_anchors(self, tenants: list[Tenant]) -> dict[int, int]:
        return self._planners[self.pattern].carried_anchors(tenants)

    @staticmethod
    def _score(rec: ReplanRecord, slo_of: dict[int, str],
               metric: str) -> float:
        from .slo import class_weighted_score
        pml: dict[int, float] = {}
        for wr in rec.outcome.result.windows:
            for mi, v in wr.per_model_latency.items():
                pml[mi] = pml.get(mi, 0.0) + v
        slo_of_model = {mi: slo_of.get(tid)
                        for mi, tid in enumerate(rec.tenant_order)}
        return class_weighted_score(pml, rec.outcome.result.energy,
                                    slo_of_model, metric=metric)

    def replan(self, tenants: list[Tenant],
               anchors: Optional[dict[int, int]] = None,
               slo_of: Optional[dict[int, str]] = None,
               commit: bool = True) -> ReplanRecord:
        """Plan on the current pattern, then consider reconfiguring."""
        cur = self._planners[self.pattern]
        rec = cur.replan(tenants, anchors=anchors, commit=commit)
        rec.pattern = self.pattern
        if (not commit or len(self.patterns) < 2
                or not math.isfinite(self.hysteresis)):
            return rec
        slo_of = slo_of or {}
        cur_score = self._score(rec, slo_of, self.cfg.metric)
        best_pat, best_rec, best_score, extra_wall = None, None, None, 0.0
        with obs.span("reconfig_score", cat="online",
                      current=self.pattern,
                      candidates=len(self.patterns) - 1):
            for pat in self.patterns:
                if pat == self.pattern:
                    continue
                alt = self._planners[pat].replan(tenants, anchors={},
                                                 commit=False)
                extra_wall += alt.wall_s
                score = self._score(alt, slo_of, self.cfg.metric)
                if best_score is None or score < best_score:
                    best_pat, best_rec, best_score = pat, alt, score
        # epoch planning wall = current-pattern plan + every candidate
        # scored (the winner's scoring wall is already inside extra_wall;
        # a switch's commit re-plan is a memo hit costing ~0)
        total_wall = rec.wall_s + extra_wall
        if (best_score is not None and cur_score > 0
                and best_score < cur_score * (1.0 - self.hysteresis)):
            self.switch_log.append((self.pattern, best_pat))
            self.n_switches += 1
            _SWITCHES.inc()
            obs.event("reconfig", cat="online", from_pattern=self.pattern,
                      to_pattern=best_pat)
            self.pattern = best_pat
            # commit the winning plan as the new pattern's serving state
            # (memo hit: the scoring pass just planned this exact query)
            rec = self._planners[best_pat].replan(tenants, anchors={},
                                                  commit=True)
            rec.pattern = best_pat
            rec.switched = True
            rec.memo_hit = best_rec.memo_hit   # scoring did the real work
            total_wall += rec.wall_s
        rec.wall_s = total_wall
        return rec

    def reset(self) -> None:
        for planner in self._planners.values():
            planner.reset()
        self.pattern = self.patterns[0]
        self.n_switches = 0
        self.switch_log.clear()
