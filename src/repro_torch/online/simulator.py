"""Discrete-event loop: replay a trace against the SCAR scheduler.

Two trace shapes, one entry point (``simulate``):

**Churn** — the active tenant set changes at arrival/departure epochs.  Serving
is iterative: one *iteration* runs every active tenant's model once through
the planned windows (the steady-state serving loop of the static pipeline).
At each epoch boundary the ``Rescheduler`` re-plans from the current window
boundary (persisting tenants keep their data-locality anchors); between
boundaries the epoch's schedule executes back-to-back iterations, accounted
with the exact per-window latencies/energies ``cost.evaluate_schedule``
produced.

How the in-flight iteration at an epoch boundary is handled is the
``OnlinePolicy.boundary`` knob:

* ``instant`` (the PR 3 fluid model, default) — the re-plan takes effect at
  the event time; execution is accounted fractionally
  (``iterations = epoch_duration / schedule_latency``), so nothing ever
  queues and no deadline is ever missed by waiting.
* ``drain``   — iterations are discrete and non-preemptible: the in-flight
  iteration runs to completion before the new plan takes effect, so an
  arriving tenant waits up to one full package iteration (its first
  latency sample includes the queueing delay).  The class-blind realistic
  baseline.
* ``preempt`` — execution is resumable at chunk boundaries
  (``cost.WindowResult.per_model_segments``): at an event, every tenant
  runs to its next chunk boundary; *preemptible* (best-effort) tenants
  then pause — their remaining chunks are deferred and complete under the
  new epoch, work conserved — while non-preemptible tenants finish their
  iteration.  The package switches plans as soon as the slowest of those
  constraints clears, which is never later (and usually far earlier) than
  the drain boundary, so latency-critical arrivals start sooner.

Departure correction (all modes): a tenant's iteration that is still in
flight at its *departure* event is cancelled — it contributes neither a
latency sample nor its share of the iteration's energy.  (The seed online
layer credited the departing tenant with a fractional sample at full
per-iteration latency and charged its full energy share — accounting work
past the departure; ``tests/test_torch_online.py`` pins the correction.)

Data-locality anchors stay consistent across all three modes through
``scheduler.final_anchors``: a preempted tenant's deferred chunks finish
the interrupted iteration on its original placement, so by the time it is
served under the new plan its activations sit exactly where the prior
plan's final anchors say.

**Cadence** — the model set is a fixed AR/VR scenario; the schedule is planned
once and frames replay against its per-model latencies.  Each model serves
its frames FIFO on its own pipeline: a frame arriving at ``t`` starts at
``max(t, previous completion)``, completes ``latency`` later, and misses its
deadline if completion exceeds ``t + deadline``.  Per-frame energy is the
schedule's iteration energy split across models pro rata by their summed
window latency (``replay_cadence`` is a pure function so QoS accounting is
hand-checkable — see ``tests/test_torch_online.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.chiplet import MCM, make_mcm
from repro_torch.core.scheduler import ScheduleOutcome, SearchConfig
from repro_torch.launch.platform import resolve_device

from .rescheduler import Rescheduler, SLORescheduler, Tenant
from .slo import get_slo
from .traces import Trace


def per_model_latency(outcome: ScheduleOutcome) -> dict[int, float]:
    """Model index -> end-to-end latency in seconds (summed over windows)."""
    lat: dict[int, float] = {}
    for wr in outcome.result.windows:
        for mi, v in wr.per_model_latency.items():
            lat[mi] = lat.get(mi, 0.0) + v
    return lat


def per_model_chunks(outcome: ScheduleOutcome
                     ) -> dict[int, tuple[tuple[float, int], ...]]:
    """Model index -> resumable (latency, end-chiplet) chunks across windows.

    Chunk latencies sum to exactly ``per_model_latency`` (same float order),
    and the final chunk's chiplet equals the model's ``final_anchors`` entry
    — the two invariants sub-iteration preemption rests on.
    """
    chunks: dict[int, list[tuple[float, int]]] = {}
    for wr in outcome.result.windows:
        for mi, segs in wr.per_model_segments.items():
            chunks.setdefault(mi, []).extend(segs)
    return {mi: tuple(c) for mi, c in chunks.items()}


@dataclasses.dataclass(frozen=True)
class OnlinePolicy:
    """How the online serving loop reacts at epoch boundaries.

    ``boundary`` picks the in-flight-iteration semantics (see module
    docstring).  ``reconfig_patterns`` + ``reconfig_hysteresis`` enable
    trace-driven MCM reconfiguration: the re-scheduler scores the named
    candidate patterns each epoch under the class-weighted objective and
    switches when the projected relative gain exceeds the hysteresis
    (``rescheduler.SLORescheduler``; ``inf`` never switches and is
    bit-identical to the fixed-pattern planner).

    ``idle_power_w`` is the package's static (leakage + always-on) power in
    watts: charged whenever a provisioned package has no serving work —
    tenantless epochs in every boundary mode, and the demand-limited slack
    inside open-loop epochs — so aggregate EDP is comparable across
    policies that leave different amounts of the fleet idle (a policy
    parking tenants on one package no longer gets the others' idleness for
    free).  The default 0.0 keeps every closed-loop result bit-identical
    to the PR 5 accounting.  ``core.provision.package_idle_power_w``
    derives a value from the MCM's chiplet count.
    """

    boundary: str = "instant"              # instant | drain | preempt
    reconfig_patterns: tuple[str, ...] = ()
    reconfig_hysteresis: float = math.inf
    idle_power_w: float = 0.0

    def __post_init__(self) -> None:
        if self.boundary not in ("instant", "drain", "preempt"):
            raise KeyError(f"unknown boundary policy {self.boundary!r}")
        if self.idle_power_w < 0:
            raise ValueError("idle_power_w must be >= 0")


@dataclasses.dataclass
class EpochRecord:
    """One inter-event interval of a churn simulation."""

    t_start: float
    t_end: float
    tenants: tuple[Tenant, ...]            # active set during the epoch
    outcome: Optional[ScheduleOutcome]     # None when the package idles
    tenant_order: tuple[int, ...]          # tenant id per model index
    replan_wall_s: float
    memo_hit: bool
    iterations: float                      # fractional serving iterations
    energy: float                          # package energy of the work this
    #                                        epoch's plan issued (incl. the
    #                                        deferred completion of an
    #                                        iteration preempted at its end,
    #                                        so epochs partition total_energy)
    pattern: Optional[str] = None          # MCM pattern serving the epoch
    switched: bool = False                 # epoch began with a reconfig
    n_preempted: int = 0                   # tenant iterations deferred
    serve_start: float = 0.0               # when this plan began serving
    serve_end: float = 0.0                 # when the package freed (cut)


@dataclasses.dataclass
class FrameRecord:
    """One served frame of a cadence simulation."""

    t: float
    model: str
    tenant: int                            # scenario model index
    latency: float                         # completion - arrival (queue incl.)
    deadline: float
    missed: bool
    energy: float
    slo: Optional[str] = None              # declared SLO class (None=default)


@dataclasses.dataclass(frozen=True)
class SLOSample:
    """One (possibly weighted) served-latency observation with its SLO.

    ``deadline`` is the absolute latency budget of the observation —
    ``deadline_factor * planned latency`` for churn iterations, the frame
    period for cadence frames; ``missed`` is the weight that blew it (0 or
    ``weight``: aggregated multi-iteration samples are at planned latency
    and never miss).  The multiset of (latency, weight) pairs here equals
    the PR 3 ``latency_samples`` exactly — ``metrics.slo_report`` reduces
    to the unweighted report when every tenant shares one class.
    """

    t: float                   # completion time (simulated seconds)
    model: str
    tenant: int
    slo: Optional[str]         # declared class (None -> default class)
    latency: float
    weight: float
    deadline: float            # absolute budget (may be inf)
    missed: float              # weight that missed the deadline


@dataclasses.dataclass
class SimResult:
    """A finished simulation, ready for ``metrics.qos_report``."""

    trace: Trace
    mode: str
    epochs: list[EpochRecord]
    frames: list[FrameRecord]
    # per model-name weighted QoS samples: (latency_s, weight) — weight is
    # iterations served at that latency (churn) or 1 per frame (cadence)
    latency_samples: dict[str, list[tuple[float, float]]]
    total_energy: float
    busy_s: float                             # simulated time with work
    replan_wall_s: float                      # total planner wall time
    n_replans: int
    n_memo_hits: int
    slo_samples: list[SLOSample] = dataclasses.field(default_factory=list)
    policy: Optional[OnlinePolicy] = None
    n_preemptions: int = 0
    n_switches: int = 0
    idle_energy: float = 0.0                  # static-power joules included
    #                                           in total_energy (0 unless
    #                                           policy.idle_power_w is set)
    requests_offered: float = 0.0             # open-loop demand (rate x time)
    requests_served: float = 0.0              # demand actually served


# ---------------------------------------------------------------------------
# pure helpers
# ---------------------------------------------------------------------------

def iteration_split(chunks: tuple[tuple[float, int], ...], elapsed: float
                    ) -> tuple[float, float, tuple[tuple[float, int], ...]]:
    """Cut one tenant's iteration ``elapsed`` seconds in, at a chunk boundary.

    Execution cannot stop mid-chunk, so the chunk in progress at ``elapsed``
    runs to completion first.  Returns ``(done, delay, remainder)``:
    ``done`` — seconds of the iteration completed at the pause point (the
    cumulative chunk boundary), ``delay`` — how long past ``elapsed`` that
    boundary is (0 when the tenant already finished its part), and
    ``remainder`` — the chunks still to run.  Invariant:
    ``done + sum(remainder latencies) == sum(chunk latencies)`` exactly
    (work is conserved; same float summation order).
    """
    if elapsed < 0:
        raise ValueError("elapsed must be >= 0")
    cum = 0.0
    for i, (lat, _) in enumerate(chunks):
        cum += lat
        if cum >= elapsed:
            return cum, cum - elapsed, chunks[i + 1:]
    return cum, 0.0, ()


# ---------------------------------------------------------------------------
# churn
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Plan:
    """The serving state of one epoch's schedule."""

    rec: "object"                          # rescheduler.ReplanRecord
    pml: dict[int, float]                  # tenant id -> planned latency
    chunks: dict[int, tuple[tuple[float, int], ...]]
    latency: float                         # package iteration period
    energy: float                          # package energy per iteration
    share: dict[int, float]                # tenant id -> energy share / iter


def _build_plan(rec) -> _Plan:
    pml_m = per_model_latency(rec.outcome)
    chunks_m = per_model_chunks(rec.outcome)
    pml = {tid: pml_m.get(mi, 0.0) for mi, tid in enumerate(rec.tenant_order)}
    chunks = {tid: chunks_m.get(mi, ())
              for mi, tid in enumerate(rec.tenant_order)}
    total = sum(pml.values())
    energy = rec.outcome.result.energy
    share = {tid: (energy * v / total if total > 0 else 0.0)
             for tid, v in pml.items()}
    return _Plan(rec=rec, pml=pml, chunks=chunks,
                 latency=rec.outcome.result.latency, energy=energy,
                 share=share)


class _ChurnLoop:
    """Mutable accounting state of one churn replay (one mode/policy).

    ``depart_t`` maps tenant id -> departure event time and is only
    *required* by the discrete boundary modes (drain/preempt look ahead to
    cancel in-flight work); the fluid modes never read it, which is what
    lets the fleet driver stream instant-boundary traces without knowing
    the future.  ``sink`` replaces per-sample list retention with a
    callback (fleet-scale bounded memory): when set, every ``SLOSample``
    goes to the callback and nothing accumulates in ``samples`` /
    ``slo_samples``.
    """

    def __init__(self, resched, policy: OnlinePolicy,
                 depart_t: Optional[dict[int, float]] = None,
                 sink=None):
        self.resched = resched
        self.policy = policy
        self.sink = sink
        self.samples: dict[str, list[tuple[float, float]]] = {}
        self.slo_samples: list[SLOSample] = []
        self.epochs: list[EpochRecord] = []
        self.total_energy = 0.0
        self.idle_energy = 0.0
        self.busy = 0.0
        self.replan_wall = 0.0
        self.n_replans = self.n_hits = self.n_preempt = 0
        self.requests_offered = 0.0
        self.requests_served = 0.0
        # tenant id -> (model name, declared slo) while active
        self.name_of: dict[int, str] = {}
        self.slo_of: dict[int, Optional[str]] = {}
        # tenant id -> offered load (requests/s); absent = closed-loop
        self.rate_of: dict[int, float] = {}
        # arrival time awaiting the tenant's first completed iteration
        self.wait_from: dict[int, float] = {}
        # tenant id -> time its deferred (preempted) chunks finish executing
        self.resume_until: dict[int, float] = {}
        # tenant id -> departure event time (inf if none known)
        self.depart_t: dict[int, float] = depart_t if depart_t is not None \
            else {}

    # -- sample plumbing ----------------------------------------------------
    def emit(self, t: float, tid: int, latency: float, weight: float,
             deadline: float) -> None:
        if weight <= 0:
            return
        name = self.name_of[tid]
        missed = weight if latency > deadline else 0.0
        sample = SLOSample(
            t=t, model=name, tenant=tid, slo=self.slo_of.get(tid),
            latency=latency, weight=weight, deadline=deadline, missed=missed)
        if self.sink is not None:
            self.sink(sample)
            return
        self.samples.setdefault(name, []).append((latency, weight))
        self.slo_samples.append(sample)

    def _deadline(self, tid: int, pml: float) -> float:
        return get_slo(self.slo_of.get(tid)).deadline_factor * pml

    # -- serving accounting -------------------------------------------------
    def serve(self, plan: _Plan, serve_start: float, t_end: float,
              departing: set[int], at_horizon: bool) -> tuple[float, int]:
        """Account serving ``plan`` from ``serve_start`` until the boundary
        at ``t_end``; returns (package-free time, tenants preempted)."""
        lat = plan.latency
        dur = t_end - serve_start
        if dur <= 0 or lat <= 0:
            return max(serve_start, t_end), 0

        tids = list(plan.pml)
        # first package iteration each tenant takes part in (tenants still
        # executing deferred chunks of a preempted iteration sit out)
        j_min = {}
        for tid in tids:
            done_t = self.resume_until.get(tid, serve_start)
            j_min[tid] = max(0, math.ceil((done_t - serve_start) / lat
                                          - 1e-12)) if done_t > serve_start \
                else 0
        for tid in tids:          # resume windows inside this epoch are spent
            if self.resume_until.get(tid, serve_start) <= t_end:
                self.resume_until.pop(tid, None)

        if self.policy.boundary == "instant":
            if self.rate_of:
                cut = self._serve_open(plan, serve_start, t_end, departing)
            else:
                cut = self._serve_fluid(plan, serve_start, t_end, departing)
            return cut, 0
        return self._serve_discrete(plan, serve_start, t_end,
                                    at_horizon, j_min)

    def _serve_fluid(self, plan: _Plan, serve_start: float, t_end: float,
                     departing: set[int]) -> float:
        """PR 3 fractional accounting (+ the departure correction)."""
        lat = plan.latency
        iters = (t_end - serve_start) / lat
        frac = iters - math.floor(iters)
        energy = iters * plan.energy
        for tid in plan.pml:
            weight = iters
            if tid in departing and frac > 0:
                # the in-flight fraction at the departure is cancelled: no
                # sample, and its energy share is not charged.  Each of the
                # (possibly several) tenants departing at this boundary
                # refunds exactly its own share once; ``.get`` guards a
                # departing tenant the plan never served (a same-timestamp
                # arrive+depart pair) — nothing was charged, so nothing is
                # refunded
                weight = math.floor(iters)
                energy -= frac * plan.share.get(tid, 0.0)
            self.emit(t_end, tid, plan.pml[tid], weight,
                      self._deadline(tid, plan.pml[tid]))
            self.wait_from.pop(tid, None)
        self.total_energy += energy
        self.busy += t_end - serve_start
        self._last_iters = iters
        self._last_energy = energy
        return t_end

    def _serve_open(self, plan: _Plan, serve_start: float, t_end: float,
                    departing: set[int]) -> float:
        """Demand-limited fluid accounting (open-loop offered load).

        Each rated tenant's served iterations are capped by its offered
        demand ``rate x duration`` as well as by the package iteration
        capacity ``duration / latency``; unrated tenants saturate like the
        closed-loop fluid model.  Demand the package could not serve is
        emitted as an infinite-latency missed sample (an unserved request
        never completes), which is what the fleet-level attainment gate
        measures.  The package is busy only for the iterations it actually
        runs — the slack is charged at ``policy.idle_power_w``.
        """
        lat = plan.latency
        dur = t_end - serve_start
        cap = dur / lat                    # package iteration capacity
        served: dict[int, float] = {}
        for tid in plan.pml:
            r = self.rate_of.get(tid)
            served[tid] = cap if r is None else min(cap, r * dur)
        # the package runs as many iterations as its hungriest tenant needs;
        # lighter tenants simply sit out the rest (demand-limited fluid)
        iters_run = max(served.values(), default=0.0)
        energy = 0.0
        for tid in plan.pml:
            w = served[tid]
            if tid in departing:
                # in-flight fraction at departure cancelled, as in fluid
                w = math.floor(w)
            energy += w * plan.share.get(tid, 0.0)
            r = self.rate_of.get(tid)
            if r is not None:
                demand = r * dur
                self.requests_offered += demand
                self.requests_served += w
                unserved = demand - served[tid]
                if unserved > 1e-12:
                    self.emit(t_end, tid, math.inf, unserved,
                              self._deadline(tid, plan.pml[tid]))
            self.emit(t_end, tid, plan.pml[tid], w,
                      self._deadline(tid, plan.pml[tid]))
            self.wait_from.pop(tid, None)
        busy_t = min(dur, iters_run * lat)
        idle_e = self.policy.idle_power_w * max(0.0, dur - busy_t)
        self.total_energy += energy + idle_e
        self.idle_energy += idle_e
        self.busy += busy_t
        self._last_iters = iters_run
        self._last_energy = energy + idle_e
        return t_end

    def _serve_discrete(self, plan: _Plan, serve_start: float, t_end: float,
                        at_horizon: bool,
                        j_min: dict[int, int]) -> tuple[float, int]:
        lat = plan.latency
        dur = t_end - serve_start
        n_done = int(dur / lat)
        elapsed = dur - n_done * lat
        if elapsed <= 1e-12 * max(1.0, abs(t_end)):
            elapsed = 0.0
        energy = 0.0
        n_preempted = 0

        # ---- whole iterations (per-tenant: deferred-resume windows skip) --
        for tid, pml in plan.pml.items():
            n_i = max(0, n_done - j_min[tid])
            if n_i <= 0:
                continue
            dl = self._deadline(tid, pml)
            wait_t = self.wait_from.pop(tid, None)
            if wait_t is not None:
                first_done = serve_start + j_min[tid] * lat + pml
                self.emit(first_done, tid, first_done - wait_t, 1.0, dl)
                n_i -= 1
            if n_i > 0:
                self.emit(serve_start + n_done * lat, tid, pml, n_i, dl)
            energy += max(0, n_done - j_min[tid]) * plan.share[tid]

        cut = serve_start + n_done * lat
        if elapsed > 0:
            split_start = serve_start + n_done * lat
            part = [tid for tid in plan.pml if j_min[tid] <= n_done]
            if at_horizon:
                # horizon cuts mid-iteration: fractional fluid tail (no
                # event, nothing preempts — mirrors the instant mode)
                frac = elapsed / lat
                for tid in part:
                    self.emit(t_end, tid, plan.pml[tid], frac,
                              self._deadline(tid, plan.pml[tid]))
                    energy += frac * plan.share[tid]
                cut = t_end
            elif self.policy.boundary == "drain":
                # in-flight iteration drains; a tenant departing before its
                # own part completes is cancelled (no sample, no charge)
                survivors = [
                    tid for tid in part
                    if self.depart_t.get(tid, math.inf)
                    >= split_start + plan.pml[tid]]
                cut = split_start + lat if survivors else split_start
                for tid in survivors:
                    pml = plan.pml[tid]
                    dl = self._deadline(tid, pml)
                    wait_t = self.wait_from.pop(tid, split_start)
                    self.emit(split_start + pml, tid,
                              split_start + pml - wait_t, 1.0, dl)
                    energy += plan.share[tid]
            else:                                # preempt
                delay = 0.0
                splits = {}
                for tid in part:
                    pml = plan.pml[tid]
                    dep = self.depart_t.get(tid, math.inf)
                    done, d_i, rem = iteration_split(plan.chunks[tid],
                                                     elapsed)
                    if rem and get_slo(self.slo_of.get(tid)).preemptible:
                        splits[tid] = (done, rem)
                    elif dep < split_start + pml:
                        continue    # departs mid-flight: cancelled outright
                    else:
                        # finishes its iteration (or already finished it)
                        d_i = max(0.0, pml - elapsed)
                        splits[tid] = (pml, ())
                    delay = max(delay, d_i)
                cut = t_end + delay
                for tid, (done, rem) in splits.items():
                    pml = plan.pml[tid]
                    dl = self._deadline(tid, pml)
                    wait_t = self.wait_from.pop(tid, split_start)
                    if not rem:
                        self.emit(split_start + pml, tid,
                                  split_start + pml - wait_t, 1.0, dl)
                        energy += plan.share[tid]
                        continue
                    # deferred: remaining chunks execute under the new
                    # epoch, completing at cut + remainder (work conserved).
                    # The whole iteration's energy stays attributed to THIS
                    # epoch (whose plan issued it), so sum(epoch.energy)
                    # == total_energy holds in every boundary mode.
                    n_preempted += 1
                    rest = sum(r for r, _ in rem)
                    done_t = cut + rest
                    # pml > 0 whenever chunks exist; guard the degenerate
                    # zero-latency plan rather than dividing by it
                    energy += plan.share[tid] * (done / pml) if pml > 0 \
                        else 0.0
                    if self.depart_t.get(tid, math.inf) < done_t:
                        continue        # departs mid-resume: rest cancelled
                    self.resume_until[tid] = done_t
                    self.emit(done_t, tid, done_t - wait_t, 1.0, dl)
                    energy += plan.share[tid] * (rest / pml) if pml > 0 \
                        else 0.0

        self.total_energy += energy
        self.busy += cut - serve_start
        self._last_iters = (cut - serve_start) / lat if not at_horizon \
            else dur / lat
        self._last_energy = energy
        self.n_preempt += n_preempted
        return cut, n_preempted


class PackageServer:
    """Incremental epoch-stepped churn serving for one MCM package.

    The per-event-group body of the classic single-package replay,
    factored out so the fleet driver (``online.fleet``) can drive many
    packages from one merged event stream.  Feed successive same-time
    event groups through ``step``; each call applies the group's events
    and closes the serving epoch ``[t, t_next)`` on this package.  The
    fluid boundary modes need no future knowledge; drain/preempt need
    ``depart_t`` pre-filled from a materialised trace (the single-package
    path does this; the streaming fleet driver is instant-only).

    ``keep_epochs=False`` drops per-epoch records (fleet-scale bounded
    memory); ``sink`` reroutes samples the same way (see ``_ChurnLoop``).
    ``created_at`` is when the package was provisioned — static power is
    charged from there to the first event.
    """

    def __init__(self, resched, policy: OnlinePolicy, *,
                 depart_t: Optional[dict[int, float]] = None,
                 sink=None, created_at: float = 0.0,
                 keep_epochs: bool = True, gauge=None):
        self.resched = resched
        self.policy = policy
        self.loop = _ChurnLoop(resched, policy, depart_t=depart_t, sink=sink)
        self.active: dict[int, Tenant] = {}
        self.free_at = created_at
        self.created_at = created_at
        self.keep_epochs = keep_epochs
        self.k = 0
        self._started = False
        self._gauge = gauge if gauge is not None \
            else obs.gauge("online.active_tenants")
        self._preempt_c = obs.counter("online.preemptions")

    @property
    def load(self) -> float:
        """Offered load on this package: sum of active tenants' request
        rates, counting a closed-loop (rateless) tenant as 1.0."""
        return sum(self.loop.rate_of.get(tid, 1.0) for tid in self.active)

    def reset_idle_origin(self, t: float) -> None:
        """Restart static-power accounting from ``t``.

        The fleet autoscaler calls this when it re-provisions a previously
        decommissioned package: the decommissioned interval burned nothing,
        and idle charging resumes at the re-provision time.
        """
        self.created_at = t
        self.free_at = max(self.free_at, t)
        self._started = False

    def step(self, t: float, evs: list, t_next: float,
             next_departing: set[int], at_horizon: bool) -> None:
        loop = self.loop
        if not self._started:
            self._started = True
            # static power from provisioning until the first event
            idle_e = self.policy.idle_power_w * max(0.0, t - self.created_at)
            if idle_e > 0:
                loop.total_energy += idle_e
                loop.idle_energy += idle_e
        # A tenant arriving AND departing at the same timestamp while not
        # already resident is a zero-length tenancy: it is never resident.
        # (The total order processes the depart first, which would no-op
        # and leave the arrival permanently active otherwise.)
        arr_ids = {e.tenant for e in evs if e.kind == "arrive"}
        dep_ids = {e.tenant for e in evs if e.kind == "depart"}
        ghosts = (arr_ids & dep_ids) - set(self.active)
        for e in evs:
            if e.tenant in ghosts:
                continue
            if e.kind == "arrive":
                self.active[e.tenant] = (e.tenant, e.model, e.batch)
                loop.name_of[e.tenant] = e.model
                loop.slo_of[e.tenant] = e.slo
                if e.rate is not None:
                    if self.policy.boundary != "instant":
                        raise ValueError(
                            "open-loop (rated) tenants require the "
                            "'instant' boundary; got "
                            f"{self.policy.boundary!r}")
                    loop.rate_of[e.tenant] = float(e.rate)
                loop.wait_from[e.tenant] = e.t
            elif e.kind == "depart":
                self.active.pop(e.tenant, None)
                # prune everything keyed by the tenant: nothing serves or
                # plans it past its departure, and ``slo_of`` is copied per
                # replan — leaving departed ids in makes million-event
                # traces quadratic in the tenant count
                loop.name_of.pop(e.tenant, None)
                loop.slo_of.pop(e.tenant, None)
                loop.rate_of.pop(e.tenant, None)
                loop.wait_from.pop(e.tenant, None)
                loop.resume_until.pop(e.tenant, None)
            else:
                raise ValueError(f"churn trace carries {e.kind!r} event")
        tenants = sorted(self.active.values())
        self._gauge.set(len(tenants))
        k = self.k
        self.k = k + 1
        with obs.span("epoch", cat="online", epoch=k,
                      tenants=len(tenants)):
            if tenants:
                rec = self.resched.replan(tenants, slo_of=dict(loop.slo_of))
                loop.replan_wall += rec.wall_s
                loop.n_replans += 1
                loop.n_hits += rec.memo_hit
                plan = _build_plan(rec)
                serve_start = max(self.free_at, t)
                loop._last_iters = 0.0
                loop._last_energy = 0.0
                with obs.span("serve", cat="online",
                              boundary=self.policy.boundary):
                    cut, n_pre = loop.serve(plan, serve_start, t_next,
                                            next_departing, at_horizon)
                self.free_at = cut
                if n_pre:
                    self._preempt_c.inc(n_pre)
                    obs.event("preempt", cat="online", epoch=k,
                              tenants_deferred=n_pre)
                if self.keep_epochs:
                    loop.epochs.append(EpochRecord(
                        t_start=t, t_end=t_next, tenants=tuple(tenants),
                        outcome=rec.outcome,
                        tenant_order=tuple(rec.tenant_order),
                        replan_wall_s=rec.wall_s, memo_hit=rec.memo_hit,
                        iterations=loop._last_iters,
                        energy=loop._last_energy,
                        pattern=rec.pattern, switched=rec.switched,
                        n_preempted=n_pre, serve_start=serve_start,
                        serve_end=cut))
            else:
                self.free_at = max(self.free_at, t)
                # an empty provisioned package still burns static power
                idle_e = self.policy.idle_power_w * max(0.0, t_next - t)
                if idle_e > 0:
                    loop.total_energy += idle_e
                    loop.idle_energy += idle_e
                if self.keep_epochs:
                    loop.epochs.append(EpochRecord(
                        t_start=t, t_end=t_next, tenants=(), outcome=None,
                        tenant_order=(), replan_wall_s=0.0, memo_hit=False,
                        iterations=0.0, energy=idle_e))


def _churn(trace: Trace, resched, policy: OnlinePolicy) -> SimResult:
    # drain/preempt cancel in-flight work against future departures, so the
    # single-package path precomputes depart times from the materialised
    # trace (the streaming fleet driver, instant-only, never needs this)
    depart_t = {e.tenant: e.t for e in trace.events if e.kind == "depart"}
    server = PackageServer(resched, policy, depart_t=depart_t)
    groups = [(t, list(evs)) for t, evs in
              itertools.groupby(trace.events, key=lambda e: e.t)]
    bounds = [t for t, _ in groups] + [trace.horizon]
    for k, (t, evs) in enumerate(groups):
        t_next = bounds[k + 1]
        at_horizon = k + 1 == len(groups)
        next_departing = set() if at_horizon else {
            e.tenant for e in groups[k + 1][1] if e.kind == "depart"}
        server.step(t, evs, t_next, next_departing, at_horizon)
    loop = server.loop
    return SimResult(trace=trace, mode=resched.mode, epochs=loop.epochs,
                     frames=[], latency_samples=loop.samples,
                     total_energy=loop.total_energy, busy_s=loop.busy,
                     replan_wall_s=loop.replan_wall,
                     n_replans=loop.n_replans, n_memo_hits=loop.n_hits,
                     slo_samples=loop.slo_samples, policy=policy,
                     n_preemptions=loop.n_preempt,
                     n_switches=getattr(resched, "n_switches", 0),
                     idle_energy=loop.idle_energy,
                     requests_offered=loop.requests_offered,
                     requests_served=loop.requests_served)


# ---------------------------------------------------------------------------
# cadence
# ---------------------------------------------------------------------------

def replay_cadence(trace: Trace, model_latency: dict[int, float],
                   model_energy: dict[int, float]) -> list[FrameRecord]:
    """Pure frame replay: FIFO per-model queues against fixed latencies.

    Split out from ``simulate`` so deadline-miss accounting is testable on
    hand-computed latencies without running the scheduler.
    """
    frames: list[FrameRecord] = []
    busy_until: dict[int, float] = {}
    for e in trace.events:
        if e.kind != "frame":
            raise ValueError(f"cadence trace carries {e.kind!r} event")
        lat = model_latency[e.tenant]
        start = max(e.t, busy_until.get(e.tenant, 0.0))
        completion = start + lat
        busy_until[e.tenant] = completion
        frames.append(FrameRecord(
            t=e.t, model=e.model, tenant=e.tenant,
            latency=completion - e.t, deadline=float(e.deadline),
            missed=completion > e.t + e.deadline,
            energy=model_energy.get(e.tenant, 0.0), slo=e.slo))
    return frames


def _cadence(trace: Trace, resched, policy: OnlinePolicy) -> SimResult:
    # frames are single inferences: plan the scenario's model set at batch 1
    # (Table II's AR/VR batch column is the firing rate, not a real batch)
    from repro_torch.core.scenarios import scenario_spec
    tenants: list[Tenant] = [(mi, name, 1) for mi, (name, _)
                             in enumerate(scenario_spec(trace.scenario))]
    slo_of = {e.tenant: e.slo for e in trace.events}
    rec = resched.replan(tenants, slo_of=slo_of)
    # rescheduler orders models canonically; map back to scenario indices
    idx_of = {tid: mi for mi, tid in enumerate(rec.tenant_order)}
    pml = per_model_latency(rec.outcome)
    lat = {tid: pml.get(mi, 0.0) for tid, mi in idx_of.items()}
    lat_sum = sum(lat.values()) or 1.0
    energy = {tid: rec.outcome.result.energy * lat[tid] / lat_sum
              for tid in lat}
    frames = replay_cadence(trace, lat, energy)
    samples: dict[str, list[tuple[float, float]]] = {}
    slo_samples: list[SLOSample] = []
    for f in frames:
        samples.setdefault(f.model, []).append((f.latency, 1.0))
        slo_samples.append(SLOSample(
            t=f.t + f.latency, model=f.model, tenant=f.tenant, slo=f.slo,
            latency=f.latency, weight=1.0, deadline=f.deadline,
            missed=1.0 if f.missed else 0.0))
    return SimResult(trace=trace, mode=resched.mode, epochs=[], frames=frames,
                     latency_samples=samples,
                     total_energy=sum(f.energy for f in frames),
                     busy_s=trace.horizon, replan_wall_s=rec.wall_s,
                     n_replans=1, n_memo_hits=int(rec.memo_hit),
                     slo_samples=slo_samples, policy=policy,
                     n_switches=getattr(resched, "n_switches", 0))


def simulate(trace: Trace, mcm: Optional[MCM] = None,
             pattern: str = "het_cross", rows: int = 6, cols: int = 6,
             n_pe: int = 4096, cfg: Optional[SearchConfig] = None,
             mode: str = "warm",
             policy: Optional[OnlinePolicy] = None,
             rescheduler: Optional[Rescheduler] = None, *,
             device: Optional[str | torch.device] = None) -> SimResult:
    """Replay ``trace`` against the scheduler and return the accounting.

    Pass either a ready ``mcm`` (and optionally a ``rescheduler`` to share
    memo state across calls) or the ``pattern``/``rows``/``cols``/``n_pe``
    of one to build.  ``mode`` selects the warm incremental path or the cold
    from-scratch oracle (see ``rescheduler``); ``policy`` the epoch-boundary
    semantics and MCM reconfiguration (``OnlinePolicy``; the default is the
    PR 3 class-blind fluid model on a fixed pattern).

    ``device`` is where every re-plan runs (``schedule(..., device=)``):
    CUDA when None, raising without a card; the CPU only when asked for.
    A passed ``rescheduler`` plans on its own device.

    Returns a ``SimResult``: latency samples and deadlines in simulated
    seconds, energies in joules, ready for ``metrics.qos_report`` /
    ``metrics.slo_report``.
    """
    if rescheduler is None:
        device = resolve_device(device)
    if mcm is None:
        mcm = make_mcm(pattern, rows=rows, cols=cols, n_pe=n_pe)
    policy = policy or OnlinePolicy()
    if rescheduler is not None:
        resched = rescheduler
    elif policy.reconfig_patterns:
        resched = SLORescheduler(mcm, cfg=cfg, mode=mode,
                                 patterns=policy.reconfig_patterns,
                                 hysteresis=policy.reconfig_hysteresis,
                                 device=device)
    else:
        resched = Rescheduler(mcm, cfg=cfg, mode=mode, device=device)
    if trace.kind == "churn":
        return _churn(trace, resched, policy)
    if trace.kind == "cadence":
        return _cadence(trace, resched, policy)
    raise KeyError(f"unknown trace kind {trace.kind!r}")
