"""Multi-package fleet serving: route tenants across many MCM packages.

The single-package simulator serves whatever lands on it; a datacenter
serves *fleets* — many identical MCM packages behind a router, with
admission control and a power/area envelope (``core.provision``'s
MPSoC-style budget model).  ``simulate_fleet`` drives any number of
``simulator.PackageServer`` loops from one merged, *streamed* event
iterator:

* **Routing**: each arriving tenant is pinned to one package for its whole
  tenancy (tenant state — anchors, activations — lives on-package).
  ``least_loaded`` routes to the admissible package with the smallest
  offered load; ``round_robin`` is the naive baseline that cycles packages
  regardless of load (``core.provision.pick_package``).
* **Admission**: a package admits at most ``max_tenants_per_package``
  tenants.  When no package can admit and autoscaling is off (or the
  budget is exhausted), the tenant is *rejected*: its arrival and later
  departure are dropped (the departure via the tenant->package map), and
  ``fleet.rejections`` counts it.
* **Autoscaling**: with ``autoscale=True`` the fleet provisions another
  package on demand — if the total would stay within ``PackageBudget``
  (peak ``package_power_w`` / ``package_area_mm2`` per copy) and
  ``max_packages`` — and decommissions a package the moment it empties
  (its static power stops accruing; the package is kept and re-provisioned
  warm, so its planner memo survives).
* **Idle power**: every *provisioned* package burns
  ``package_idle_power_w`` (or an explicit ``idle_power_w``) whether or
  not it serves, so fleet EDP comparisons price over-provisioning.

Scale: the driver consumes the event stream group-by-group (one group =
one timestamp), holds at most one undelivered group per package, and folds
samples into ``metrics.StreamingStats`` instead of lists — memory is
O(packages + active tenants) regardless of trace length
(``FleetReport.max_buffered_events`` is the measured bound).  Boundary
mode is ``instant`` only: the discrete modes need future departure times,
which a stream cannot provide.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Optional, Union

import torch

from repro_torch import obs
from repro_torch.core.chiplet import make_mcm
from repro_torch.core.provision import (PackageBudget,
                                        max_affordable_packages,
                                        package_idle_power_w,
                                        package_power_w, pick_package)
from repro_torch.core.scheduler import SearchConfig
from repro_torch.launch.platform import resolve_device

from .metrics import ClassQoS, StreamingStats
from .rescheduler import Rescheduler
from .simulator import OnlinePolicy, PackageServer, SLOSample
from .slo import SLO_CLASSES, get_slo
from .traces import Event, Trace


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """A fleet of identical MCM packages plus its routing/scaling policy."""

    pattern: str = "het_cross"
    rows: int = 3
    cols: int = 3
    n_pe: int = 1024
    cfg: Optional[SearchConfig] = None
    n_packages: int = 4                  # provisioned up front
    max_packages: Optional[int] = None   # autoscale ceiling (None: initial)
    min_packages: int = 1                # never scale below
    max_tenants_per_package: int = 4
    routing: str = "least_loaded"        # least_loaded | round_robin
    autoscale: bool = False
    budget: PackageBudget = PackageBudget()
    idle_power_w: Optional[float] = None  # None: package_idle_power_w(mcm)
    mode: str = "warm"
    # long-trace plan memo: (scenario, anchors) keys recur heavily under a
    # small zoo, and the single-package default (256) thrashes at fleet
    # event counts — size for the full reachable key set instead
    plan_memo_max: int = 8192

    def __post_init__(self) -> None:
        if self.n_packages < 1:
            raise ValueError("n_packages must be >= 1")
        if self.routing not in ("least_loaded", "round_robin"):
            raise KeyError(f"unknown routing policy {self.routing!r}")


@dataclasses.dataclass(frozen=True)
class PackageSummary:
    """End-of-run accounting for one fleet package."""

    index: int
    provisioned: bool                    # still provisioned at horizon
    n_tenants_end: int
    total_energy: float
    idle_energy: float
    busy_s: float
    n_replans: int
    n_memo_hits: int
    requests_served: float


@dataclasses.dataclass(frozen=True)
class FleetReport:
    """Fleet-level accounting of one streamed open-loop run.

    ``fleet_edp`` is total fleet energy (serving + static/idle, every
    provisioned package) x the trace horizon — the delay term is the fixed
    wall the fleet was provisioned for, so with idle power charged the
    metric prices over-provisioning and under-serving alike.  ``score``
    divides by weighted attainment like ``metrics.SLOReport.score``;
    ``edp_per_request`` normalises by served demand so a policy cannot
    look good by serving less.  Per-class QoS comes from bounded-memory
    ``StreamingStats`` (log-binned percentiles; empty classes NaN).
    """

    name: str
    routing: str
    horizon: float
    n_events: int
    n_packages: int                      # packages ever provisioned
    n_provisioned_end: int
    peak_packages: int
    total_energy: float
    idle_energy: float
    busy_s: float
    fleet_edp: float
    requests_offered: float
    requests_served: float
    served_weight: float
    per_class: tuple[ClassQoS, ...]
    weighted_p50: float
    weighted_p99: float
    weighted_miss_rate: float
    attainment: float
    score: float
    edp_per_request: float
    admitted_tenants: int
    rejected_tenants: int
    scale_ups: int
    scale_downs: int
    n_replans: int
    n_memo_hits: int
    replan_wall_s: float
    max_buffered_events: int
    per_package: tuple[PackageSummary, ...]

    def cls(self, name: str) -> ClassQoS:
        for c in self.per_class:
            if c.slo == name:
                return c
        raise KeyError(name)


class _Pkg:
    """Driver-side wrapper: one package server + its delivery buffer."""

    __slots__ = ("index", "server", "buffered", "provisioned")

    def __init__(self, index: int, server: PackageServer):
        self.index = index
        self.server = server
        self.buffered: Optional[tuple[float, list[Event]]] = None
        self.provisioned = True

    def tenant_count(self) -> int:
        n = len(self.server.active)
        if self.buffered is not None:
            for e in self.buffered[1]:
                n += 1 if e.kind == "arrive" else -1
        return max(0, n)

    def load(self) -> float:
        ld = self.server.load
        if self.buffered is not None:
            for e in self.buffered[1]:
                r = e.rate if e.rate is not None else 1.0
                ld += r if e.kind == "arrive" else -r
        return max(0.0, ld)

    def flush(self, t_next: float, next_departing: set[int],
              at_horizon: bool) -> None:
        if self.buffered is None:
            return
        t, evs = self.buffered
        self.buffered = None
        self.server.step(t, evs, t_next, next_departing, at_horizon)


def simulate_fleet(events: Union[Trace, Iterable[Event]], horizon: float,
                   fleet: Optional[FleetConfig] = None,
                   name: str = "fleet", *,
                   device: Optional[str | torch.device] = None
                   ) -> FleetReport:
    """Stream a churn event sequence through a multi-package fleet.

    ``events`` is a ``Trace`` or any *sorted* event iterable (a streaming
    generator such as ``traces.iter_open_loop_churn`` — nothing is
    materialised).  Only churn events are valid; rated tenants are served
    open-loop, rateless ones closed-loop, all under the ``instant``
    boundary.  Every package re-plans on ``device`` (CUDA when None,
    raising without a card).  Returns a ``FleetReport``.
    """
    device = resolve_device(device)
    fleet = fleet or FleetConfig()
    if isinstance(events, Trace):
        horizon = events.horizon
        stream: Iterable[Event] = events.events
    else:
        stream = events
    mcm = make_mcm(fleet.pattern, rows=fleet.rows, cols=fleet.cols,
                   n_pe=fleet.n_pe)
    idle_w = fleet.idle_power_w if fleet.idle_power_w is not None \
        else package_idle_power_w(mcm)
    policy = OnlinePolicy(boundary="instant", idle_power_w=idle_w)
    max_pkgs = fleet.max_packages if fleet.max_packages is not None \
        else fleet.n_packages
    max_pkgs = min(max_pkgs, max_affordable_packages(mcm, fleet.budget))
    if max_pkgs < 1:
        raise ValueError(
            f"budget admits no package: {package_power_w(mcm):.1f} W each "
            f"against {fleet.budget.power_w} W")

    # fleet-level bounded-memory accumulators
    class_stats = {nm: StreamingStats() for nm in SLO_CLASSES}
    pooled = StreamingStats()            # class-weight-scaled pooled view

    def sink(s: SLOSample) -> None:
        cls = get_slo(s.slo)
        class_stats[cls.name].add(s.latency, s.weight, s.missed)
        pooled.add(s.latency, s.weight * cls.weight,
                   s.missed * cls.weight)

    pkg_gauge = obs.gauge("fleet.packages")
    tenants_g = obs.gauge("fleet.active_tenants")
    active_g = obs.gauge("fleet.package_active")
    reject_c = obs.counter("fleet.rejections")
    admit_c = obs.counter("fleet.admissions")
    up_c = obs.counter("fleet.scale_ups")
    down_c = obs.counter("fleet.scale_downs")

    def new_pkg(index: int, t: float) -> _Pkg:
        resched = Rescheduler(mcm, cfg=fleet.cfg, mode=fleet.mode,
                              plan_memo_max=fleet.plan_memo_max,
                              device=device)
        server = PackageServer(resched, policy, sink=sink, created_at=t,
                               keep_epochs=False, gauge=active_g)
        return _Pkg(index, server)

    pkgs: list[_Pkg] = [new_pkg(i, 0.0)
                        for i in range(min(fleet.n_packages, max_pkgs))]
    # tenant id -> (package index, offered rate); routing is sticky for the
    # whole tenancy, and the rate is needed to discount in-group departures
    tenant_pkg: dict[int, tuple[int, float]] = {}
    rr_cursor = 0
    n_events = n_admitted = n_rejected = 0
    scale_ups = scale_downs = 0
    peak = len(pkgs)
    max_buffered = 0

    def provisioned() -> list[_Pkg]:
        return [p for p in pkgs if p.provisioned]

    def scale_up(t: float) -> Optional[_Pkg]:
        nonlocal scale_ups, peak
        live = provisioned()
        if len(live) >= max_pkgs:
            return None
        # re-provision a decommissioned package first: its planner memo is
        # warm, and the fleet never exceeds its historical footprint
        grown = None
        for p in pkgs:
            if not p.provisioned:
                p.provisioned = True
                p.server.reset_idle_origin(t)
                grown = p
                break
        if grown is None:
            grown = new_pkg(len(pkgs), t)
            pkgs.append(grown)
        scale_ups += 1
        up_c.inc()
        peak = max(peak, len(provisioned()))
        return grown

    def maybe_scale_down(p: _Pkg, t: float) -> None:
        nonlocal scale_downs
        if not fleet.autoscale or not p.provisioned:
            return
        if len(provisioned()) <= fleet.min_packages:
            return
        if p.tenant_count() > 0:
            return
        # empty: close out the pending group now so idle charging stops at t
        if p.buffered is not None:
            p.flush(p.buffered[0], set(), False)
        p.provisioned = False
        scale_downs += 1
        down_c.inc()

    with obs.span("fleet", cat="online", routing=fleet.routing,
                  packages=len(pkgs)):
        groups = itertools.groupby(stream, key=lambda e: e.t)
        for t, evs_it in groups:
            group = list(evs_it)
            n_events += len(group)
            # zero-length tenancies (arrive and depart at the same rounded
            # timestamp, never resident) are skipped whole — the departure
            # sorts first, before the tenant is even routed
            arr_ids = {e.tenant for e in group if e.kind == "arrive"}
            dep_ids = {e.tenant for e in group if e.kind == "depart"}
            ghosts = (arr_ids & dep_ids) - set(tenant_pkg)
            sub: dict[int, list[Event]] = {}
            # in-group tenant/load deltas per package index, so admission
            # sees earlier routings within the same timestamp group
            d_cnt: dict[int, int] = {}
            d_load: dict[int, float] = {}
            for e in group:
                if e.kind == "frame":
                    raise ValueError("fleet serving is churn-only")
                if e.tenant in ghosts:
                    continue
                if e.kind == "depart":
                    routed = tenant_pkg.pop(e.tenant, None)
                    if routed is None:
                        continue         # rejected at admission: drop
                    pi, r = routed
                    d_cnt[pi] = d_cnt.get(pi, 0) - 1
                    d_load[pi] = d_load.get(pi, 0.0) - r
                    sub.setdefault(pi, []).append(e)
                    continue
                # arrival: route, admit or reject
                live = provisioned()
                loads = [p.load() + d_load.get(p.index, 0.0) for p in live]
                caps = [p.tenant_count() + d_cnt.get(p.index, 0)
                        < fleet.max_tenants_per_package for p in live]
                ci, rr_cursor = pick_package(loads, caps, fleet.routing,
                                             rr_cursor)
                if ci < 0 and fleet.autoscale:
                    p_new = scale_up(e.t)
                    if p_new is not None:
                        live = provisioned()
                        ci = live.index(p_new)
                if ci < 0:
                    n_rejected += 1
                    reject_c.inc()
                    continue
                p = live[ci]
                n_admitted += 1
                admit_c.inc()
                r = float(e.rate) if e.rate is not None else 1.0
                tenant_pkg[e.tenant] = (p.index, r)
                d_cnt[p.index] = d_cnt.get(p.index, 0) + 1
                d_load[p.index] = d_load.get(p.index, 0.0) + r
                sub.setdefault(p.index, []).append(e)
            # deliver: each routed package closes its pending epoch at t
            for pi, p_evs in sub.items():
                p = pkgs[pi]
                next_dep = {e.tenant for e in p_evs if e.kind == "depart"}
                p.flush(t, next_dep, False)
                p.buffered = (t, p_evs)
                maybe_scale_down(p, t)
            buffered_now = sum(len(p.buffered[1]) for p in pkgs
                               if p.buffered is not None)
            max_buffered = max(max_buffered, buffered_now)
            pkg_gauge.set(len(provisioned()))
            tenants_g.set(len(tenant_pkg))
        # horizon: close every provisioned package
        for p in pkgs:
            if not p.provisioned:
                continue
            if p.buffered is not None:
                p.flush(horizon, set(), True)
            elif not p.server._started:
                # never received an event: pure static burn
                idle_e = idle_w * max(0.0, horizon - p.server.created_at)
                p.server.loop.total_energy += idle_e
                p.server.loop.idle_energy += idle_e

    # ---- fold ----------------------------------------------------------
    loops = [p.server.loop for p in pkgs]
    total_energy = sum(lo.total_energy for lo in loops)
    idle_energy = sum(lo.idle_energy for lo in loops)
    busy_s = sum(lo.busy for lo in loops)
    offered = sum(lo.requests_offered for lo in loops)
    served_req = sum(lo.requests_served for lo in loops)
    replans = sum(lo.n_replans for lo in loops)
    hits = sum(lo.n_hits for lo in loops)
    wall = sum(lo.replan_wall for lo in loops)

    per_class = tuple(class_stats[nm].as_class_qos(nm, SLO_CLASSES[nm].weight)
                      for nm in sorted(SLO_CLASSES))
    served_weight = sum(s.w_total for s in class_stats.values())
    attainment = pooled.attainment
    fleet_edp = total_energy * horizon
    score = fleet_edp / attainment if attainment > 0 else (
        float("nan") if math.isnan(attainment) else float("inf"))
    per_package = tuple(PackageSummary(
        index=p.index, provisioned=p.provisioned,
        n_tenants_end=len(p.server.active),
        total_energy=p.server.loop.total_energy,
        idle_energy=p.server.loop.idle_energy,
        busy_s=p.server.loop.busy,
        n_replans=p.server.loop.n_replans,
        n_memo_hits=p.server.loop.n_hits,
        requests_served=p.server.loop.requests_served) for p in pkgs)
    return FleetReport(
        name=name, routing=fleet.routing, horizon=horizon,
        n_events=n_events, n_packages=len(pkgs),
        n_provisioned_end=len(provisioned()), peak_packages=peak,
        total_energy=total_energy, idle_energy=idle_energy, busy_s=busy_s,
        fleet_edp=fleet_edp, requests_offered=offered,
        requests_served=served_req, served_weight=served_weight,
        per_class=per_class, weighted_p50=pooled.percentile(50.0),
        weighted_p99=pooled.percentile(99.0),
        weighted_miss_rate=pooled.miss_rate, attainment=attainment,
        score=score,
        edp_per_request=(fleet_edp / served_req) if served_req > 0
        else float("inf"),
        admitted_tenants=n_admitted, rejected_tenants=n_rejected,
        scale_ups=scale_ups, scale_downs=scale_downs,
        n_replans=replans, n_memo_hits=hits, replan_wall_s=wall,
        max_buffered_events=max_buffered, per_package=per_package)
