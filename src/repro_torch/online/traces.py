"""Trace IR + deterministic seeded trace generators (materialised & streamed).

A ``Trace`` is an immutable, time-sorted tuple of ``Event`` records plus the
generator parameters that produced it, serializable to/from JSON so traces
can be saved, replayed, and committed as test fixtures
(``tests/fixtures/trace_*.json``).  Three shapes:

* **churn** (datacenter multi-tenancy): Poisson tenant arrivals over the
  Table II datacenter model zoo, exponential tenant lifetimes.  Each
  ``arrive``/``depart`` pair shares a ``tenant`` id; the simulator re-plans
  the package at every such epoch.
* **open-loop churn**: churn where every tenant additionally carries an
  offered request rate (``Event.rate``, requests/s) and arrivals follow a
  seeded non-homogeneous Poisson process (diurnal sinusoid x two-state
  bursty modulation, sampled by thinning).  The simulator then serves
  *demand* instead of saturating — see ``docs/fleet.md``.
* **cadence** (AR/VR): each model of a Table II AR/VR scenario fires
  periodically at its paper frame rate (the Table II batch column is Hz —
  e.g. ``midas`` at 30 Hz) with deadline one period, replayed against the
  static schedule's per-model latencies.

Event ordering — the total order
--------------------------------

Simultaneous events are ordered by ``Event.sort_key() ==
(t, _KIND_ORDER[kind], tenant)``:

1. **time** first (rounded to 1 ns by the generators);
2. **kind**: ``depart`` (0) before ``arrive`` (1) before ``frame`` (2) — a
   departure at time *t* frees package capacity before any arrival at the
   same *t* is admitted, matching the generators' strict ``d > t``
   residency test;
3. **tenant id** last, so the order is *total*: any multiset of distinct
   ``(t, kind, tenant)`` events has exactly one sorted order, generation is
   reproducible across processes, and the streaming merge below is
   deterministic and permutation-invariant (hypothesis-pinned in
   ``tests/test_torch_online.py``).

Streaming: every generator has an ``iter_*`` twin yielding the identical
event stream lazily (same seed => same events, pinned event-for-event
against the committed fixtures), so million-event traces never materialise
a list; ``merge_events`` merges sorted streams without sorting.

Determinism: generation consumes ``numpy`` Generators seeded from the
``seed`` field only — the same seed yields the identical event stream in
any process (pinned by ``tests/test_torch_online.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import json
import math
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

# Default tenant zoo for datacenter churn: the (model, batch) entries of
# Table II's datacenter scenarios, deduplicated.  Kept module-level so traces
# stay reproducible across refactors of the scenario table.  Note the churn
# presets (``scenarios.TRACE_PRESETS``) pass an explicit 4-entry subset
# (``scenarios._DC_CHURN_ZOO``) instead of this default.
DC_TENANT_ZOO: tuple[tuple[str, int], ...] = (
    ("gpt-l", 1), ("bert-l", 3), ("bert-base", 24),
    ("resnet-50", 32), ("u-net", 1), ("googlenet", 32),
)

# Kind priority of the total order (see module docstring): departures free
# capacity before same-timestamp arrivals; frames sort after both.
_KIND_ORDER = {"depart": 0, "arrive": 1, "frame": 2}


@dataclasses.dataclass(frozen=True)
class Event:
    """One trace event.

    ``kind``: ``arrive`` / ``depart`` (churn) or ``frame`` (cadence).
    ``tenant``: unique tenant id (churn) or the scenario model index
    (cadence).  ``deadline`` is seconds after ``t`` (frame events only).
    ``slo`` names the tenant's service class (``repro_torch.online.slo``); the
    field is optional and ``None`` on every pre-SLO trace — readers resolve
    it through ``slo.get_slo`` so legacy fixtures land in the default
    (``standard``) class.  ``rate`` is the tenant's offered load in
    requests (iterations) per second; ``None`` — every pre-open-loop trace
    — means closed-loop (the tenant saturates the package).  Sort with
    ``sort_key`` — the documented total order ``(t, kind-priority,
    tenant)``, departures before arrivals before frames at equal ``t`` —
    deliberately no dataclass ordering, which would disagree with it.
    """

    t: float
    kind: str
    model: str
    tenant: int
    batch: int = 1
    deadline: Optional[float] = None
    slo: Optional[str] = None
    rate: Optional[float] = None

    def sort_key(self) -> tuple:
        return (self.t, _KIND_ORDER[self.kind], self.tenant)


def merge_events(*streams: Iterable[Event]) -> Iterator[Event]:
    """Merge individually-sorted event streams into one sorted stream.

    Lazy ``heapq.merge`` on ``Event.sort_key`` — memory is O(#streams), not
    O(#events), so fleet traces built from per-source generators never
    materialise.  Because ``sort_key`` is a total order on distinct
    ``(t, kind, tenant)`` triples, the merged order is deterministic and
    independent of how events are partitioned across the input streams
    (hypothesis-pinned in ``tests/test_torch_online.py``).
    """
    return heapq.merge(*streams, key=Event.sort_key)


@dataclasses.dataclass(frozen=True)
class Trace:
    """An immutable, time-sorted event stream plus its provenance."""

    name: str
    kind: str                      # "churn" | "cadence"
    horizon: float                 # simulated seconds the trace covers
    events: tuple[Event, ...]
    seed: Optional[int] = None     # generator seed (None: hand-built)
    scenario: Optional[str] = None  # source scenario (cadence traces)

    def __post_init__(self) -> None:
        keys = [e.sort_key() for e in self.events]
        if keys != sorted(keys):
            raise ValueError("trace events must be (t, kind, tenant)-sorted")

    @property
    def n_events(self) -> int:
        return len(self.events)

    # ---- serialization ----------------------------------------------------
    def to_json(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "horizon": self.horizon,
            "seed": self.seed, "scenario": self.scenario,
            "events": [dataclasses.asdict(e) for e in self.events],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "Trace":
        return cls(name=obj["name"], kind=obj["kind"],
                   horizon=float(obj["horizon"]), seed=obj.get("seed"),
                   scenario=obj.get("scenario"),
                   events=tuple(Event(**e) for e in obj["events"]))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


# ---------------------------------------------------------------------------
# streaming emission
# ---------------------------------------------------------------------------

def _sorted_stream(pairs: Iterable[tuple[Event, Optional[Event]]]
                   ) -> Iterator[Event]:
    """Emit (arrive, optional depart) pairs as one sorted event stream.

    Correctness rests on two generator invariants: arrivals come in
    non-decreasing (rounded) time, and tenant ids are assigned in strictly
    increasing order.  Every future event then sorts at-or-after the current
    arrival's rounded time, so any pending event *strictly earlier* is safe
    to emit; same-time events stay in the heap until time strictly
    advances, which resolves all ``sort_key`` ties (including a zero-length
    tenancy whose rounded depart equals its arrive) exactly like the
    global materialised sort.  Pending size is O(active tenants).
    """
    pending: list[tuple[tuple, Event]] = []
    for arr, dep in pairs:
        while pending and pending[0][0][0] < arr.t:
            yield heapq.heappop(pending)[1]
        heapq.heappush(pending, (arr.sort_key(), arr))
        if dep is not None:
            heapq.heappush(pending, (dep.sort_key(), dep))
    while pending:
        yield heapq.heappop(pending)[1]


# ---------------------------------------------------------------------------
# closed-loop Poisson churn
# ---------------------------------------------------------------------------

def iter_poisson_churn(seed: int, horizon: float,
                       arrival_rate: float, mean_lifetime: float,
                       zoo: Sequence[tuple[str, int]] = DC_TENANT_ZOO,
                       max_active: int = 4,
                       slo_mix: Optional[dict[str, float]] = None
                       ) -> Iterator[Event]:
    """Stream the exact event sequence of ``poisson_churn_trace``.

    Identical RNG trajectory (gap, model, lifetime, then the SLO draw only
    for admitted tenants) and identical ordering to the materialised
    generator — pinned event-for-event against the committed fixtures in
    ``tests/test_torch_online.py`` — but lazy: memory is
    O(``max_active``), so million-event traces stream at bounded memory.
    """
    rng = np.random.default_rng(seed)
    mix: list[tuple[str, float]] = []
    if slo_mix:
        from .slo import DEFAULT_SLO, get_slo
        for cls_name in sorted(slo_mix):
            get_slo(cls_name)            # validate early
            mix.append((cls_name, float(slo_mix[cls_name])))

    def pairs() -> Iterator[tuple[Event, Optional[Event]]]:
        active: list[float] = []         # departure-time min-heap
        tenant = 0
        t = float(rng.exponential(1.0 / arrival_rate))
        while t < horizon:
            model, batch = zoo[int(rng.integers(0, len(zoo)))]
            life = float(rng.exponential(mean_lifetime))
            # residency test d > t: pop expired entries, count the rest —
            # the O(log n) equivalent of the old full-list scan
            while active and active[0] <= t:
                heapq.heappop(active)
            if len(active) < max_active:
                slo = None
                if mix:
                    u, acc = float(rng.random()), 0.0
                    slo = DEFAULT_SLO
                    for cls_name, p in mix:
                        acc += p
                        if u < acc:
                            slo = cls_name
                            break
                arr = Event(t=round(t, 9), kind="arrive", model=model,
                            tenant=tenant, batch=batch, slo=slo)
                depart = t + life
                dep = Event(t=round(depart, 9), kind="depart", model=model,
                            tenant=tenant, batch=batch, slo=slo) \
                    if depart < horizon else None
                heapq.heappush(active, depart)
                tenant += 1
                yield arr, dep
            t += float(rng.exponential(1.0 / arrival_rate))

    return _sorted_stream(pairs())


def poisson_churn_trace(seed: int, horizon: float,
                        arrival_rate: float, mean_lifetime: float,
                        zoo: Sequence[tuple[str, int]] = DC_TENANT_ZOO,
                        max_active: int = 4,
                        slo_mix: Optional[dict[str, float]] = None,
                        name: Optional[str] = None) -> Trace:
    """Seeded Poisson tenant churn over the datacenter model zoo.

    Tenants arrive as a Poisson process of ``arrival_rate`` per simulated
    second, each running a model sampled uniformly from ``zoo`` for an
    exponential lifetime of mean ``mean_lifetime`` seconds.  Arrivals that
    would push the active count past ``max_active`` are dropped (admission
    control keeps provisioning feasible on small packages).  Lifetimes are
    clipped at the horizon — tenants still resident simply stay resident; no
    synthetic departure events are emitted.

    ``slo_mix`` maps SLO class names (``repro_torch.online.slo``) to sampling
    probabilities (need not sum to 1 — the remainder is the default class);
    each admitted tenant draws its class once and both its arrive and
    depart events carry it.  ``None`` draws nothing, so pre-SLO presets
    replay the exact event stream they always produced (same RNG
    trajectory).

    Materialises ``iter_poisson_churn`` — one generator, two shapes.
    """
    events = tuple(iter_poisson_churn(seed, horizon, arrival_rate,
                                      mean_lifetime, zoo=zoo,
                                      max_active=max_active,
                                      slo_mix=slo_mix))
    return Trace(name=name or f"dc_churn_seed{seed}", kind="churn",
                 horizon=horizon, events=events, seed=seed)


# ---------------------------------------------------------------------------
# open-loop churn (offered load; diurnal + bursty arrivals)
# ---------------------------------------------------------------------------

def iter_open_loop_churn(seed: int, horizon: float,
                         base_rate: float, mean_lifetime: float,
                         zoo: Sequence[tuple[str, int]] = DC_TENANT_ZOO,
                         max_active: Optional[int] = None,
                         slo_mix: Optional[dict[str, float]] = None,
                         request_rate: tuple[float, float] = (5.0, 50.0),
                         diurnal_amplitude: float = 0.5,
                         diurnal_period: float = 60.0,
                         burst_factor: float = 3.0,
                         burst_mean_on: float = 2.0,
                         burst_mean_off: float = 10.0,
                         block: int = 4096) -> Iterator[Event]:
    """Stream open-loop tenant churn with diurnal + bursty arrivals.

    Arrivals are a non-homogeneous Poisson process sampled by thinning at
    the peak intensity: the instantaneous rate is ``base_rate`` modulated
    by a diurnal sinusoid (``1 + diurnal_amplitude * sin(...)``, period
    ``diurnal_period`` seconds, starting at the trough) and a two-state
    Markov burst process (rate x ``burst_factor`` during bursts; dwell
    times exponential with means ``burst_mean_on`` / ``burst_mean_off``).
    Each admitted tenant draws a model from ``zoo``, an exponential
    lifetime, an offered request rate log-uniform over ``request_rate``
    (carried on ``Event.rate``, requests/s), and optionally an SLO class
    from ``slo_mix``.

    ``max_active=None`` leaves admission to the serving layer (the fleet
    router drops departures of tenants it rejected), which is the normal
    open-loop configuration; an integer cap replicates the closed-loop
    generator's admission test.  Candidate arrivals and thinning draws are
    consumed from independent spawned substreams in vectorised blocks of
    ``block``, so million-event generation is numpy-bound, deterministic
    in ``seed`` alone, and streams at O(active-tenants) memory.
    """
    if not 0.0 <= diurnal_amplitude < 1.0:
        raise ValueError("diurnal_amplitude must be in [0, 1)")
    if burst_factor < 1.0:
        raise ValueError("burst_factor must be >= 1")
    root = np.random.default_rng(seed)
    rng_arr, rng_burst, rng_tenant = root.spawn(3)
    lam_max = base_rate * (1.0 + diurnal_amplitude) * burst_factor
    lo, hi = request_rate
    if not (0.0 < lo <= hi):
        raise ValueError("request_rate must be 0 < lo <= hi")
    mix: list[tuple[str, float]] = []
    if slo_mix:
        from .slo import DEFAULT_SLO, get_slo
        for cls_name in sorted(slo_mix):
            get_slo(cls_name)
            mix.append((cls_name, float(slo_mix[cls_name])))

    def burst_toggles() -> Iterator[tuple[float, bool]]:
        # (time, bursting-from-here) toggle stream; starts quiet at t=0
        t, on = 0.0, False
        while t < horizon:
            mean = burst_mean_on if on else burst_mean_off
            t += float(rng_burst.exponential(mean))
            on = not on
            yield t, on

    def accepted_arrivals() -> Iterator[float]:
        toggles = burst_toggles()
        next_toggle, next_on = next(toggles)
        on = False
        t = 0.0
        while True:
            gaps = rng_arr.exponential(1.0 / lam_max, size=block)
            us = rng_arr.random(size=block)
            for g, u in zip(gaps, us):
                t += float(g)
                if t >= horizon:
                    return
                while t >= next_toggle:
                    on = next_on
                    next_toggle, next_on = next(toggles)
                diurnal = 1.0 + diurnal_amplitude * math.sin(
                    2.0 * math.pi * t / diurnal_period - math.pi / 2.0)
                lam = base_rate * diurnal * (burst_factor if on else 1.0)
                if u < lam / lam_max:
                    yield t

    def pairs() -> Iterator[tuple[Event, Optional[Event]]]:
        active: list[float] = []
        tenant = 0
        for t in accepted_arrivals():
            if max_active is not None:
                while active and active[0] <= t:
                    heapq.heappop(active)
                if len(active) >= max_active:
                    continue
            model, batch = zoo[int(rng_tenant.integers(0, len(zoo)))]
            life = float(rng_tenant.exponential(mean_lifetime))
            rate = float(np.exp(rng_tenant.uniform(np.log(lo), np.log(hi))))
            slo = None
            if mix:
                u, acc = float(rng_tenant.random()), 0.0
                slo = DEFAULT_SLO
                for cls_name, p in mix:
                    acc += p
                    if u < acc:
                        slo = cls_name
                        break
            arr = Event(t=round(t, 9), kind="arrive", model=model,
                        tenant=tenant, batch=batch, slo=slo,
                        rate=round(rate, 6))
            depart = t + life
            dep = Event(t=round(depart, 9), kind="depart", model=model,
                        tenant=tenant, batch=batch, slo=slo,
                        rate=round(rate, 6)) if depart < horizon else None
            if max_active is not None:
                heapq.heappush(active, depart)
            tenant += 1
            yield arr, dep

    return _sorted_stream(pairs())


def open_loop_churn_trace(seed: int, horizon: float,
                          base_rate: float, mean_lifetime: float,
                          name: Optional[str] = None,
                          **kwargs) -> Trace:
    """Materialise ``iter_open_loop_churn`` into a ``Trace``.

    For small traces (fixtures, docs examples); fleet-scale runs should
    feed the iterator straight into ``online.fleet.simulate_fleet``.
    """
    events = tuple(iter_open_loop_churn(seed, horizon, base_rate,
                                        mean_lifetime, **kwargs))
    return Trace(name=name or f"open_churn_seed{seed}", kind="churn",
                 horizon=horizon, events=events, seed=seed)


# ---------------------------------------------------------------------------
# AR/VR frame cadence
# ---------------------------------------------------------------------------

def iter_frame_cadence(scenario: str, horizon: float,
                       slo_of: Optional[dict[str, str]] = None
                       ) -> Iterator[Event]:
    """Stream the exact event sequence of ``frame_cadence_trace``.

    One lazy periodic generator per scenario model, merged with
    ``merge_events`` — every ``(t, frame, model-index)`` key is distinct,
    so the merge equals the materialised global sort event-for-event
    (pinned in ``tests/test_torch_online.py``) at O(#models) memory.
    """
    from repro_torch.core.scenarios import scenario_spec
    if slo_of:
        from .slo import get_slo
        for cls_name in slo_of.values():
            get_slo(cls_name)            # validate early

    def model_frames(mi: int, model: str, rate: float) -> Iterator[Event]:
        period = 1.0 / float(rate)       # Table II: AR/VR batch == Hz
        slo = (slo_of or {}).get(model)
        for k in itertools.count():
            t = k * period
            if t >= horizon:
                return
            yield Event(t=round(t, 9), kind="frame", model=model, tenant=mi,
                        batch=1, deadline=period, slo=slo)

    streams = [model_frames(mi, model, rate) for mi, (model, rate)
               in enumerate(scenario_spec(scenario))]
    return merge_events(*streams)


def frame_cadence_trace(scenario: str, horizon: float,
                        slo_of: Optional[dict[str, str]] = None,
                        name: Optional[str] = None) -> Trace:
    """Periodic frame-cadence trace for one Table II AR/VR scenario.

    Each model fires every ``1/rate`` seconds at its paper frame rate (the
    Table II batch column, Hz) with deadline one period — a frame missing
    its deadline means the model fell behind its sensor.  The simulator
    replays frames (single batch-1 inferences) against a schedule of the
    scenario's concurrent model set planned at batch 1.  ``slo_of`` maps
    model-zoo keys to SLO class names (unlisted models keep the default
    class; ``None`` leaves every frame classless, the pre-SLO format).

    Materialises ``iter_frame_cadence`` — one generator, two shapes.
    """
    events = tuple(iter_frame_cadence(scenario, horizon, slo_of=slo_of))
    return Trace(name=name or f"{scenario}_cadence", kind="cadence",
                 horizon=horizon, events=events, seed=None,
                 scenario=scenario)
