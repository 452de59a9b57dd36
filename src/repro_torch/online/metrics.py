"""QoS accounting over a finished online simulation.

Metric definitions (documented in ``docs/architecture.md``):

* **per-model p50/p99 latency** — weighted percentiles over the simulation's
  latency samples.  A sample is (latency, weight): for churn traces one
  sample per (epoch, tenant) weighted by the iterations served in that
  epoch; for cadence traces one unit-weight sample per frame (queueing
  delay included).  The p-th percentile is the smallest sampled latency
  whose cumulative weight fraction reaches ``p`` (weighted
  inverted-CDF — deterministic and hand-checkable, no interpolation).
* **deadline-miss rate** — cadence only: missed frames / total frames per
  model (a frame misses when completion exceeds arrival + one period).
* **aggregate EDP** — total package energy x busy time (the online analogue
  of the static ``ScheduleResult.edp``; idle intervals contribute neither).
* **scheduler overhead** — planner wall-clock seconds spent re-planning
  divided by simulated seconds: how much of real time the scheduler would
  steal from serving if it ran inline on the host.

``slo_report`` adds the service-level view over the same simulation
(``simulator.SLOSample`` stream): per-SLO-class p50/p99 and deadline-miss
rates, class-*weighted* pooled percentiles and miss rate (each sample's
weight scaled by its class weight from ``repro_torch.online.slo``), the
weighted SLO attainment (1 - weighted miss rate), and a combined EDP/SLO
score — aggregate EDP divided by attainment, so missed deadlines inflate
the effective EDP a schedule is judged by.  With every sample in one class the
weighted metrics reduce *exactly* to the unweighted pooled ones (the class
weight cancels; pinned by ``tests/test_torch_online_slo.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch import obs

from .simulator import SimResult
from .slo import get_slo


def weighted_percentile(samples: list[tuple[float, float]], p: float) -> float:
    """Smallest value whose cumulative weight fraction reaches ``p`` (0-100).

    An empty sample set has no percentile: returns ``nan`` (NaN-tagged, not
    a silent 0.0) so an admission-rejected class can never masquerade as a
    zero-latency one.  Callers that want a sentinel must check
    ``math.isnan`` explicitly.
    """
    if not samples:
        return float("nan")
    ordered = sorted(samples)
    total = sum(w for _, w in ordered)
    if total <= 0:
        return ordered[0][0]
    acc = 0.0
    for v, w in ordered:
        acc += w
        if acc >= total * (p / 100.0):
            return v
    return ordered[-1][0]


@dataclasses.dataclass(frozen=True)
class ModelQoS:
    """QoS of one model name across the whole trace."""

    model: str
    n_samples: float                   # total sample weight
    p50_latency: float
    p99_latency: float
    miss_rate: Optional[float] = None  # cadence traces only


@dataclasses.dataclass(frozen=True)
class QoSReport:
    trace: str
    mode: str
    per_model: tuple[ModelQoS, ...]
    total_energy: float
    busy_s: float
    aggregate_edp: float
    n_epochs: int
    n_replans: int
    n_memo_hits: int
    replan_wall_s: float
    overhead_ratio: float              # replan wall s / simulated s

    def model(self, name: str) -> ModelQoS:
        for m in self.per_model:
            if m.model == name:
                return m
        raise KeyError(name)


def qos_report(sim: SimResult) -> QoSReport:
    """Fold a ``SimResult`` into the QoS metrics above."""
    misses: dict[str, list[bool]] = {}
    for f in sim.frames:
        misses.setdefault(f.model, []).append(f.missed)
    per_model = []
    for name in sorted(sim.latency_samples):
        s = sim.latency_samples[name]
        mm = misses.get(name)
        per_model.append(ModelQoS(
            model=name,
            n_samples=sum(w for _, w in s),
            p50_latency=weighted_percentile(s, 50.0),
            p99_latency=weighted_percentile(s, 99.0),
            miss_rate=(sum(mm) / len(mm)) if mm else None))
    horizon = sim.trace.horizon or 1.0
    return QoSReport(
        trace=sim.trace.name, mode=sim.mode, per_model=tuple(per_model),
        total_energy=sim.total_energy, busy_s=sim.busy_s,
        aggregate_edp=sim.total_energy * sim.busy_s,
        n_epochs=len(sim.epochs), n_replans=sim.n_replans,
        n_memo_hits=sim.n_memo_hits, replan_wall_s=sim.replan_wall_s,
        overhead_ratio=sim.replan_wall_s / horizon)


# ---------------------------------------------------------------------------
# SLO-class view
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassQoS:
    """QoS of one SLO class pooled across models and tenants."""

    slo: str
    weight: float                      # the class's objective weight
    n_samples: float                   # total sample weight in the class
    p50_latency: float
    p99_latency: float
    miss_rate: float                   # missed weight / total weight
    attainment: float                  # 1 - miss_rate


@dataclasses.dataclass(frozen=True)
class SLOReport:
    """Class-weighted service-level report (wraps the plain ``QoSReport``)."""

    base: QoSReport
    per_class: tuple[ClassQoS, ...]
    weighted_p50: float                # pooled, weights x class weight
    weighted_p99: float
    weighted_miss_rate: float
    slo_attainment: float              # 1 - weighted_miss_rate
    score: float                       # aggregate EDP / attainment (lower
    #                                    better; inf when nothing attained)
    served_weight: float               # iteration-equivalents served (sum of
    #                                    sample weights across all classes)
    edp_per_iteration: float           # aggregate EDP / served_weight — the
    #                                    work-normalised aggregate: saturated
    #                                    back-to-back serving packs more
    #                                    iterations into a fixed horizon when
    #                                    the scheduler frees the package
    #                                    sooner, so raw energy x busy alone
    #                                    would penalise serving *more*;
    #                                    per-iteration EDP compares policies
    #                                    at equal work
    n_preemptions: int
    n_switches: int
    # Live telemetry snapshot at report time: the ``online.*`` gauges and
    # counters from the process-global registry (``repro_torch.obs``), so a
    # report carries the serving-loop state it was computed under.  Default
    # keeps positional construction of older call sites working.
    gauges: dict = dataclasses.field(default_factory=dict)

    def cls(self, name: str) -> ClassQoS:
        for c in self.per_class:
            if c.slo == name:
                return c
        raise KeyError(name)


def slo_report(sim: SimResult) -> SLOReport:
    """Fold a simulation's ``SLOSample`` stream into the class view."""
    base = qos_report(sim)
    by_class: dict[str, list] = {}
    for s in sim.slo_samples:
        by_class.setdefault(get_slo(s.slo).name, []).append(s)
    per_class = []
    pooled: list[tuple[float, float]] = []
    w_miss = w_total = 0.0
    for name in sorted(by_class):
        cls = get_slo(name)
        ss = by_class[name]
        total = sum(s.weight for s in ss)
        missed = sum(s.missed for s in ss)
        cs = [(s.latency, s.weight) for s in ss]
        per_class.append(ClassQoS(
            slo=name, weight=cls.weight, n_samples=total,
            p50_latency=weighted_percentile(cs, 50.0),
            p99_latency=weighted_percentile(cs, 99.0),
            miss_rate=(missed / total) if total > 0 else float("nan"),
            attainment=(1.0 - missed / total) if total > 0
            else float("nan")))
        pooled.extend((s.latency, s.weight * cls.weight) for s in ss)
        w_miss += cls.weight * missed
        w_total += cls.weight * total
    # zero served weight across every class (e.g. everything rejected at
    # admission): the weighted metrics are undefined — NaN, not 0.0/1.0
    miss_rate = (w_miss / w_total) if w_total > 0 else float("nan")
    attainment = 1.0 - miss_rate
    served = sum(s.weight for s in sim.slo_samples)
    return SLOReport(
        base=base, per_class=tuple(per_class),
        weighted_p50=weighted_percentile(pooled, 50.0),
        weighted_p99=weighted_percentile(pooled, 99.0),
        weighted_miss_rate=miss_rate, slo_attainment=attainment,
        score=(base.aggregate_edp / attainment) if attainment > 0
        else (float("nan") if math.isnan(attainment) else float("inf")),
        served_weight=served,
        edp_per_iteration=(base.aggregate_edp / served) if served > 0
        else float("inf"),
        n_preemptions=sim.n_preemptions, n_switches=sim.n_switches,
        gauges={**obs.gauges(prefix="online."),
                **obs.counters(prefix="online.")})


# ---------------------------------------------------------------------------
# bounded-memory streaming accumulation (fleet-scale traces)
# ---------------------------------------------------------------------------

class StreamingStats:
    """Bounded-memory weighted latency/miss accumulator.

    Million-event fleet runs cannot retain per-sample lists, so this folds
    each observation into a fixed log-spaced histogram (``n_bins`` decades
    spanning [``lo``, ``hi``) seconds plus under/overflow bins — infinite
    latencies, i.e. unserved offered load, land in the overflow bin) and
    running weight/miss totals.  Percentiles come back as the *upper edge*
    of the bin holding the target cumulative weight — a deterministic upper
    bound within one bin width (~5% at the default resolution), and
    permutation-invariant because only sums are kept.  Empty accumulators
    report NaN everywhere, matching ``weighted_percentile``.
    """

    __slots__ = ("lo", "hi", "n_bins", "_scale", "_w", "w_total", "w_miss")

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 n_bins: int = 256) -> None:
        self.lo, self.hi, self.n_bins = lo, hi, n_bins
        self._scale = n_bins / math.log(hi / lo)
        self._w = [0.0] * (n_bins + 2)     # [under | bins | over/inf]
        self.w_total = 0.0
        self.w_miss = 0.0

    def add(self, latency: float, weight: float, missed: float = 0.0) -> None:
        if weight <= 0:
            return
        if latency < self.lo:
            b = 0
        elif not (latency < self.hi):      # hi, above, or inf
            b = self.n_bins + 1
        else:
            b = 1 + int(self._scale * math.log(latency / self.lo))
        self._w[b] += weight
        self.w_total += weight
        self.w_miss += missed

    def merge(self, other: "StreamingStats") -> None:
        if (other.lo, other.hi, other.n_bins) != (self.lo, self.hi,
                                                  self.n_bins):
            raise ValueError("cannot merge differently-binned stats")
        self._w = [a + b for a, b in zip(self._w, other._w)]
        self.w_total += other.w_total
        self.w_miss += other.w_miss

    def percentile(self, p: float) -> float:
        """Upper edge of the bin reaching cumulative weight fraction p."""
        if self.w_total <= 0:
            return float("nan")
        target = self.w_total * (p / 100.0)
        acc = 0.0
        for b, w in enumerate(self._w):
            acc += w
            if acc >= target and w > 0:
                if b == 0:
                    return self.lo
                if b == self.n_bins + 1:
                    return float("inf")
                return self.lo * math.exp(b / self._scale)
        return float("inf")

    @property
    def miss_rate(self) -> float:
        return (self.w_miss / self.w_total) if self.w_total > 0 \
            else float("nan")

    @property
    def attainment(self) -> float:
        return (1.0 - self.w_miss / self.w_total) if self.w_total > 0 \
            else float("nan")

    def as_class_qos(self, slo: str, weight: float) -> ClassQoS:
        """Freeze into the same ``ClassQoS`` record list-based reports use."""
        return ClassQoS(slo=slo, weight=weight, n_samples=self.w_total,
                        p50_latency=self.percentile(50.0),
                        p99_latency=self.percentile(99.0),
                        miss_rate=self.miss_rate,
                        attainment=self.attainment)
