"""Tenant SLO classes and the class-weighted serving objective.

SCAR's two application settings are service-level problems: a datacenter
package and an AR/VR device both care about *which* tenant misses its
deadline, not just aggregate EDP.  This module is the single source of
truth for the service classes the online layer understands:

* ``latency_critical`` — interactive / sensor-locked tenants.  Highest
  objective weight, tightest per-iteration deadline, never preemptible.
* ``standard``         — the default for every tenant that does not declare
  a class (including all PR 3-era traces, which predate the field).
* ``best_effort``      — batch / background tenants.  Lowest weight, no
  deadline, and *preemptible*: an epoch-boundary re-plan may pause their
  in-flight iteration at a resumable chunk boundary instead of draining it
  (see ``simulator.OnlinePolicy``).

Deadlines are **relative**: an iteration served at observed latency ``l``
against a planned per-model latency ``pml`` meets its SLO iff
``l <= deadline_factor * pml``.  Planned latency alone therefore never
misses (factors are > 1) — misses are caused by queueing: re-plan drain,
preemption resume, or arrival waits.  Relative deadlines keep every preset
meaningful across mesh sizes and model mixes without hand-tuned absolute
budgets, and make the SLO benches fully deterministic (simulated time
only, no wall clock).

The class-weighted objective used by the SLO-aware re-scheduler
(``rescheduler.SLORescheduler``) to score MCM reconfiguration candidates
and by ``metrics.slo_report`` is ``class_weighted_score``: the weighted
mean of per-tenant latencies combined with package energy under the
configured metric.  With every tenant in one class it is a positive
multiple of the unweighted mean — so class-blind decisions and metrics are
the exact single-class reduction (pinned by
``tests/test_torch_online_slo.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class: objective weight + deadline + preemptibility."""

    name: str
    weight: float              # class-weighted objective / metrics weight
    deadline_factor: float     # iteration deadline = factor * planned pml
    preemptible: bool          # may an epoch re-plan pause in-flight work?


LATENCY_CRITICAL = "latency_critical"
STANDARD = "standard"
BEST_EFFORT = "best_effort"
DEFAULT_SLO = STANDARD

SLO_CLASSES: dict[str, SLOClass] = {
    LATENCY_CRITICAL: SLOClass(LATENCY_CRITICAL, weight=4.0,
                               deadline_factor=1.25, preemptible=False),
    STANDARD: SLOClass(STANDARD, weight=1.0,
                       deadline_factor=2.0, preemptible=False),
    BEST_EFFORT: SLOClass(BEST_EFFORT, weight=0.25,
                          deadline_factor=math.inf, preemptible=True),
}


def get_slo(name: Optional[str]) -> SLOClass:
    """Resolve a class name (``None`` -> the back-compat default class)."""
    if name is None:
        name = DEFAULT_SLO
    try:
        return SLO_CLASSES[name]
    except KeyError:
        raise KeyError(f"unknown SLO class {name!r}; "
                       f"have {sorted(SLO_CLASSES)}") from None


def class_weighted_latency(per_model_latency: Mapping[int, float],
                           slo_of_model: Mapping[int, str]) -> float:
    """Weighted mean of per-model latencies, weights from SLO classes.

    ``slo_of_model`` maps model index -> class name; missing indices take
    the default class.  All-one-class reduction: the weights cancel and the
    result is the plain mean latency.
    """
    if not per_model_latency:
        return 0.0
    num = den = 0.0
    for mi, lat in per_model_latency.items():
        w = get_slo(slo_of_model.get(mi)).weight
        num += w * lat
        den += w
    return num / den


def class_weighted_score(per_model_latency: Mapping[int, float],
                         energy: float, slo_of_model: Mapping[int, str],
                         metric: str = "edp") -> float:
    """Scalar objective of one candidate plan for an active tenant mix.

    The online analogue of ``ScheduleResult.metric``: latency enters as the
    class-weighted mean of per-tenant latencies (what the tenants experience,
    weighted by how much the operator cares), energy as the package total.
    Lower is better for every metric.
    """
    wlat = class_weighted_latency(per_model_latency, slo_of_model)
    if metric == "latency":
        return wlat
    if metric == "energy":
        return energy
    if metric == "edp":
        return wlat * energy
    raise KeyError(metric)
