"""The paper's ten multi-model workload scenarios (Table II), the mesh and
NoC presets, and the online trace presets (``get_trace``)."""
from __future__ import annotations

from .chiplet import NoCConfig
from .modelzoo import get_model
from .workload import Scenario

# (scenario name, use case, [(model, batch), ...]) — exactly Table II.
_TABLE_II: list[tuple[str, str, list[tuple[str, int]]]] = [
    ("dc1_lms", "datacenter", [("gpt-l", 1), ("bert-l", 3)]),
    ("dc2_lms_image_light", "datacenter",
     [("gpt-l", 1), ("bert-l", 3), ("resnet-50", 1)]),
    ("dc3_lms_image_heavy", "datacenter",
     [("gpt-l", 1), ("bert-l", 3), ("resnet-50", 32)]),
    ("dc4_lms_seg_image", "datacenter",
     [("gpt-l", 8), ("bert-l", 24), ("u-net", 1), ("resnet-50", 32)]),
    ("dc5_lms_seg_image_wide", "datacenter",
     [("gpt-l", 8), ("bert-l", 24), ("bert-base", 24), ("u-net", 1),
      ("resnet-50", 32), ("googlenet", 32)]),
    ("xr6_ar_assistant", "arvr",
     [("d2go", 10), ("planercnn", 15), ("midas", 30), ("emformer", 3),
      ("hrvit", 10)]),
    ("xr7_ar_gaming", "arvr",
     [("planercnn", 15), ("hand-sp", 45), ("midas", 30)]),
    ("xr8_outdoors", "arvr", [("d2go", 30), ("emformer", 3)]),
    ("xr9_social", "arvr", [("eyecod", 60), ("hand-sp", 30), ("sp2dense", 30)]),
    ("xr10_vr_gaming", "arvr", [("eyecod", 60), ("hand-sp", 45)]),
]

SCENARIO_NAMES = [name for name, _, _ in _TABLE_II]
DATACENTER = [n for n, uc, _ in _TABLE_II if uc == "datacenter"]
ARVR = [n for n, uc, _ in _TABLE_II if uc == "arvr"]

# Mesh configurations the sweeps run at.  The paper evaluates 3x3 and 6x6
# packages; 8x8 and 16x16 extend toward pod-scale MCMs (MCMComm / Scope
# territory) now that candidate construction and window combination are both
# vectorized.  ``LARGE_MESHES`` is what the nightly smoke sweep and the
# construction benchmark exercise.
MESH_PRESETS: dict[str, tuple[int, int]] = {
    "3x3": (3, 3),
    "6x6": (6, 6),
    "8x8": (8, 8),
    "16x16": (16, 16),
}
LARGE_MESHES = ("8x8", "16x16")

# Interposer NoC presets for the congestion comm model
# (``SearchConfig.comm_model="congestion"``).  ``uniform`` matches the
# analytic model's flat 100 GB/s NoP (so zero co-tenant overlap reproduces
# the analytic latencies exactly); ``het_rows`` models a silicon interposer
# with wide row buses and narrower column links (the asymmetric-link regime
# of MCMComm-style interposer studies); ``narrow`` is a contention-heavy
# organic-substrate point where routed corrections dominate.
NOC_PRESETS: dict[str, NoCConfig] = {
    "uniform": NoCConfig(),
    "het_rows": NoCConfig(h_bw=100e9, v_bw=50e9, congestion_alpha=0.5),
    "narrow": NoCConfig(h_bw=40e9, v_bw=25e9, congestion_alpha=0.7),
}


def noc_config(preset: str) -> NoCConfig:
    """The named interposer NoC preset (``"het_rows"`` -> ``NoCConfig``)."""
    try:
        return NOC_PRESETS[preset]
    except KeyError:
        raise KeyError(f"unknown NoC preset {preset!r}; "
                       f"have {sorted(NOC_PRESETS)}") from None


def mesh_shape(preset: str) -> tuple[int, int]:
    """(rows, cols) for a named mesh preset (``"8x8"`` -> ``(8, 8)``)."""
    try:
        return MESH_PRESETS[preset]
    except KeyError:
        raise KeyError(f"unknown mesh preset {preset!r}; "
                       f"have {sorted(MESH_PRESETS)}") from None


# Online trace presets (the dynamic analogue of the static Table II rows).
# Values are the generator parameters of ``repro_torch.online.traces``;
# build one with ``get_trace``.  Times are simulated seconds.
# ``dc_churn_6x6`` is the bench/fixture workload (datacenter tenants on a
# 6x6 package); ``dc_churn_smoke`` is the short nightly/CI variant; the
# ``*_cadence`` presets replay Table II AR/VR scenarios at their paper
# frame rates.
# Tenant zoo the churn presets sample from: a 4-entry subset of the full
# Table II datacenter zoo (``repro_torch.online.traces.DC_TENANT_ZOO``, the
# generator default), chosen so realistic mix recurrence shows up within a
# bench-sized horizon.  Changing it invalidates the committed fixtures and
# the online bench baseline — regenerate both together.
_DC_CHURN_ZOO = (("gpt-l", 1), ("bert-l", 3), ("bert-base", 24),
                 ("resnet-50", 32))
# SLO class mix the *_slo churn presets sample tenants from (the remaining
# probability mass is the default "standard" class).  Mirrors a serving
# fleet: a minority of interactive latency-critical tenants, a batch tail
# that is happy to be preempted.
_DC_SLO_MIX = {"latency_critical": 0.35, "best_effort": 0.35}
TRACE_PRESETS: dict[str, dict] = {
    "dc_churn_6x6": dict(kind="churn", seed=17, horizon=60.0,
                         arrival_rate=1.0, mean_lifetime=2.5, max_active=3,
                         zoo=_DC_CHURN_ZOO),
    "dc_churn_smoke": dict(kind="churn", seed=3, horizon=10.0,
                           arrival_rate=1.0, mean_lifetime=2.0, max_active=2,
                           zoo=_DC_CHURN_ZOO),
    # SLO-classed churn: the bench workload for the SLO-aware serving layer
    # (tenant priorities, sub-iteration preemption, MCM reconfiguration) on
    # an 8x8 package, and its short smoke/test variant on 3x3.  Changing
    # either invalidates the committed fixtures and the
    # BENCH_online_slo_8x8 baseline — regenerate together.
    "dc_churn_8x8_slo": dict(kind="churn", seed=29, horizon=40.0,
                             arrival_rate=1.2, mean_lifetime=2.5,
                             max_active=4, zoo=_DC_CHURN_ZOO,
                             slo_mix=_DC_SLO_MIX),
    "dc_churn_slo_smoke": dict(kind="churn", seed=11, horizon=12.0,
                               arrival_rate=1.0, mean_lifetime=2.0,
                               max_active=2, zoo=_DC_CHURN_ZOO,
                               slo_mix=_DC_SLO_MIX),
    "xr8_cadence": dict(kind="cadence", scenario="xr8_outdoors", horizon=0.5),
    "xr6_cadence": dict(kind="cadence", scenario="xr6_ar_assistant",
                        horizon=0.5),
    # Open-loop fleet churn: tenants carry request rates (diurnal + bursty
    # arrivals, log-uniform per-tenant demand) and are served by the
    # multi-package fleet driver (``repro_torch.online.fleet``).  The smoke
    # preset is test/doc sized; the bench builds its million-event trace
    # directly from ``iter_open_loop_churn`` so nothing that large is
    # materialised.
    "dc_fleet_smoke": dict(kind="open_churn", seed=23, horizon=30.0,
                           base_rate=0.8, mean_lifetime=4.0,
                           zoo=_DC_CHURN_ZOO, slo_mix=_DC_SLO_MIX,
                           request_rate=(0.5, 8.0)),
}


def get_trace(preset: str):
    """Build the named online trace preset (a ``Trace`` of
    ``repro_torch.online.traces``).

    Imported lazily: ``repro_torch.online`` depends on this package, so the
    trace generators can't be imported at module load without a cycle.
    """
    from repro_torch.online.traces import (frame_cadence_trace,
                                           open_loop_churn_trace,
                                           poisson_churn_trace)
    try:
        spec = dict(TRACE_PRESETS[preset])
    except KeyError:
        raise KeyError(f"unknown trace preset {preset!r}; "
                       f"have {sorted(TRACE_PRESETS)}") from None
    kind = spec.pop("kind")
    if kind == "churn":
        return poisson_churn_trace(name=preset, **spec)
    if kind == "open_churn":
        return open_loop_churn_trace(name=preset, **spec)
    return frame_cadence_trace(name=preset, **spec)


def iter_trace_events(preset: str):
    """Stream the named churn preset's events without materialising them.

    Returns ``(event iterator, horizon)``.  Yields exactly the events
    ``get_trace(preset)`` would materialise (pinned by the trace tests);
    cadence presets have no streaming form and raise ``KeyError``.
    """
    from repro_torch.online.traces import (iter_open_loop_churn,
                                           iter_poisson_churn)
    try:
        spec = dict(TRACE_PRESETS[preset])
    except KeyError:
        raise KeyError(f"unknown trace preset {preset!r}; "
                       f"have {sorted(TRACE_PRESETS)}") from None
    kind = spec.pop("kind")
    if kind == "churn":
        return iter_poisson_churn(**spec), spec["horizon"]
    if kind == "open_churn":
        return iter_open_loop_churn(**spec), spec["horizon"]
    raise KeyError(f"trace preset {preset!r} ({kind}) has no streaming form")


def get_scenario(name: str) -> Scenario:
    for sname, _, spec in _TABLE_II:
        if sname == name:
            return Scenario(sname, tuple(get_model(m, b) for m, b in spec))
    raise KeyError(f"unknown scenario {name!r}; have {SCENARIO_NAMES}")


def scenario_spec(name: str) -> list[tuple[str, int]]:
    """Table II row as (model-zoo key, batch) pairs.

    These are the zoo keys the online layer needs to rebuild models, vs
    the display names on ``Model.name``.
    """
    for sname, _, spec in _TABLE_II:
        if sname == name:
            return list(spec)
    raise KeyError(f"unknown scenario {name!r}; have {SCENARIO_NAMES}")


def all_scenarios() -> list[Scenario]:
    return [get_scenario(n) for n in SCENARIO_NAMES]
