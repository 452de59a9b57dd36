"""The paper's ten multi-model workload scenarios (Table II)."""
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
