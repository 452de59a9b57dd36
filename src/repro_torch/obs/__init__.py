"""Telemetry for the port: structured spans, counters and gauges.

The counterpart of ``repro.obs`` (stdlib only):

* **Spans** (``obs.span``) — nested, wall/CPU-timed, attributed phases,
  recorded only while tracing is enabled (``obs.enable`` or
  ``SCAR_TRACE=1``).  The disabled path returns a cached no-op singleton.
  Tracing is plan-invariant: nothing recorded feeds back into scheduling.
* **Counters / gauges** (``obs.counter`` / ``obs.gauge``) — the always-on
  process-global registry (``repro_torch.obs.registry``).  The cache sites
  (CostDB memo, window/candidate memo, frontier-path LRU), the kernel
  launch counts and the ``launch.platform`` sync count read through it.

* **Exporters** (``obs.export``) — ``obs.chrome_trace`` (Chrome-trace /
  Perfetto JSON), ``obs.summary`` / ``obs.format_summary`` (flat per-phase
  table), ``obs.bench_dump`` (counters + span roll-ups as one JSON-safe
  dict); ``obs.snapshot`` / ``obs.merge_snapshot`` fold another process's
  spans and counters into this one.
"""
from __future__ import annotations

import os
from typing import Optional

from . import export as _export
from . import registry
from .registry import (Counter, Gauge, counter, counters,  # noqa: F401
                       gauge, gauges)
from .tracer import NULL_SPAN, Span, Tracer, _NullSpan  # noqa: F401

__all__ = ["Counter", "Gauge", "Span", "Tracer", "bench_dump",
           "cache_stats", "chrome_trace", "counter", "counters", "disable",
           "enable", "enabled", "event", "format_summary", "gauge", "gauges",
           "merge_snapshot", "registry", "reset", "snapshot", "span",
           "summary", "tracer"]

# The installed tracer, or None.  ``span``/``event`` check this one global;
# when it is None they cost a single global load + return.
_TRACER: Optional[Tracer] = None


def enable() -> Tracer:
    """Install (or return the already-installed) recording tracer."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER


def disable() -> None:
    """Uninstall the tracer; recorded events are dropped."""
    global _TRACER
    _TRACER = None


def enabled() -> bool:
    """Is a tracer currently recording spans?"""
    return _TRACER is not None


def tracer() -> Optional[Tracer]:
    """The installed tracer, or None when tracing is disabled."""
    return _TRACER


def span(name: str, cat: str = "app", **attrs: object) -> "Span | _NullSpan":
    """Open a structured span (context manager); no-op when disabled."""
    if _TRACER is None:
        return NULL_SPAN
    return Span(_TRACER, name, cat, attrs)


def event(name: str, cat: str = "app", **attrs: object) -> None:
    """Record a zero-duration instant event; no-op when disabled."""
    if _TRACER is not None:
        _TRACER.instant(name, cat, attrs)


def reset(counters_too: bool = True) -> None:
    """Drop recorded spans (if tracing) and optionally zero the registry."""
    global _TRACER
    if _TRACER is not None:
        _TRACER = Tracer()
    if counters_too:
        registry.reset()


# ---------------------------------------------------------------------------
# cross-process plumbing (portfolio workers)
# ---------------------------------------------------------------------------

def snapshot() -> Optional[dict]:
    """Picklable dump of this process's tracer (None when disabled).

    Workers return this to the parent, which folds it into its own tracer
    via ``merge_snapshot`` — span ids are rebased and timestamps shifted
    onto the parent's time base, so one Chrome trace shows every process.
    """
    if _TRACER is None:
        return None
    return {"pid": _TRACER.pid, "wall0": _TRACER.wall0,
            "events": list(_TRACER.events),
            "counters": registry.counters(),
            "gauges": registry.gauges()}


def merge_snapshot(snap: Optional[dict], pid: Optional[int] = None) -> None:
    """Fold a worker ``snapshot()`` into the live tracer (+ its counters).

    ``pid`` assigns a stable caller-chosen process id to the merged spans
    (the portfolio numbers workers by submission order).  Worker counter
    values are *added* into this process's registry so fleet-wide cache
    hit rates survive the process boundary.
    """
    if snap is None:
        return
    if _TRACER is not None:
        _TRACER.merge(snap, pid=pid)
    for name, val in snap.get("counters", {}).items():
        if val:
            registry.counter(name).inc(val)
    for name, val in snap.get("gauges", {}).items():
        registry.gauge(name).set(val)


# ---------------------------------------------------------------------------
# views
# ---------------------------------------------------------------------------

def cache_stats() -> dict[str, dict]:
    """Hit/miss/rate per cache site, discovered from the counter registry.

    A *site* is any counter pair named ``<site>.cache_hit`` /
    ``<site>.cache_miss`` (``costdb``, ``paths``, ``window_memo``,
    ``candidates``).  ``scheduler.clear_caches()`` zeroes these alongside
    the caches themselves.
    """
    snap = registry.counters()
    sites: dict[str, dict] = {}
    for name, val in snap.items():
        for suffix, key in ((".cache_hit", "hits"), (".cache_miss",
                                                     "misses")):
            if name.endswith(suffix):
                site = sites.setdefault(name[: -len(suffix)],
                                        {"hits": 0, "misses": 0})
                site[key] = val
    for site in sites.values():
        total = site["hits"] + site["misses"]
        site["hit_rate"] = site["hits"] / total if total else 0.0
    return sites


def chrome_trace(path: Optional[str] = None) -> dict:
    """Export the live tracer as Chrome-trace JSON (see ``obs.export``)."""
    if _TRACER is None:
        raise RuntimeError("tracing is not enabled "
                           "(call repro_torch.obs.enable())")
    return _export.chrome_trace(_TRACER, path=path)


def summary() -> list[dict]:
    """Per-(cat, name) span aggregates of the live tracer."""
    if _TRACER is None:
        return []
    return _export.summary(_TRACER)


def format_summary(max_rows: int = 40) -> str:
    """The flat per-phase summary table as text."""
    if _TRACER is None:
        return "(tracing disabled)"
    return _export.format_summary(_TRACER, max_rows=max_rows)


def bench_dump() -> dict:
    """Telemetry blob for bench rows (counters + span roll-ups)."""
    return _export.bench_dump(_TRACER)


if os.environ.get("SCAR_TRACE", "").strip() not in ("", "0"):
    enable()
