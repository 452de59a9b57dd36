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

The Chrome-trace exporter of the reference (``repro.obs.export``) is not
ported yet; ``Tracer.events`` holds the raw records.
"""
from __future__ import annotations

import os
from typing import Optional

from . import registry
from .registry import (Counter, Gauge, counter, counters,  # noqa: F401
                       gauge, gauges)
from .tracer import NULL_SPAN, Span, Tracer, _NullSpan  # noqa: F401

__all__ = ["Counter", "Gauge", "Span", "Tracer", "cache_stats", "counter",
           "counters", "disable", "enable", "enabled", "event", "gauge",
           "gauges", "registry", "reset", "span", "tracer"]

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


if os.environ.get("SCAR_TRACE", "").strip() not in ("", "0"):
    enable()
