"""Process-global counter / gauge registry.

The always-on half of the telemetry layer (``repro_torch.obs``): counters are
plain attribute increments on pre-fetched handles, cheap enough to live on
hot paths unconditionally — they replace the ad-hoc module globals that
used to track the CostDB memo, the frontier-path LRU and the
``launch.platform`` sync count, so production accounting and telemetry can
never disagree.

Naming convention (see ``docs/observability.md``):

* ``<subsystem>.<what>`` — dot-separated, lower_snake segments, e.g.
  ``evaluator.jit_recompiles``, ``launch.platform.sync_count``.
* cache sites use the ``<site>.cache_hit`` / ``<site>.cache_miss`` pair so
  ``repro_torch.obs.cache_stats()`` can discover them by suffix, e.g.
  ``costdb.cache_hit``, ``paths.cache_miss``, ``window_memo.cache_hit``.

Handles are identity-stable: ``counter(name)`` always returns the same
object for a name, so modules fetch their handle once at import time and
``reset()`` zeroes values without invalidating anything.
"""
from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "counter", "gauge", "counters", "gauges",
           "reset", "value"]


class Counter:
    """Monotonic counter handle; ``inc`` is the hot-path operation."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        """Add ``n`` (default 1)."""
        self.value += n

    def reset(self) -> None:
        """Zero the value; the handle (and its identity) survives."""
        self.value = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Last-value-wins gauge handle (live level, not a rate)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        """Record the current level."""
        self.value = v

    def add(self, dv: float) -> None:
        """Adjust the current level by ``dv``."""
        self.value += dv

    def reset(self) -> None:
        """Zero the value; the handle (and its identity) survives."""
        self.value = 0.0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Gauge({self.name}={self.value})"


# Registration is rare (once per name per process) and guarded; increments
# on the returned handles are deliberately lock-free (CPython attribute
# arithmetic under the GIL — the exactness-sensitive counters, e.g. the
# sync count, are single-threaded by construction).
_LOCK = threading.Lock()
_COUNTERS: dict[str, Counter] = {}
_GAUGES: dict[str, Gauge] = {}


def counter(name: str) -> Counter:
    """Get-or-create the counter handle for ``name``."""
    c = _COUNTERS.get(name)
    if c is None:
        with _LOCK:
            c = _COUNTERS.setdefault(name, Counter(name))
    return c


def gauge(name: str) -> Gauge:
    """Get-or-create the gauge handle for ``name``."""
    g = _GAUGES.get(name)
    if g is None:
        with _LOCK:
            g = _GAUGES.setdefault(name, Gauge(name))
    return g


def counters(prefix: str = "") -> dict[str, int]:
    """Snapshot of every counter value, optionally filtered by prefix."""
    with _LOCK:
        return {n: c.value for n, c in sorted(_COUNTERS.items())
                if n.startswith(prefix)}


def gauges(prefix: str = "") -> dict[str, float]:
    """Snapshot of every gauge value, optionally filtered by prefix."""
    with _LOCK:
        return {n: g.value for n, g in sorted(_GAUGES.items())
                if n.startswith(prefix)}


def reset(prefix: str = "") -> None:
    """Zero every counter and gauge whose name starts with ``prefix``.

    Handles stay registered and identity-stable — modules holding one keep
    incrementing the same object after a reset.
    """
    with _LOCK:
        for n, c in _COUNTERS.items():
            if n.startswith(prefix):
                c.reset()
        for n, g in _GAUGES.items():
            if n.startswith(prefix):
                g.reset()


def value(name: str) -> int:
    """Current value of counter ``name`` (0 if never registered)."""
    c = _COUNTERS.get(name)
    return 0 if c is None else c.value
