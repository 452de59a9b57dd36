"""Structured-span tracer: nested wall/CPU-timed spans with attributes.

The gated half of the telemetry layer (``repro_torch.obs``): spans record only
while a tracer is installed (``repro_torch.obs.enable``).  The disabled path is a
module-level no-op — one global load, one cached-singleton return — so
instrumented hot paths pay effectively nothing when tracing is off, and
nothing the tracer records ever feeds back into scheduling decisions
(tracing is plan-invariant by construction).

A span is a context manager::

    with obs.span("window_combine", cat="scheduler", mesh="16x16", window=i):
        ...

``cat`` buckets spans by subsystem (scheduler / evaluator / device_search /
engine / refine / portfolio / online / bench — the taxonomy lives in
``docs/observability.md``); remaining keywords become free-form attributes
on the finished record.  Records carry monotonic wall time
(``time.perf_counter``), per-thread CPU time (``time.thread_time``), the
recording process id and a dense per-process thread id, plus the id of the
enclosing span — everything the exporters need for Chrome-trace nesting and
per-phase attribution.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

__all__ = ["NULL_SPAN", "Span", "Tracer"]


class _NullSpan:
    """The shared disabled-path span: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def set(self, **attrs: object) -> "_NullSpan":
        """Ignore attributes (enabled spans record them)."""
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span; appends its finished record to the tracer on exit."""

    __slots__ = ("tracer", "name", "cat", "attrs", "sid", "parent",
                 "t0", "c0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: dict) -> None:
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, **attrs: object) -> "Span":
        """Attach/overwrite attributes while the span is open."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.sid = next(tr._ids)
        stack = tr._stack()
        self.parent = stack[-1] if stack else -1
        stack.append(self.sid)
        self.c0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        t1 = time.perf_counter()
        c1 = time.thread_time()
        tr = self.tracer
        stack = tr._stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        tr.events.append({
            "sid": self.sid, "parent": self.parent,
            "name": self.name, "cat": self.cat,
            "ts": self.t0 - tr.t0, "dur": t1 - self.t0,
            "cpu": c1 - self.c0,
            "pid": tr.pid, "tid": tr._tid(),
            "args": self.attrs,
        })
        return False


class Tracer:
    """Recording tracer: an append-only event list plus id bookkeeping.

    ``events`` holds finished span records (dicts, see ``Span.__exit__``)
    and zero-duration instant records (``dur`` absent).  Times are relative
    to ``t0`` (``perf_counter`` at construction); ``wall0`` (``time.time``
    at construction) lets snapshots from other processes be shifted onto
    this tracer's time base when merged.
    """

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        self.pid = os.getpid()
        self.events: list[dict] = []
        self._ids = itertools.count()
        self._tls = threading.local()
        self._tids: dict[int, int] = {}
        self._tid_lock = threading.Lock()

    # -- per-thread state ---------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _tid(self) -> int:
        """Dense, first-appearance-ordered id of the calling thread."""
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._tid_lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str, attrs: dict) -> Span:
        """Open a span (used via ``repro_torch.obs.span``)."""
        return Span(self, name, cat, attrs)

    def instant(self, name: str, cat: str, attrs: dict) -> None:
        """Record a zero-duration point event (e.g. a jit compile)."""
        stack = self._stack()
        self.events.append({
            "sid": next(self._ids),
            "parent": stack[-1] if stack else -1,
            "name": name, "cat": cat,
            "ts": time.perf_counter() - self.t0,
            "pid": self.pid, "tid": self._tid(),
            "args": attrs,
        })

    # -- cross-process merge ------------------------------------------------
    def merge(self, snapshot: dict, pid: int | None = None) -> None:
        """Fold a worker ``repro_torch.obs.snapshot()`` into this tracer.

        Worker timestamps are shifted onto this tracer's time base via the
        wall-clock offset between the two tracers' births.  ``pid``
        overrides the recorded process id with a caller-chosen stable id
        (the portfolio numbers workers by submission order so merged traces
        are deterministic across runs).
        """
        shift = snapshot["wall0"] - self.wall0
        base = next(self._ids)
        use_pid = snapshot["pid"] if pid is None else pid
        max_sid = base - 1
        for ev in snapshot["events"]:
            ev = dict(ev)
            ev["ts"] += shift
            ev["pid"] = use_pid
            ev["sid"] += base
            if ev["parent"] >= 0:
                ev["parent"] += base
            self.events.append(ev)
            max_sid = max(max_sid, ev["sid"])
        # keep ids unique if more spans open after the merge (worker sids
        # may be sparse: unclosed spans consume ids without emitting events)
        self._ids = itertools.count(max_sid + 1)
