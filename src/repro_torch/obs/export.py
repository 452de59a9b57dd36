"""Exporters: Chrome-trace JSON, flat per-phase summary, bench JSON dump.

Three views over one ``Tracer`` event list + the counter registry:

* ``chrome_trace`` — the Trace Event Format consumed by ``chrome://tracing``
  and https://ui.perfetto.dev: one ``"X"`` (complete) event per span, one
  ``"i"`` (instant) event per point record, ``"M"`` metadata naming
  processes/threads, and a trailing ``"C"`` counter event carrying the
  registry snapshot.  Timestamps are microseconds relative to the tracer's
  birth, so nesting falls out of the containment the tracer guarantees.
* ``summary`` / ``format_summary`` — per-(cat, name) aggregation: call
  count, total/mean wall, total CPU, share of traced wall time.  The
  "where did the 200 ms go" table.
* ``bench_dump`` — a compact JSON-safe dict ({counters, spans}) the bench
  harness embeds into ``BENCH_*.json``-style bench rows.
"""
from __future__ import annotations

import json
from typing import Optional

from . import registry
from .tracer import Tracer

__all__ = ["chrome_trace", "summary", "format_summary", "bench_dump"]


def _json_safe(v: object) -> object:
    """Coerce an attribute value to something JSON-serializable."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def chrome_trace(tracer: Tracer, path: Optional[str] = None) -> dict:
    """Trace-event JSON for ``tracer``; written to ``path`` when given.

    Returns the trace dict either way (``{"traceEvents": [...], ...}``).
    """
    events: list[dict] = []
    pids = sorted({ev["pid"] for ev in tracer.events}) or [tracer.pid]
    for pid in pids:
        label = "main" if pid == tracer.pid else f"worker-{pid}"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"sort_index": pids.index(pid)}})
    last_ts = 0.0
    for ev in sorted(tracer.events, key=lambda e: e["ts"]):
        args = {k: _json_safe(v) for k, v in ev["args"].items()}
        rec = {"name": ev["name"], "cat": ev["cat"], "pid": ev["pid"],
               "tid": ev["tid"], "ts": ev["ts"] * 1e6, "args": args}
        if "dur" in ev:
            rec["ph"] = "X"
            rec["dur"] = ev["dur"] * 1e6
            rec["args"]["cpu_ms"] = round(ev["cpu"] * 1e3, 6)
            last_ts = max(last_ts, (ev["ts"] + ev["dur"]) * 1e6)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
            last_ts = max(last_ts, ev["ts"] * 1e6)
        events.append(rec)
    for name, val in registry.counters().items():
        events.append({"name": name, "ph": "C", "pid": tracer.pid, "tid": 0,
                       "ts": last_ts, "args": {"value": val}})
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": {"counters": registry.counters(),
                           "gauges": registry.gauges()}}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(trace, fh)
            fh.write("\n")
    return trace


def summary(tracer: Tracer) -> list[dict]:
    """Per-(cat, name) span aggregates, sorted by total wall descending.

    Rows: ``{cat, name, count, total_s, mean_s, cpu_s, share}`` where
    ``share`` is the row's fraction of total *top-level* traced wall time
    (spans with no parent), so nested phases can individually exceed no
    one but sum past 1.0 across nesting levels.
    """
    agg: dict[tuple[str, str], dict] = {}
    root_wall = 0.0
    for ev in tracer.events:
        if "dur" not in ev:
            continue
        if ev["parent"] < 0:
            root_wall += ev["dur"]
        row = agg.setdefault((ev["cat"], ev["name"]),
                             {"cat": ev["cat"], "name": ev["name"],
                              "count": 0, "total_s": 0.0, "cpu_s": 0.0})
        row["count"] += 1
        row["total_s"] += ev["dur"]
        row["cpu_s"] += ev["cpu"]
    rows = sorted(agg.values(), key=lambda r: -r["total_s"])
    for row in rows:
        row["mean_s"] = row["total_s"] / row["count"]
        row["share"] = row["total_s"] / root_wall if root_wall > 0 else 0.0
    return rows


def format_summary(tracer: Tracer, max_rows: int = 40) -> str:
    """The ``summary`` rows as an aligned text table."""
    rows = summary(tracer)[:max_rows]
    if not rows:
        return "(no spans recorded)"
    head = (f"{'cat':<14} {'span':<28} {'count':>7} {'total_ms':>10} "
            f"{'mean_ms':>9} {'cpu_ms':>10} {'share':>6}")
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{r['cat']:<14} {r['name']:<28} {r['count']:>7d} "
            f"{r['total_s'] * 1e3:>10.2f} {r['mean_s'] * 1e3:>9.3f} "
            f"{r['cpu_s'] * 1e3:>10.2f} {r['share']:>6.1%}")
    return "\n".join(lines)


def bench_dump(tracer: Optional[Tracer]) -> dict:
    """Compact JSON-safe telemetry blob for ``BENCH_*.json``-style bench rows.

    Always carries the counter/gauge snapshot; adds per-span aggregates
    when a tracer is recording.
    """
    out: dict = {"counters": registry.counters(),
                 "gauges": registry.gauges()}
    if tracer is not None:
        out["spans"] = {f"{r['cat']}.{r['name']}":
                        {"count": r["count"],
                         "total_s": round(r["total_s"], 6),
                         "cpu_s": round(r["cpu_s"], 6)}
                        for r in summary(tracer)}
    return out
