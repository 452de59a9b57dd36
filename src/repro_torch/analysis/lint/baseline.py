"""Grandfathered-violation baseline: load, match, write, drift detection.

The counterpart of ``repro.analysis.lint.baseline``.  The baseline is a
committed JSON file (``scarlint-torch-baseline.json`` at the repo root)
listing known violations the linter tolerates so a new rule can land
strict-by-default without blocking on a full cleanup.  Entries are
fingerprints — ``(rule, path, snippet)`` with a count — not line numbers,
so they survive unrelated edits that shift code around.

The port's file has a name of its own: ``find_baseline_file`` walks up
from the scanned path and would otherwise find the reference linter's
``scarlint-baseline.json`` at the same root.  That file is never read or
written here: ``load`` and ``save`` refuse its name, and ``load`` refuses
a file another tool wrote.

Matching is a multiset decrement: each finding consumes at most one
baseline slot.  Whatever remains afterwards is *stale* (debt that was paid
down or code that was deleted); ``--strict-baseline`` fails on drift in
either direction, so the committed file always mirrors reality.
"""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Iterable

from .findings import Finding

__all__ = ["Baseline", "BASELINE_FILENAME", "REFERENCE_BASELINE_FILENAME",
           "find_baseline_file"]

BASELINE_FILENAME = "scarlint-torch-baseline.json"
# the reference linter's file, beside this one at the repo root
REFERENCE_BASELINE_FILENAME = "scarlint-baseline.json"
TOOL = "scarlint-torch"

_Key = tuple[str, str, str]                    # (rule, path, snippet)


def _check_not_reference(path: Path) -> None:
    if Path(path).name == REFERENCE_BASELINE_FILENAME:
        raise ValueError(f"{path}: the reference linter's baseline; the "
                         f"port's is {BASELINE_FILENAME}")


def find_baseline_file(start: Path) -> Path | None:
    """Nearest ``scarlint-torch-baseline.json`` at or above ``start``."""
    cur = start if start.is_dir() else start.parent
    for candidate in [cur, *cur.parents]:
        p = candidate / BASELINE_FILENAME
        if p.is_file():
            return p
    return None


class Baseline:
    """Multiset of grandfathered finding fingerprints."""

    def __init__(self, entries: Counter[_Key] | None = None) -> None:
        self.entries: Counter[_Key] = Counter() if entries is None else entries

    # ------------------------------------------------------------------
    # construction / io
    # ------------------------------------------------------------------

    @classmethod
    def from_findings(cls, findings: Iterable[Finding]) -> "Baseline":
        """Baseline covering every non-suppressed finding given."""
        c: Counter[_Key] = Counter()
        for f in findings:
            if not f.suppressed:
                c[f.fingerprint] += 1
        return cls(c)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        """Parse a baseline file (raises ``ValueError`` on a bad schema,
        on the reference's file, or on a file another tool wrote)."""
        _check_not_reference(path)
        with open(path) as fh:
            data = json.load(fh)
        if not isinstance(data, dict) or "entries" not in data:
            raise ValueError(f"{path}: not a scarlint baseline "
                             "(missing 'entries')")
        if data.get("tool") != TOOL:
            raise ValueError(f"{path}: written by {data.get('tool')!r}, "
                             f"not {TOOL!r}")
        c: Counter[_Key] = Counter()
        for e in data["entries"]:
            key = (str(e["rule"]), str(e["path"]), str(e["snippet"]))
            c[key] += int(e.get("count", 1))
        return cls(c)

    def save(self, path: Path) -> None:
        """Write the baseline deterministically (sorted, one entry/key)."""
        _check_not_reference(path)
        entries = [
            {"rule": rule, "path": p, "snippet": snippet, "count": n}
            for (rule, p, snippet), n in sorted(self.entries.items())
        ]
        payload = {"version": 1, "tool": TOOL, "entries": entries}
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=False)
            fh.write("\n")

    # ------------------------------------------------------------------
    # matching
    # ------------------------------------------------------------------

    def apply(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[dict[str, object]]]:
        """Mark baseline-covered findings; report stale leftover entries.

        Returns ``(findings, stale)`` where ``findings`` has
        ``baselined=True`` on every matched record and ``stale`` lists the
        baseline entries (with remaining counts) no current finding
        consumed — baseline drift the strict mode turns into a failure.
        """
        remaining = Counter(self.entries)
        out: list[Finding] = []
        for f in findings:
            if not f.suppressed and remaining.get(f.fingerprint, 0) > 0:
                remaining[f.fingerprint] -= 1
                out.append(f.with_flags(baselined=True))
            else:
                out.append(f)
        stale = [
            {"rule": rule, "path": p, "snippet": snippet, "count": n}
            for (rule, p, snippet), n in sorted(remaining.items()) if n > 0
        ]
        return out, stale

    def __len__(self) -> int:
        return sum(self.entries.values())
