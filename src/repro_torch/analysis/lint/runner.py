"""scarlint runner: file discovery, two-pass rule execution, reporting.

The counterpart of ``repro.analysis.lint.runner``.  ``lint_paths`` walks
the given files/directories, parses every ``*.py`` into a
``ModuleContext``, runs each rule's ``collect`` pass over all modules
(filling the cross-module ``ProjectIndex``; a path-scoped rule collects
from every module too, since a tensor-returning function defined outside
its scope is called inside it), then the ``check`` pass, and
post-processes findings through inline suppressions and the grandfathered
baseline.  ``lint_source`` is the single-snippet form used by tests.

Run statistics flow through the port's telemetry registry
(``repro_torch.obs``): ``scarlint.files_scanned`` and per-rule
``scarlint.findings.<rule>`` counters, ``scarlint.suppressed`` /
``scarlint.baselined``, a ``scarlint.runtime_ms`` gauge, and — when
tracing is enabled — a ``scarlint_run`` span plus a ``scarlint_report``
instant in the ``scarlint`` category, so a Chrome trace of a run
(``--trace-out``) shows the linter like any other subsystem.
"""
from __future__ import annotations

import ast
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

from repro_torch import obs

from .baseline import TOOL, Baseline
from .context import ModuleContext
from .findings import Finding, fingerprint_snippet
from .rules import ProjectIndex, Rule, default_rules

__all__ = ["LintReport", "lint_paths", "lint_source"]

PARSE_ERROR_RULE = "SL000"


@dataclass
class LintReport:
    """Outcome of one lint run."""

    findings: list[Finding] = field(default_factory=list)
    stale_baseline: list[dict[str, object]] = field(default_factory=list)
    files_scanned: int = 0
    runtime_ms: float = 0.0

    @property
    def active(self) -> list[Finding]:
        """Findings that fail the run (not suppressed, not baselined)."""
        return [f for f in self.findings if f.active]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def baselined(self) -> list[Finding]:
        return [f for f in self.findings if f.baselined]

    def per_rule(self) -> dict[str, int]:
        """All findings (any state) counted per rule id."""
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def ok(self, strict_baseline: bool = False) -> bool:
        """Clean run?  ``strict_baseline`` also fails on stale entries."""
        if self.active:
            return False
        return not (strict_baseline and self.stale_baseline)

    def as_dict(self) -> dict[str, object]:
        """JSON-ready report (CI artifact schema)."""
        return {
            "tool": TOOL,
            "files_scanned": self.files_scanned,
            "runtime_ms": round(self.runtime_ms, 3),
            "counts": {
                "active": len(self.active),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
                "per_rule": self.per_rule(),
            },
            "findings": [f.as_dict() for f in self.findings],
            "stale_baseline": self.stale_baseline,
        }


def discover_files(paths: Sequence[str | Path]) -> list[Path]:
    """Every ``*.py`` under ``paths`` (files kept as-is), sorted, deduped."""
    out: list[Path] = []
    seen: set[Path] = set()
    for p in paths:
        path = Path(p)
        if path.is_dir():
            candidates: Iterable[Path] = sorted(path.rglob("*.py"))
        else:
            candidates = [path]
        for c in candidates:
            if "__pycache__" in c.parts:
                continue
            r = c.resolve()
            if r not in seen:
                seen.add(r)
                out.append(c)
    return out


def _rel_path(path: Path, root: Path | None) -> str:
    if root is not None:
        try:
            return path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            pass
    return path.as_posix()


def _parse_error_finding(rel: str, err: SyntaxError) -> Finding:
    return Finding(
        rule=PARSE_ERROR_RULE,
        path=rel,
        line=err.lineno or 1,
        col=(err.offset or 1) - 1,
        message=f"syntax error: {err.msg}",
        snippet=fingerprint_snippet(err.text or ""),
    )


def lint_paths(paths: Sequence[str | Path], *,
               rules: Sequence[Rule] | None = None,
               baseline: Baseline | None = None,
               root: str | Path | None = None) -> LintReport:
    """Lint files/dirs; returns the full report (see ``LintReport``).

    ``root`` anchors the relative paths findings (and therefore baseline
    fingerprints) are reported under — pass the directory the baseline
    file lives in so fingerprints are location-independent.
    """
    t0 = time.perf_counter()
    active_rules = list(rules) if rules is not None else default_rules()
    root_path = Path(root) if root is not None else None
    files = discover_files(paths)

    findings: list[Finding] = []
    contexts: list[ModuleContext] = []
    with obs.span("scarlint_run", cat="scarlint", files=len(files),
                  rules=len(active_rules)):
        for path in files:
            rel = _rel_path(path, root_path)
            try:
                source = path.read_text()
                contexts.append(ModuleContext(str(path), source,
                                              rel_path=rel))
            except SyntaxError as err:
                findings.append(_parse_error_finding(rel, err))
            except OSError as err:
                findings.append(Finding(
                    rule=PARSE_ERROR_RULE, path=rel, line=1, col=0,
                    message=f"cannot read file: {err}", snippet=""))

        project = ProjectIndex()
        for rule in active_rules:
            for ctx in contexts:
                rule.collect(ctx, project)
        for rule in active_rules:
            for ctx in contexts:
                if not rule.applies_to(ctx):
                    continue
                for f in rule.check(ctx, project):
                    if ctx.is_suppressed(f.rule, f.line):
                        f = f.with_flags(suppressed=True)
                    findings.append(f)

        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        stale: list[dict[str, object]] = []
        if baseline is not None:
            findings, stale = baseline.apply(findings)

        report = LintReport(
            findings=findings,
            stale_baseline=stale,
            files_scanned=len(files),
            runtime_ms=(time.perf_counter() - t0) * 1e3,
        )

        obs.counter("scarlint.files_scanned").inc(report.files_scanned)
        obs.counter("scarlint.suppressed").inc(len(report.suppressed))
        obs.counter("scarlint.baselined").inc(len(report.baselined))
        for rule_id, n in report.per_rule().items():
            obs.counter(f"scarlint.findings.{rule_id}").inc(n)
        obs.gauge("scarlint.runtime_ms").set(report.runtime_ms)
        obs.event("scarlint_report", cat="scarlint",
                  files=report.files_scanned, active=len(report.active),
                  suppressed=len(report.suppressed),
                  baselined=len(report.baselined))
    return report


def lint_source(source: str, path: str = "snippet.py", *,
                rules: Sequence[Rule] | None = None) -> list[Finding]:
    """Lint one source string (tests / docs examples).

    ``path`` participates in path-scoped rules — name it e.g.
    ``core/foo.py`` to put the snippet in SL002's scope.  Raises
    ``SyntaxError`` on unparsable input.
    """
    ast.parse(source)                       # surface syntax errors directly
    active_rules = list(rules) if rules is not None else default_rules()
    ctx = ModuleContext(path, source, rel_path=path)
    project = ProjectIndex()
    out: list[Finding] = []
    for rule in active_rules:
        rule.collect(ctx, project)
    for rule in active_rules:
        if not rule.applies_to(ctx):
            continue
        for f in rule.check(ctx, project):
            if ctx.is_suppressed(f.rule, f.line):
                f = f.with_flags(suppressed=True)
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out
