"""scarlint CLI of the port: ``python -m repro_torch.analysis.lint [paths]``.

The counterpart of ``repro.analysis.lint.cli``, with every flag of it.

Exit codes: 0 clean (every finding suppressed or baselined, and — under
``--strict-baseline`` — no stale baseline entries), 1 findings/drift,
2 usage errors.

The default baseline is the nearest ``scarlint-torch-baseline.json`` at or
above the first scanned path (i.e. the committed repo-root baseline when
run as ``python -m repro_torch.analysis.lint src/repro_torch``);
``--no-baseline`` ignores it (the debt-count mode), ``--write-baseline``
regenerates it from the current findings.  The reference linter's
``scarlint-baseline.json`` is refused as ``--baseline`` (exit 2), so this
CLI can neither read nor overwrite it.  ``--format json`` / ``--out`` emit
the machine report; ``--trace-out`` enables telemetry for the run and
writes a Chrome trace with the ``scarlint`` category.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Sequence

from .baseline import (BASELINE_FILENAME, REFERENCE_BASELINE_FILENAME,
                       Baseline, find_baseline_file)
from .runner import LintReport, lint_paths
from .rules import Rule, default_rules, rule_catalog

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="scarlint",
        description="AST-based invariant linter for the SCAR PyTorch port "
                    "(xp-genericity, counted syncs, seeded RNG, quantised "
                    "stable tie-breaks, memoised-call hygiene).")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="stdout format")
    ap.add_argument("--out", metavar="FILE",
                    help="also write the JSON report to FILE")
    ap.add_argument("--baseline", metavar="FILE",
                    help=f"baseline file (default: nearest "
                         f"{BASELINE_FILENAME} above the first path)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline (show grandfathered debt)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the baseline from current findings and exit")
    ap.add_argument("--strict-baseline", action="store_true",
                    help="fail when baseline entries are stale (drift check)")
    ap.add_argument("--rules", metavar="IDS",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("--trace-out", metavar="FILE",
                    help="enable telemetry and write a Chrome trace to FILE")
    return ap


def _select_rules(spec: str | None) -> list[Rule]:
    rules = default_rules()
    if spec is None:
        return rules
    wanted = {s.strip().upper() for s in spec.split(",") if s.strip()}
    known = {r.rule_id for r in rules}
    unknown = wanted - known
    if unknown:
        raise SystemExit(
            f"scarlint: unknown rule id(s) {sorted(unknown)}; "
            f"have {sorted(known)}")
    return [r for r in rules if r.rule_id in wanted]


def _resolve_baseline(args: argparse.Namespace,
                      first_path: Path) -> tuple[Baseline | None, Path | None]:
    if args.no_baseline:
        return None, None
    if args.baseline:
        p = Path(args.baseline)
        if p.name == REFERENCE_BASELINE_FILENAME:
            raise ValueError(f"{p}: the reference linter's baseline; the "
                             f"port's is {BASELINE_FILENAME}")
        if p.is_file():
            return Baseline.load(p), p
        return None, p                       # --write-baseline target
    found = find_baseline_file(first_path.resolve())
    if found is not None:
        return Baseline.load(found), found
    return None, None


def _print_text(report: LintReport, baseline_path: Path | None,
                strict: bool) -> None:
    for f in report.findings:
        print(f.format_text())
    for entry in report.stale_baseline:
        sev = "ERROR" if strict else "note"
        print(f"{sev}: stale baseline entry "
              f"{entry['rule']} {entry['path']}: {entry['snippet']!r} "
              f"(x{entry['count']}) — regenerate with --write-baseline")
    per_rule = ", ".join(f"{r}={n}" for r, n in report.per_rule().items())
    print(f"scarlint: {report.files_scanned} files, "
          f"{len(report.active)} active / {len(report.suppressed)} "
          f"suppressed / {len(report.baselined)} baselined finding(s)"
          f"{' [' + per_rule + ']' if per_rule else ''} "
          f"in {report.runtime_ms:.0f} ms"
          + (f" (baseline: {baseline_path})" if baseline_path else ""))


def main(argv: Sequence[str] | None = None) -> int:
    """Run the CLI; returns the process exit code."""
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for rid, title in rule_catalog().items():
            print(f"{rid}  {title}")
        return 0
    try:
        rules = _select_rules(args.rules)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2

    paths = [Path(p) for p in args.paths]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"scarlint: no such path(s): "
              f"{', '.join(map(str, missing))}", file=sys.stderr)
        return 2

    if args.trace_out:
        from repro_torch import obs
        obs.enable()

    try:
        baseline, baseline_path = _resolve_baseline(args, paths[0])
    except ValueError as e:
        print(f"scarlint: {e}", file=sys.stderr)
        return 2
    root = baseline_path.parent if baseline_path is not None else Path.cwd()

    if args.write_baseline:
        report = lint_paths(paths, rules=rules, baseline=None, root=root)
        target = baseline_path or Path(BASELINE_FILENAME)
        Baseline.from_findings(report.findings).save(target)
        n = sum(1 for f in report.findings if not f.suppressed)
        print(f"scarlint: wrote {n} baseline entr"
              f"{'y' if n == 1 else 'ies'} to {target}")
        return 0

    report = lint_paths(paths, rules=rules, baseline=baseline, root=root)

    if args.format == "json":
        print(json.dumps(report.as_dict(), indent=2))
    else:
        _print_text(report, baseline_path, args.strict_baseline)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report.as_dict(), fh, indent=2)
            fh.write("\n")
    if args.trace_out:
        from repro_torch import obs
        obs.chrome_trace(args.trace_out)

    return 0 if report.ok(strict_baseline=args.strict_baseline) else 1
