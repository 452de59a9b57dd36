"""Finding record + fingerprinting shared by the runner, baseline and CLI.

A ``Finding`` is one rule violation at one source location.  Its
*fingerprint* — ``(rule, path, snippet)`` where ``snippet`` is the
whitespace-normalised source line — is the identity the baseline mechanism
matches on: line numbers drift when unrelated code moves, but a
grandfathered violation keeps its rule, file and source text, so baselines
survive routine edits without manual renumbering.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

__all__ = ["Finding", "fingerprint_snippet"]


def fingerprint_snippet(line_text: str) -> str:
    """Whitespace-normalised source line used as the baseline fingerprint."""
    return " ".join(line_text.split())


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str           # e.g. "SL001"
    path: str           # posix path, relative to the lint root when possible
    line: int           # 1-based
    col: int            # 0-based (ast convention)
    message: str
    snippet: str = ""   # normalised source line (baseline fingerprint part)
    suppressed: bool = False   # matched an inline ``# scarlint: ignore[...]``
    baselined: bool = False    # matched a committed baseline entry

    @property
    def fingerprint(self) -> tuple[str, str, str]:
        """Baseline identity: stable across pure line-number drift."""
        return (self.rule, self.path, self.snippet)

    @property
    def active(self) -> bool:
        """Counts toward a non-zero exit (neither suppressed nor baselined)."""
        return not (self.suppressed or self.baselined)

    def as_dict(self) -> dict[str, Any]:
        """JSON-ready representation (CLI ``--format json`` / report files)."""
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
            "suppressed": self.suppressed,
            "baselined": self.baselined,
        }

    def with_flags(self, *, suppressed: bool | None = None,
                   baselined: bool | None = None) -> "Finding":
        """Copy with updated suppression/baseline flags (frozen dataclass)."""
        return replace(
            self,
            suppressed=self.suppressed if suppressed is None else suppressed,
            baselined=self.baselined if baselined is None else baselined,
        )

    def format_text(self) -> str:
        """One-line human-readable form (``path:line:col: RULE message``)."""
        flag = ""
        if self.suppressed:
            flag = " [suppressed]"
        elif self.baselined:
            flag = " [baselined]"
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.message}{flag}")
