"""Per-module analysis context: AST, import aliases, inline suppressions.

The counterpart of ``repro.analysis.lint.context``.  ``ModuleContext`` is
what every rule sees for a file.  It owns

* the parsed ``ast`` tree and raw source lines,
* an **import-alias map** resolving local names to canonical dotted paths
  (``np`` -> ``numpy``, ``F`` -> ``torch.nn.functional`` after ``import
  torch.nn.functional as F``, ``from torch import sort`` ->
  ``torch.sort``, relative ``from .ops import masked_topk`` ->
  ``repro_torch.kernels.scar_search.ops.masked_topk``), and
* the **suppression map** parsed from ``# scarlint: ignore[SL001,...]``
  comments — a suppression on a finding's line, or on the line immediately
  above it, silences that finding (``ignore`` with no bracket silences all
  rules on the line; everything after ``--`` is a free-form reason).

``resolve(node)`` is the workhorse rules build on: it unwinds an attribute
chain (``torch.cuda.synchronize``) to its base name, expands the base
through the alias map and returns the canonical dotted name, or ``None``
when the base is a local object the linter cannot see through.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path, PurePosixPath

__all__ = ["PACKAGE", "ModuleContext", "infer_module_name"]

# the package relative imports and project-index names are anchored at
PACKAGE = "repro_torch"

_SUPPRESS_RE = re.compile(
    r"#\s*scarlint:\s*ignore(?:\[([A-Za-z0-9_,\s-]*)\])?")


def infer_module_name(path: str) -> str:
    """Dotted module name for ``path``, anchored at package ``repro_torch``.

    ``.../src/repro_torch/core/cost.py`` -> ``repro_torch.core.cost``;
    ``__init__.py`` maps to its package.  The anchor is a whole path part,
    so a ``repro`` directory (the reference package) is not one.  Files
    outside a ``repro_torch`` tree (test fixtures, temp dirs) fall back to
    their stem — alias resolution still works, only relative-import
    expansion loses precision.
    """
    parts = list(PurePosixPath(Path(path).as_posix()).parts)
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][: -len(".py")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if PACKAGE in parts:
        parts = parts[parts.index(PACKAGE):]
        return ".".join(parts)
    return parts[-1] if parts else "<module>"


class ModuleContext:
    """Everything a rule needs to analyse one Python module."""

    def __init__(self, path: str, source: str,
                 rel_path: str | None = None,
                 module_name: str | None = None) -> None:
        self.path = path
        self.rel_path = rel_path if rel_path is not None else path
        self.source = source
        self.lines: list[str] = source.splitlines()
        self.tree: ast.Module = ast.parse(source, filename=path)
        self.module_name = (module_name if module_name is not None
                            else infer_module_name(path))
        self.is_package_init = Path(path).name == "__init__.py"
        # local name -> canonical dotted path
        self.aliases: dict[str, str] = {}
        self._collect_aliases()
        # line -> suppressed rule ids; empty set == all rules
        self.suppressions: dict[int, frozenset[str]] = (
            self._collect_suppressions())

    # ------------------------------------------------------------------
    # aliases
    # ------------------------------------------------------------------

    def _package_parts(self) -> list[str]:
        parts = self.module_name.split(".")
        return parts if self.is_package_init else parts[:-1]

    def _collect_aliases(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.aliases[alias.asname] = alias.name
                    else:
                        # ``import torch.nn.functional`` binds ``torch``
                        top = alias.name.split(".", 1)[0]
                        self.aliases.setdefault(top, top)
            elif isinstance(node, ast.ImportFrom):
                base = self._import_from_base(node)
                if base is None:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.aliases[local] = (f"{base}.{alias.name}"
                                           if base else alias.name)

    def _import_from_base(self, node: ast.ImportFrom) -> str | None:
        if node.level == 0:
            return node.module or ""
        pkg = self._package_parts()
        drop = node.level - 1
        if drop > len(pkg):
            return None                        # beyond what we can see
        base_parts = pkg[: len(pkg) - drop] if drop else pkg
        if node.module:
            base_parts = base_parts + node.module.split(".")
        return ".".join(base_parts)

    # ------------------------------------------------------------------
    # name resolution
    # ------------------------------------------------------------------

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted name of a Name/Attribute chain, or None.

        ``torch.cuda.synchronize`` (with ``import torch``) resolves to
        itself, ``F.softmax`` (with ``import torch.nn.functional as F``)
        to ``torch.nn.functional.softmax``; a chain rooted at a local
        object (``out.item``) resolves to ``None`` — rules that care about
        bare method calls match on the attribute name instead.
        """
        parts: list[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        base = self.aliases.get(cur.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))

    def call_name(self, call: ast.Call) -> str | None:
        """``resolve`` applied to a call's function expression."""
        return self.resolve(call.func)

    def line_text(self, lineno: int) -> str:
        """Raw source text of 1-based line ``lineno`` ('' out of range)."""
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    # ------------------------------------------------------------------
    # suppressions
    # ------------------------------------------------------------------

    def _collect_suppressions(self) -> dict[int, frozenset[str]]:
        out: dict[int, frozenset[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m is None:
                continue
            ids = m.group(1)
            if ids is None:
                out[i] = frozenset()            # bare ignore: all rules
            else:
                out[i] = frozenset(
                    s.strip() for s in ids.split(",") if s.strip())
        return out

    def is_suppressed(self, rule_id: str, lineno: int) -> bool:
        """Does an inline ignore cover ``rule_id`` at ``lineno``?

        A suppression comment applies to its own line, and a suppression
        inside a contiguous block of pure comment lines applies to the
        first code line below the block — so a multi-line reason written
        as a comment block above a long expression covers it.
        """
        ids = self.suppressions.get(lineno)
        if ids is not None and (not ids or rule_id in ids):
            return True
        line = lineno - 1
        while line >= 1 and self.line_text(line).lstrip().startswith("#"):
            ids = self.suppressions.get(line)
            if ids is not None and (not ids or rule_id in ids):
                return True
            line -= 1
        return False
