"""Rule plugin API: base class, registry, cross-module project index.

The counterpart of ``repro.analysis.lint.rules.base``.  A rule subclasses
``Rule``, sets ``rule_id``/``title`` and implements ``check(ctx,
project)``.  The runner drives two passes over every module:

1. ``collect(ctx, project)`` — optional; record cross-module facts into
   the shared ``ProjectIndex`` (which callables are memoised, so call
   sites in *other* files can be checked; which functions return
   tensors, so a fetch of their result is seen in the caller);
2. ``check(ctx, project)`` — yield ``Finding`` records.

Registration is declarative: decorate the class with ``@register`` and it
participates in every default run; ``default_rules()`` instantiates the
registry sorted by rule id so output ordering is stable.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import ClassVar, Iterator, Type, TypeVar

from ..context import PACKAGE, ModuleContext
from ..findings import Finding, fingerprint_snippet

__all__ = ["MemoSig", "ProjectIndex", "Rule", "register", "default_rules",
           "rule_catalog"]


@dataclass(frozen=True)
class MemoSig:
    """One memoised callable (``functools.lru_cache`` / ``cache``)."""

    qualname: str                       # module.name it is defined under
    params: tuple[str, ...] | None      # positional params when resolvable


@dataclass
class ProjectIndex:
    """Facts shared across modules between the collect and check passes."""

    # canonical qualname -> memoised signature (SL005's collect pass)
    memoised: dict[str, MemoSig] = field(default_factory=dict)
    # canonical qualnames of functions annotated ``-> torch.Tensor`` or a
    # tuple of tensors (SL002's collect pass; SL002 and SL004 read it)
    tensor_fns: set[str] = field(default_factory=set)

    def find_memoised(self, canonical: str) -> MemoSig | None:
        """The memoised callable ``canonical`` names, re-exports included."""
        sig = self.memoised.get(canonical)
        if sig is None:
            hit = _reexported(canonical, self.memoised)
            sig = self.memoised[hit] if hit is not None else None
        return sig

    def returns_tensor(self, canonical: str) -> bool:
        """Does ``canonical`` name a project function returning tensors?"""
        return (canonical in self.tensor_fns
                or _reexported(canonical, self.tensor_fns) is not None)


def _reexported(canonical: str, names) -> str | None:
    """Re-export tolerance: ``repro_torch.kernels.scar_search.masked_topk``
    matches the definition ``...scar_search.ops.masked_topk`` (same leaf,
    defined under the importing package)."""
    if not canonical.startswith(PACKAGE + "."):
        return None
    pkg, _, leaf = canonical.rpartition(".")
    for q in names:
        if q.rsplit(".", 1)[-1] == leaf and q.startswith(pkg + "."):
            return q
    return None


class Rule:
    """Base class for scarlint rules."""

    rule_id: ClassVar[str] = "SL000"
    title: ClassVar[str] = "abstract rule"

    def applies_to(self, ctx: ModuleContext) -> bool:
        """Whether this rule scans ``ctx`` at all (path-scoped rules)."""
        return True

    def collect(self, ctx: ModuleContext, project: ProjectIndex) -> None:
        """First pass: record cross-module facts (default: nothing)."""

    def check(self, ctx: ModuleContext,
              project: ProjectIndex) -> Iterator[Finding]:
        """Second pass: yield findings for ``ctx``."""
        raise NotImplementedError
        yield  # pragma: no cover - makes this a generator for type-checkers

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        """Build a ``Finding`` anchored at ``node`` in ``ctx``."""
        lineno = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule=self.rule_id,
            path=ctx.rel_path,
            line=lineno,
            col=col,
            message=message,
            snippet=fingerprint_snippet(ctx.line_text(lineno)),
        )


_R = TypeVar("_R", bound=Type[Rule])
_REGISTRY: dict[str, Type[Rule]] = {}


def register(cls: _R) -> _R:
    """Class decorator adding a rule to the default registry."""
    if cls.rule_id in _REGISTRY:  # pragma: no cover - import-time guard
        raise ValueError(f"duplicate rule id {cls.rule_id}")
    _REGISTRY[cls.rule_id] = cls
    return cls


def default_rules() -> list[Rule]:
    """Fresh instances of every registered rule, sorted by rule id."""
    return [_REGISTRY[rid]() for rid in sorted(_REGISTRY)]


def rule_catalog() -> dict[str, str]:
    """``rule_id -> title`` for ``--list-rules`` and docs."""
    return {rid: cls.title for rid, cls in sorted(_REGISTRY.items())}
