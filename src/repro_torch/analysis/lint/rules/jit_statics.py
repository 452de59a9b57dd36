"""SL005 — cache-key hazards at visible call sites of memoised callables.

The reference's rule guards ``jax.jit`` static arguments: every distinct
static value compiles a new program.  The port has no ``jax.jit``; its
counterpart of a static argument is an argument of a memoised callable
(``functools.lru_cache`` / ``functools.cache``): every argument is part
of the cache key, so every *distinct* value is a new entry.  The port's
warm paths live on small keys (``core.modelzoo.get_model(name, batch)``,
which the online re-planner calls for every active tenant of every
epoch); passing an f-string (unbounded key cardinality: the bounded cache
then evicts what it should keep) or a dict/list/set (unhashable — a
``TypeError`` at call time) silently turns "build once per key" into
build-per-call, or into a crash on a path the tests may not reach.

The rule checks call sites it can *see*: calls to callables collected in
the project-wide pass (decorated defs, ``name = lru_cache(...)(inner)`` /
``name = cache(inner)`` assignments — including ones imported from other
scanned modules) where an argument receives an f-string, a dict/list/set
literal or comprehension, a generator, or a ``dict()``/``list()``/
``set()`` constructor call.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..context import ModuleContext
from ..findings import Finding
from .base import MemoSig, ProjectIndex, Rule, register
from ._collect import collect_memoised

_BAD_LITERALS: dict[type, str] = {
    ast.JoinedStr: "an f-string (unbounded cache-key cardinality)",
    ast.Dict: "a dict literal (unhashable)",
    ast.List: "a list literal (unhashable)",
    ast.Set: "a set literal (unhashable)",
    ast.DictComp: "a dict comprehension (unhashable)",
    ast.ListComp: "a list comprehension (unhashable)",
    ast.SetComp: "a set comprehension (unhashable)",
    ast.GeneratorExp: "a generator (unhashable)",
}
_BAD_CONSTRUCTORS = ("dict", "list", "set")


def _bad_value(node: ast.AST) -> str | None:
    for typ, why in _BAD_LITERALS.items():
        if isinstance(node, typ):
            return why
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in _BAD_CONSTRUCTORS):
        return f"a {node.func.id}() value (unhashable)"
    return None


@register
class JitStaticsRule(Rule):
    """Arguments of memoised callables must stay hashable, low-cardinality."""

    rule_id = "SL005"
    title = ("memoised (lru_cache/cache) call sites must not receive "
             "f-strings or unhashable containers (miss-per-call)")

    def collect(self, ctx: ModuleContext, project: ProjectIndex) -> None:
        for sig in collect_memoised(ctx).values():
            project.memoised[sig.qualname] = sig

    # ------------------------------------------------------------------

    def _resolve_sig(self, ctx: ModuleContext, call: ast.Call,
                     local: dict[str, MemoSig],
                     project: ProjectIndex) -> MemoSig | None:
        if isinstance(call.func, ast.Name) and call.func.id in local:
            return local[call.func.id]
        name = ctx.call_name(call)
        if name is None:
            return None
        return project.find_memoised(name)

    def _message(self, what: str, sig: MemoSig, why: str) -> str:
        return (f"cache-key argument '{what}' of memoised "
                f"'{sig.qualname}' receives {why} — every distinct value "
                "is a new cache entry; pass a hashable low-cardinality key "
                "(tuple/str/int) instead")

    def check(self, ctx: ModuleContext,
              project: ProjectIndex) -> Iterator[Finding]:
        local = collect_memoised(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            sig = self._resolve_sig(ctx, node, local, project)
            if sig is None:
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                why = _bad_value(kw.value)
                if why is not None:
                    yield self.finding(ctx, node,
                                       self._message(kw.arg, sig, why))
            for i, arg in enumerate(node.args):
                if isinstance(arg, ast.Starred):
                    break
                why = _bad_value(arg)
                if why is not None:
                    what = (sig.params[i] if sig.params
                            and i < len(sig.params) else f"#{i}")
                    yield self.finding(ctx, node,
                                       self._message(what, sig, why))
