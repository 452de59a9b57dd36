"""SL001 — xp-genericity of backend-shared functions.

The counterpart of the reference's rule, which keeps the comm model one
function for every backend: ``cost.comm_from_parts`` /
``congestion_correction`` / ``route_wait_tables`` take an ``xp``
namespace parameter there and do every array operation through it, so a
bare ``np.``/``jnp.`` call inside one silently pins one backend's
arithmetic.

The port has no ``xp`` parameter today.  Each xp-generic function of the
reference became a numpy form and a torch form: ``cost.comm_from_parts``
and ``congestion_correction`` are torch functions that give the float64
oracle terms and the float32 kernel terms by their inputs' dtype, and
``route_wait_tables`` takes a tensor or a numpy array and computes the
numpy form through the torch one.  The rule stays so that an ``xp``
function added to the port keeps the contract.

The rule: inside any function with an ``xp`` parameter (including nested
closures), calls resolving into ``numpy.*`` or ``torch.*`` are violations
unless the called name is a dtype/introspection constructor
(``float32``, ``dtype``, ``finfo``, ...).  Anything intentionally exempt
carries ``# scarlint: ignore[SL001]`` with a reason.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..context import ModuleContext
from ..findings import Finding
from .base import ProjectIndex, Rule, register

XP_PARAM = "xp"

# dtype / dtype-introspection constructors: backend-free by construction,
# so they may stay bare (the reference's list)
DTYPE_WHITELIST = frozenset({
    "bool_", "dtype", "finfo", "float16", "float32", "float64", "iinfo",
    "int8", "int16", "int32", "int64", "promote_types", "result_type",
    "uint8", "uint16", "uint32", "uint64",
})

_BACKEND_PREFIXES = ("numpy.", "torch.")


def _param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


@register
class XpGenericRule(Rule):
    """Functions taking ``xp`` may only do array math through ``xp``."""

    rule_id = "SL001"
    title = ("xp-generic functions must not call bare np./torch. math "
             "(backend drift)")

    def check(self, ctx: ModuleContext,
              project: ProjectIndex) -> Iterator[Finding]:
        seen: set[tuple[int, int]] = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if XP_PARAM not in _param_names(fn):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = ctx.call_name(node)
                if name is None:
                    continue
                if not name.startswith(_BACKEND_PREFIXES):
                    continue
                leaf = name.rsplit(".", 1)[-1]
                if leaf in DTYPE_WHITELIST:
                    continue
                key = (node.lineno, node.col_offset)
                if key in seen:                 # nested xp closures re-walk
                    continue
                seen.add(key)
                yield self.finding(
                    ctx, node,
                    f"bare backend call '{name}' inside xp-generic "
                    f"function '{fn.name}' — use xp.{leaf} (or hoist "
                    "static constants into an xp-less helper)")
