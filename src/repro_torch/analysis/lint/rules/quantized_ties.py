"""SL004 — score orderings must flow through the shared quantiser, stably.

Cross-backend plan identity hinges on one rule: before any *ordering*
decision, scores are rounded to ``core.quantize.SCORE_SIG`` significant
digits (``quantize_scores`` on the host, ``quantize_scores_torch`` on the
device) so float32 device scores and float64 host scores land in the same
bucket and ties fall back to stable enumeration order.  A sort over *raw*
scores reintroduces backend-dependent tie-breaks — plans stay "correct"
but stop being bit-identical across the numpy oracle, the plain torch
forms and the CUDA kernels.

Torch adds two traps the reference's numpy and ``lax.top_k`` did not
have.  ``torch.sort`` / ``argsort`` are stable only when asked
(``stable=True``): quantising *makes* ties, and only a stable sort gives
them the enumeration order.  ``torch.topk`` promises no tie order at all
(on ``zeros(10)``, k = 3 gave ``[8, 6, 7]`` on the card).

Findings, on ``numpy.argsort`` / ``lexsort``, ``torch.sort`` /
``argsort`` / ``msort`` / ``topk`` and the ``.sort`` / ``.argsort`` /
``.msort`` / ``.topk`` methods of a tensor-valued receiver (a Python
``list.sort`` is not one):

* the reference's: the operand (or, one assignment step back, what it was
  computed from) mentions an identifier whose name contains a ``score``
  / ``fitness`` word-segment, and no ``quantize_scores`` /
  ``quantize_scores_torch`` call appears in that derivation;
* a torch sort of a score-derived operand without ``stable=True``, even
  when it is quantised;
* ``torch.topk`` / ``.topk`` in ``core/``, ``kernels/`` or ``models/``,
  whatever its operand: take a stable sort and slice.

Orderings that are *intentionally* unquantised (pure-f64 host paths
mirrored exactly by the device program) carry ``# scarlint:
ignore[SL004]`` with the reason.
"""
from __future__ import annotations

import ast
import re
from pathlib import PurePosixPath
from typing import Iterator

from ..context import ModuleContext
from ..findings import Finding
from .base import ProjectIndex, Rule, register
from ._collect import TensorFacts, collect_tensor_fns

NUMPY_SORTERS = frozenset({"numpy.argsort", "numpy.lexsort"})
TORCH_SORTERS = frozenset({"torch.sort", "torch.argsort", "torch.msort",
                           "torch.topk"})
SORTERS = NUMPY_SORTERS | TORCH_SORTERS
SORT_METHODS = frozenset({"sort", "argsort", "msort", "topk"})
QUANTIZERS = frozenset({"quantize_scores", "quantize_scores_torch"})
# keyword arguments that are not operands
_NON_OPERANDS = ("axis", "kind", "order", "dim", "stable", "descending",
                 "k", "largest", "sorted", "out")
# where ties decide plans and outputs, so ``topk`` is out
_TOPK_DIRS = ("core", "kernels", "models")

_SCOREISH = re.compile(r"(?:^|_)(?:score|scores|fitness)(?:_|$)")


def _tokens(node: ast.AST) -> set[str]:
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _has_quantize(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            leaf = (f.id if isinstance(f, ast.Name)
                    else f.attr if isinstance(f, ast.Attribute) else None)
            if leaf in QUANTIZERS:
                return True
    return False


def _scoreish(tokens: set[str]) -> bool:
    return any(_SCOREISH.search(t.lower()) for t in tokens)


def _scopes(tree: ast.Module) -> list[ast.AST]:
    out: list[ast.AST] = [tree]
    out.extend(n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return out


def _is_stable(call: ast.Call) -> bool:
    return any(kw.arg == "stable" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


@register
class QuantizedTiesRule(Rule):
    """Score orderings must quantise; torch ones must also be stable."""

    rule_id = "SL004"
    title = ("score/fitness orderings must round through core.quantize "
             "and sort stably; no torch topk where ties matter")

    def collect(self, ctx: ModuleContext, project: ProjectIndex) -> None:
        project.tensor_fns |= collect_tensor_fns(ctx)

    def _sorter(self, ctx: ModuleContext, facts: TensorFacts,
                node: ast.Call) -> tuple[str, list[ast.AST]] | None:
        """``(label, operands)`` of a sort call, None for other calls."""
        name = ctx.call_name(node)
        if name in SORTERS:
            return name, list(node.args)
        func = node.func
        if (name is None and isinstance(func, ast.Attribute)
                and func.attr in SORT_METHODS
                and facts.is_tensor(func.value)):
            return f"Tensor.{func.attr}", [func.value]
        return None

    def check(self, ctx: ModuleContext,
              project: ProjectIndex) -> Iterator[Finding]:
        facts = TensorFacts(ctx, project)
        parts = PurePosixPath(ctx.rel_path.replace("\\", "/")).parts
        topk_banned = any(d in parts for d in _TOPK_DIRS)
        seen: set[tuple[int, int]] = set()
        for scope in _scopes(ctx.tree):
            # name -> assigned value expressions within this scope
            assigns: dict[str, list[ast.AST]] = {}
            for node in ast.walk(scope):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    assigns.setdefault(node.targets[0].id,
                                       []).append(node.value)
            for node in ast.walk(scope):
                if not isinstance(node, ast.Call):
                    continue
                key = (node.lineno, node.col_offset)
                if key in seen:
                    continue
                sorter = self._sorter(ctx, facts, node)
                if sorter is None:
                    continue
                name, operands = sorter
                leaf = name.rsplit(".", 1)[-1]
                is_torch = not name.startswith("numpy.")
                topk_msg = (f"'{name}' breaks ties in no fixed order — "
                            "take a stable sort (torch.sort(..., "
                            "stable=True)) and slice")
                if leaf == "topk" and topk_banned:
                    seen.add(key)
                    yield self.finding(ctx, node, topk_msg)
                    continue
                operands.extend(kw.value for kw in node.keywords
                                if kw.arg not in _NON_OPERANDS)
                quantized = any(_has_quantize(op) for op in operands)
                tokens: set[str] = set()
                for op in operands:
                    tokens |= _tokens(op)
                    # one dataflow step: expand plain-name operands through
                    # their in-scope assignments
                    for n in ast.walk(op):
                        if not isinstance(n, ast.Name):
                            continue
                        for value in assigns.get(n.id, ()):
                            if _has_quantize(value):
                                quantized = True
                            else:
                                tokens |= _tokens(value)
                if not quantized and not _scoreish(tokens):
                    continue
                if not quantized:
                    seen.add(key)
                    yield self.finding(
                        ctx, node,
                        f"'{name}' orders a score-derived operand without "
                        "the shared quantiser — round with core.quantize."
                        "quantize_scores{_torch}(..., sig=SCORE_SIG) before "
                        f"the {leaf} so backend choice cannot reorder ties")
                elif leaf == "topk":
                    seen.add(key)
                    yield self.finding(ctx, node, topk_msg)
                elif is_torch and not _is_stable(node):
                    seen.add(key)
                    yield self.finding(
                        ctx, node,
                        f"'{name}' orders quantised scores without "
                        "stable=True — quantising makes ties, and only a "
                        "stable sort (torch.sort(..., stable=True)) gives "
                        "them the enumeration order")
