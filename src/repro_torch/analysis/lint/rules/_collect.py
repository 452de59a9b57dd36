"""Project facts the torch rules share: memoised callables, tensor values.

The counterpart of the reference's ``rules/_jitutil.py``, whose
``collect_jitted`` found the callables jitted with ``static_argnames``.
The port has no ``jax.jit``; what it shares across modules instead:

* ``collect_memoised`` — callables wrapped in ``functools.lru_cache`` /
  ``functools.cache``, decorated (``@functools.lru_cache(maxsize=256)``
  on ``core.modelzoo.get_model``) or assigned (``name =
  functools.cache(inner)``).  Every argument of such a callable is part
  of its cache key, the torch counterpart of a static jit argument
  (SL005).
* ``collect_tensor_fns`` — top-level functions annotated ``->
  torch.Tensor`` (``Optional`` included) or a tuple of tensors, so a
  call to one in another module is known to be tensor-valued (SL002,
  SL004).
* ``TensorFacts`` — which expressions of a module are tensor-valued: a
  ``torch.*`` call that returns a tensor; a name assigned from a
  tensor-valued expression, one assignment step back (as SL004 looks
  back), or a parameter annotated ``torch.Tensor``; a call to a project
  function in ``ProjectIndex.tensor_fns``; and indexing, arithmetic,
  comparisons and tensor-returning methods of those.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Union

from ..context import ModuleContext
from .base import MemoSig, ProjectIndex

__all__ = ["TensorFacts", "collect_memoised", "collect_tensor_fns",
           "is_tensor_annotation"]

_MEMOISERS = frozenset({"functools.lru_cache", "functools.cache"})

# ``torch.<leaf>`` calls that return something other than a tensor
_TORCH_NON_TENSOR = frozenset({
    "allclose", "are_deterministic_algorithms_enabled", "broadcast_shapes",
    "can_cast", "compile", "device", "dtype", "enable_grad", "equal",
    "finfo", "get_default_device", "get_default_dtype", "get_num_threads",
    "iinfo", "inference_mode", "initial_seed", "is_complex",
    "is_floating_point", "is_grad_enabled", "is_nonzero", "is_tensor",
    "load", "manual_seed", "no_grad", "numel", "promote_types",
    "result_type", "save", "seed", "set_default_device",
    "set_default_dtype", "set_grad_enabled", "set_num_threads",
    "set_printoptions", "set_rng_state", "typename",
    "use_deterministic_algorithms",
})
# submodules whose functions return tensors
_TORCH_TENSOR_MODULES = ("torch.nn.functional.", "torch.linalg.",
                         "torch.fft.", "torch.special.")
# tensor methods that return host values or metadata, not tensors
_NON_TENSOR_METHODS = frozenset({
    "data_ptr", "dim", "element_size", "equal", "get_device",
    "is_complex", "is_contiguous", "is_floating_point", "item",
    "nelement", "numel", "numpy", "size", "storage_offset", "stride",
    "tolist",
})
# tensor attributes that are tensors
_TENSOR_ATTRS = frozenset({"H", "T", "data", "grad", "imag", "indices",
                           "mH", "mT", "real", "values"})
# how far a name is followed back through its assignments
_LOOKBACK = 1

_Def = Union[ast.FunctionDef, ast.AsyncFunctionDef]


def torch_returns_tensor(name: str) -> bool:
    """Is ``name`` a ``torch`` function that returns a tensor?

    Classes (``torch.Generator``, ``torch.Size``) and the non-tensor
    helpers of ``_TORCH_NON_TENSOR`` are not; ``torch.cuda.*`` and the
    other submodules but the math ones are not.
    """
    if not name.startswith("torch."):
        return False
    rest = name[len("torch."):]
    if "." in rest:
        return name.startswith(_TORCH_TENSOR_MODULES)
    return not rest[:1].isupper() and rest not in _TORCH_NON_TENSOR


def _parse_str_annotation(ann: ast.AST) -> ast.AST:
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            return ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return ann
    return ann


def is_tensor_annotation(ctx: ModuleContext, ann: ast.AST | None) -> bool:
    """``torch.Tensor``, ``Optional[torch.Tensor]`` or ``torch.Tensor |
    None`` (also as a string annotation)."""
    if ann is None:
        return False
    ann = _parse_str_annotation(ann)
    if ctx.resolve(ann) == "torch.Tensor":
        return True
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        sides = (ann.left, ann.right)
        return (any(is_tensor_annotation(ctx, s) for s in sides)
                and all(is_tensor_annotation(ctx, s)
                        or (isinstance(s, ast.Constant) and s.value is None)
                        for s in sides))
    if isinstance(ann, ast.Subscript) and ctx.resolve(ann.value) in (
            "typing.Optional", "Optional"):
        return is_tensor_annotation(ctx, ann.slice)
    return False


def _is_tensor_return(ctx: ModuleContext, ann: ast.AST | None) -> bool:
    """A tensor annotation, or a tuple of them (``tuple[torch.Tensor,
    ...]``, ``Tuple[torch.Tensor, torch.Tensor]``)."""
    if ann is None:
        return False
    ann = _parse_str_annotation(ann)
    if is_tensor_annotation(ctx, ann):
        return True
    if not isinstance(ann, ast.Subscript):
        return False
    head = ann.value
    if not ((isinstance(head, ast.Name) and head.id == "tuple")
            or ctx.resolve(head) in ("typing.Tuple", "Tuple")):
        return False
    elts = (ann.slice.elts if isinstance(ann.slice, ast.Tuple)
            else [ann.slice])
    elts = [e for e in elts if not (isinstance(e, ast.Constant)
                                    and e.value is Ellipsis)]
    return bool(elts) and all(is_tensor_annotation(ctx, e) for e in elts)


def _positional_params(fn: _Def) -> tuple[str, ...]:
    return tuple(a.arg for a in fn.args.posonlyargs + fn.args.args)


def _is_memoiser(ctx: ModuleContext, node: ast.AST) -> bool:
    """``functools.lru_cache`` / ``functools.cache``, bare or called."""
    if isinstance(node, ast.Call):
        node = node.func
    return ctx.resolve(node) in _MEMOISERS


def collect_memoised(ctx: ModuleContext) -> dict[str, MemoSig]:
    """Local name -> memoised signature for the module's top level."""
    defs: dict[str, _Def] = {
        n.name: n for n in ctx.tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out: dict[str, MemoSig] = {}

    def record(name: str, params: tuple[str, ...] | None) -> None:
        out[name] = MemoSig(qualname=f"{ctx.module_name}.{name}",
                            params=params)

    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_memoiser(ctx, d) for d in node.decorator_list):
                record(node.name, _positional_params(node))
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)
              and isinstance(node.value, ast.Call)):
            call = node.value
            # name = lru_cache(maxsize=...)(inner) | cache(inner)
            wrapped = (_is_memoiser(ctx, call.func)
                       if isinstance(call.func, ast.Call)
                       else ctx.call_name(call) in _MEMOISERS)
            if not wrapped:
                continue
            params = None
            if call.args and isinstance(call.args[0], ast.Name):
                inner = defs.get(call.args[0].id)
                if inner is not None:
                    params = _positional_params(inner)
            record(node.targets[0].id, params)
    return out


def collect_tensor_fns(ctx: ModuleContext) -> set[str]:
    """Qualnames of the module's top-level functions returning tensors."""
    return {f"{ctx.module_name}.{n.name}" for n in ctx.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and _is_tensor_return(ctx, n.returns)}


@dataclass
class _Scope:
    """Names bound in one function (or the module) body."""

    parent: "_Scope | None"
    # parameter -> annotated torch.Tensor
    params: dict[str, bool] = field(default_factory=dict)
    # name -> [(line, assigned value)] in source order
    assigns: dict[str, list[tuple[int, ast.AST]]] = field(
        default_factory=dict)


class _ScopeMapper(ast.NodeVisitor):
    """Map every node to the scope it is evaluated in."""

    def __init__(self, ctx: ModuleContext) -> None:
        self.ctx = ctx
        self.module = _Scope(parent=None)
        self.stack: list[_Scope] = [self.module]
        self.scope_of: dict[int, _Scope] = {}

    def generic_visit(self, node: ast.AST) -> None:
        self.scope_of[id(node)] = self.stack[-1]
        super().generic_visit(node)

    def _function(self, node: _Def | ast.Lambda) -> None:
        self.scope_of[id(node)] = self.stack[-1]
        a = node.args
        outer: list[ast.AST] = [*a.defaults,
                                *(d for d in a.kw_defaults if d)]
        if not isinstance(node, ast.Lambda):
            outer.extend(node.decorator_list)
        for n in outer:
            self.visit(n)
        # a method sees the module's names, not its class body's
        parent = self.stack[-1]
        scope = _Scope(parent=parent)
        for p in [*a.posonlyargs, *a.args, *a.kwonlyargs,
                  *(x for x in (a.vararg, a.kwarg) if x)]:
            scope.params[p.arg] = is_tensor_annotation(self.ctx,
                                                       p.annotation)
        self.stack.append(scope)
        body = [node.body] if isinstance(node, ast.Lambda) else node.body
        for stmt in body:
            self.visit(stmt)
        self.stack.pop()

    visit_FunctionDef = _function
    visit_AsyncFunctionDef = _function
    visit_Lambda = _function

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        scope = self.stack[-1]
        if isinstance(target, ast.Name):
            scope.assigns.setdefault(target.id, []).append(
                (target.lineno, value))
        elif isinstance(target, (ast.Tuple, ast.List)):
            # ``vals, idx = torch.sort(x)``: each name takes a part of a
            # tensor-valued call's result
            for elt in target.elts:
                self._bind(elt.value if isinstance(elt, ast.Starred)
                           else elt, value)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._bind(target, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if isinstance(node.target, ast.Name):
            if is_tensor_annotation(self.ctx, node.annotation):
                # the annotation speaks for the value
                self.stack[-1].params[node.target.id] = True
            elif node.value is not None:
                self._bind(node.target, node.value)
        self.generic_visit(node)

    def visit_NamedExpr(self, node: ast.NamedExpr) -> None:
        self._bind(node.target, node.value)
        self.generic_visit(node)


class TensorFacts:
    """Which expressions of one module are tensor-valued."""

    def __init__(self, ctx: ModuleContext, project: ProjectIndex) -> None:
        self.ctx = ctx
        self.project = project
        mapper = _ScopeMapper(ctx)
        mapper.visit(ctx.tree)
        self._scope_of = mapper.scope_of
        self._module = mapper.module

    def scope(self, node: ast.AST) -> _Scope:
        """The scope ``node`` is evaluated in."""
        return self._scope_of.get(id(node), self._module)

    def binding(self, name: ast.Name) -> tuple[_Scope, ast.AST] | bool | None:
        """What ``name`` refers to where it is read.

        ``True`` / ``False`` for a parameter (annotated ``torch.Tensor``
        or not), ``(scope, value)`` for the assignment that bound it last
        before this line (the last one at all when none precedes it, as
        in a loop, or when it is a module global read in a function), or
        None when nothing binds it.
        """
        scope: _Scope | None = self.scope(name)
        local = True
        while scope is not None:
            if name.id in scope.params:
                return scope.params[name.id]
            entries = scope.assigns.get(name.id)
            if entries:
                before = [v for line, v in entries if line < name.lineno]
                value = before[-1] if before and local else entries[-1][1]
                return self.scope(value), value
            scope = scope.parent
            local = False
        return None

    def is_tensor(self, node: ast.AST, depth: int = 0) -> bool:
        """Is ``node`` a tensor-valued expression?"""
        if isinstance(node, ast.Call):
            return self._call_is_tensor(node, depth)
        if isinstance(node, ast.Name):
            bound = self.binding(node)
            if isinstance(bound, bool):
                return bound
            if bound is None or depth >= _LOOKBACK:
                return False
            return self.is_tensor(bound[1], depth + 1)
        if isinstance(node, ast.Attribute):
            return (node.attr in _TENSOR_ATTRS
                    and self.is_tensor(node.value, depth))
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value, depth)
        if isinstance(node, ast.BinOp):
            return (self.is_tensor(node.left, depth)
                    or self.is_tensor(node.right, depth))
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand, depth)
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1 or isinstance(
                    node.ops[0], (ast.Is, ast.IsNot, ast.In, ast.NotIn)):
                return False
            return (self.is_tensor(node.left, depth)
                    or self.is_tensor(node.comparators[0], depth))
        if isinstance(node, ast.IfExp):
            return (self.is_tensor(node.body, depth)
                    or self.is_tensor(node.orelse, depth))
        return False

    def _call_is_tensor(self, call: ast.Call, depth: int) -> bool:
        name = self.ctx.call_name(call)
        if name is not None:
            return (torch_returns_tensor(name)
                    or self.project.returns_tensor(name))
        func = call.func
        if isinstance(func, ast.Name):
            # a module-local function (not an import: those resolve)
            return (f"{self.ctx.module_name}.{func.id}"
                    in self.project.tensor_fns)
        if isinstance(func, ast.Attribute):
            return (func.attr not in _NON_TENSOR_METHODS
                    and self.is_tensor(func.value, depth))
        return False

    def is_from_numpy(self, node: ast.AST, depth: int = 0) -> bool:
        """``torch.from_numpy(...)``, or a name bound from one."""
        if isinstance(node, ast.Call):
            return self.ctx.call_name(node) == "torch.from_numpy"
        if isinstance(node, ast.Name) and depth < _LOOKBACK:
            bound = self.binding(node)
            if isinstance(bound, tuple):
                return self.is_from_numpy(bound[1], depth + 1)
        return False
