"""SL002 — counted-sync discipline in ``core/`` and ``kernels/``.

The fused device search promises *one* host sync per window, and every
sync-count invariant of the port reads the ``launch.platform.sync_count``
registry counter that ``launch.platform.device_fetch`` increments.  In
torch a sync hides in many calls: ``.item()``, ``.cpu()``, ``.numpy()``,
``.tolist()`` or ``float()``/``int()``/``bool()`` of a CUDA tensor copies
it to the host and waits; ``torch.nonzero`` waits for its output's size;
``torch.cuda.synchronize`` waits for everything.  A host-to-device copy
blocks too: ``torch.tensor(host, device=...)``, ``torch.as_tensor(host,
device=...)`` and ``torch.from_numpy(host).to(device)`` copy from pageable
memory, which the host waits for.  The plan stays correct, but the sync
accounting — and with it the O(1)-syncs-per-window contract — silently
forks, and each blocking copy costs a round trip.

Findings, in files under ``core/`` and ``kernels/``:

* always: ``torch.cuda.synchronize``, ``torch.nonzero`` /
  ``.nonzero()`` and the other calls whose output size depends on the
  data (``argwhere``, ``masked_select``, ``unique``, one-argument
  ``where``), and ``torch.equal`` / ``allclose`` / ``is_nonzero``, which
  return a Python bool;
* on a tensor-valued receiver or argument (``_collect.TensorFacts``):
  ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, ``.to("cpu")``,
  ``float(...)`` / ``int(...)`` / ``bool(...)``, ``np.asarray(...)`` /
  ``np.array(...)``;
* host-to-device copies: ``torch.tensor(..., device=...)``,
  ``torch.as_tensor(..., device=...)``, and ``.to(<device>)`` /
  ``.cuda()`` on ``torch.from_numpy(...)`` or a name bound from it.

Host numpy stays clean: ``np.nonzero``, ``np.flatnonzero`` and
``.tolist()`` of a fetched array are not tensor operations.

``launch/platform.py`` is outside the scope by construction: it is the
sanctioned site of both ``device_fetch`` and ``device_upload`` (one copy
per dtype however many arrays).  A copy that is right by design, such as
a table uploaded once per process and cached, carries ``# scarlint:
ignore[SL002] -- <reason>``.
"""
from __future__ import annotations

import ast
from pathlib import PurePosixPath
from typing import Iterator

from ..context import ModuleContext
from ..findings import Finding
from .base import ProjectIndex, Rule, register
from ._collect import TensorFacts, collect_tensor_fns

# calls that synchronise whatever their arguments
_ALWAYS_SYNC = {
    "torch.cuda.synchronize": "waits for every stream",
    "torch.nonzero": "waits for its data-dependent output size",
    "torch.argwhere": "waits for its data-dependent output size",
    "torch.masked_select": "waits for its data-dependent output size",
    "torch.unique": "waits for its data-dependent output size",
    "torch.unique_consecutive": "waits for its data-dependent output size",
    "torch.equal": "returns a host bool",
    "torch.allclose": "returns a host bool",
    "torch.is_nonzero": "returns a host bool",
}
_ALWAYS_SYNC_METHODS = ("nonzero",)
# methods that copy a tensor to the host
_FETCH_METHODS = ("item", "cpu", "numpy", "tolist")
_WRAPPER_BUILTINS = ("float", "int", "bool")
_WRAPPER_CALLS = ("numpy.asarray", "numpy.array")
_UPLOAD_CALLS = ("torch.tensor", "torch.as_tensor")

_SCOPE_DIRS = ("core", "kernels")

_FETCH_HINT = ("is an uncounted device->host sync — fetch through "
               "launch.platform.device_fetch")
_UPLOAD_HINT = ("is a blocking host->device copy — upload through "
                "launch.platform.device_upload (one copy per dtype) or "
                "build the value on the device")


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _device_kw(call: ast.Call) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return None


@register
class SyncDisciplineRule(Rule):
    """Device<->host transfers must route through the counted helpers."""

    rule_id = "SL002"
    title = ("core/ and kernels/ must fetch through "
             "launch.platform.device_fetch and upload through "
             "device_upload (no hidden torch syncs)")

    def applies_to(self, ctx: ModuleContext) -> bool:
        parts = PurePosixPath(ctx.rel_path.replace("\\", "/")).parts
        return any(d in parts for d in _SCOPE_DIRS)

    def collect(self, ctx: ModuleContext, project: ProjectIndex) -> None:
        project.tensor_fns |= collect_tensor_fns(ctx)

    # ------------------------------------------------------------------

    def _move_target(self, ctx: ModuleContext,
                     call: ast.Call) -> ast.AST | None:
        """The device of ``x.to(...)``, None when it only casts."""
        dev = _device_kw(call)
        if dev is not None:
            return dev
        if call.args:
            first = call.args[0]
            name = ctx.resolve(first)
            if name is not None and name.startswith("torch."):
                return None                    # ``.to(torch.float64)``
            return first
        return None

    def check(self, ctx: ModuleContext,
              project: ProjectIndex) -> Iterator[Finding]:
        facts = TensorFacts(ctx, project)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.call_name(node)
            func = node.func
            if name in _ALWAYS_SYNC:
                yield self.finding(
                    ctx, node, f"'{name}' {_ALWAYS_SYNC[name]}: a hidden "
                    "host sync — keep it out of the device path or fetch "
                    "through launch.platform.device_fetch")
            elif name == "torch.where" and len(node.args) == 1 \
                    and not node.keywords:
                yield self.finding(
                    ctx, node, "one-argument 'torch.where' is "
                    "torch.nonzero: a hidden host sync")
            elif name in _UPLOAD_CALLS:
                dev = _device_kw(node)
                if dev is not None and not _is_cpu(dev):
                    yield self.finding(ctx, node,
                                       f"'{name}(..., device=...)' "
                                       f"{_UPLOAD_HINT}")
            elif name in _WRAPPER_CALLS or (
                    isinstance(func, ast.Name)
                    and func.id in _WRAPPER_BUILTINS and name is None):
                if node.args and facts.is_tensor(node.args[0]):
                    label = name or getattr(func, "id", "?")
                    yield self.finding(
                        ctx, node, f"'{label}(...)' of a tensor "
                        f"{_FETCH_HINT} first")
            elif isinstance(func, ast.Attribute):
                yield from self._method(ctx, facts, node, func)

    def _method(self, ctx: ModuleContext, facts: TensorFacts,
                node: ast.Call, func: ast.Attribute) -> Iterator[Finding]:
        attr, recv = func.attr, func.value
        if attr in _ALWAYS_SYNC_METHODS and not node.args:
            yield self.finding(
                ctx, node, f"'.{attr}()' waits for its data-dependent "
                "output size: a hidden host sync")
        elif attr in _FETCH_METHODS and facts.is_tensor(recv):
            yield self.finding(ctx, node,
                               f"'.{attr}()' of a tensor {_FETCH_HINT}")
        elif attr == "to":
            target = self._move_target(ctx, node)
            if target is None:
                return
            if _is_cpu(target):
                if facts.is_tensor(recv):
                    yield self.finding(
                        ctx, node, f"'.to(\"cpu\")' of a tensor "
                        f"{_FETCH_HINT}")
            elif facts.is_from_numpy(recv):
                yield self.finding(
                    ctx, node, "'torch.from_numpy(...).to(<device>)' "
                    f"{_UPLOAD_HINT}")
        elif attr == "cuda" and facts.is_from_numpy(recv):
            yield self.finding(
                ctx, node, f"'torch.from_numpy(...).cuda()' {_UPLOAD_HINT}")
