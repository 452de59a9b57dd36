"""Cost of a traced torch program: the port's stand-in for the reference's
``analysis/hlo_cost.py``.

The reference compiles a cell and walks XLA's post-SPMD HLO text.  The
port has no compiled program to read: it runs eagerly, so ``CostTrace``
(a ``TorchDispatchMode``) counts what the program dispatches while it runs,
typically on ``meta`` tensors (shapes and types, no values, no memory), and
returns a ``CostResult`` with the reference's fields:

* ``flops``: products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions: ``torch.utils.flop_counter``'s formulas, 2 M N K), ops
  tagged ``torch.Tag.pointwise`` (one an output element) and reductions,
  softmax and log-sum-exp among them (one an input element).
  ``dot_flops`` is the products alone: the one figure that compares
  across XLA and eager (the two break elementwise work into different
  ops).
* ``bytes_accessed``: each op's tensor operands plus its results, views
  free.  Nothing is fused in eager mode, so this is the most the plain
  path moves, an upper bound on what fused kernels move.  As in
  ``hlo_cost``, a gather-like op (``index``, ``gather``, ``embedding``,
  ``index_select``) counts twice its result and a scatter-like one
  (``index_put``, ``scatter``, ``index_add``, the embedding's backward)
  twice its update; ``copy_`` reads its source and writes as much.
* collectives: read from the port's own counted calls
  (``distributed.collectives``), each with its group's size, through
  ``hlo_cost._collective_stats``' operand and ring-link formulas, keyed
  ``"{kind}:g{group}"`` (``all-reduce``, ``all-gather``, ``broadcast`` and,
  for the int8 ring's hops, ``collective-permute``).  The port's FSDP
  reduce-scatter is an all-reduce and a narrow (gloo has none), and is
  counted as what it runs.
* ``peak_bytes``: the most bytes of storage the trace allocated that were
  alive at once (storages that existed before it, the arguments, are not
  counted).
* ``loops``: ``(name, trips)`` of each recurrence the loop shortcut
  counted.

The loop shortcut.  Loops whose every step does the same work run through
``trace_hooks.recurrence``: the plain recurrences that step once a
position or a chunk (the sLSTM forward and backward, the SSD scan's chunk
loops) and the training step's microbatches.  Each writes what grows with
its steps into tensors allocated before it and carries only tensors of
fixed shapes from step to step.  On ``meta`` the trace runs the first two
and the first three steps of a loop of ``trips >=
trace_hooks.SHORTCUT_MIN`` steps and counts them all as ``c2 + (trips -
2) (c3 - c2)``: from the second step on every step dispatches the same ops
on the same shapes and holds the same storage (the first holds the carry
handed in, which the trace may not have allocated), so the counts, and
the most storage alive within the loop, are affine in the trip count.
Both equal the full loop's (``tests/test_torch_trace_cost.py``);
``CostTrace(loop_shortcut=False)`` runs the full loop.
``distributed.collectives.stats()`` counts only the steps the trace ran;
the result's ``by_collective`` counts them all.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import trace_hooks

__all__ = ["CostResult", "CostTrace", "collective_stats"]

aten = torch.ops.aten

# a view whose schema does not say so (``OpOverload.is_view``)
_FREE = {aten._unsafe_view}
_EMPTY = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
_WRITE_ONLY = {aten.zeros, aten.ones, aten.full, aten.arange,
               aten.scalar_tensor, aten.zeros_like, aten.ones_like,
               aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full,
               aten.fill_, aten.zero_}
_GATHER = {aten.index, aten.gather, aten.embedding, aten.index_select}
# scatter-like ops and the position of their update operand
_SCATTER = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
            aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3,
            aten.scatter_add_: 3, aten.index_add: 3, aten.index_add_: 3,
            aten.embedding_dense_backward: 0}
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.prod, aten.argmax, aten.argmin, aten.any,
               aten.all, aten.cumsum, aten.logsumexp, aten.var_mean,
               aten.var, aten.std, aten.norm, aten.linalg_vector_norm,
               aten._softmax, aten._log_softmax,
               aten._softmax_backward_data, aten._log_softmax_backward_data}


def collective_stats(kind: str, size: float, group: int) -> tuple[float,
                                                                  float]:
    """``(operand, link)`` bytes of a collective whose result is ``size``
    bytes over a group of ``group`` ranks: ``hlo_cost._collective_stats``'
    formulas (all-gather operand ``size / g``, ring link ``size (g - 1) /
    g``; reduce-scatter ``size g`` and ``size (g - 1)``; all-reduce ``size``
    and ``2 size (g - 1) / g``; anything else ``size`` and ``size``)."""
    g = max(group, 1)
    if kind == "all-gather":
        return size / g, size * (g - 1) / g
    if kind == "reduce-scatter":
        return size * g, size * (g - 1)
    if kind == "all-reduce":
        return size, 2.0 * size * (g - 1) / g
    return size, size


# the port's collectives (``distributed.collectives``, by operation) as
# HLO kinds
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "broadcast": "broadcast", "send_recv": "collective-permute"}


@dataclasses.dataclass
class CostResult:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_operand_bytes: float = 0.0
    collective_link_bytes: float = 0.0
    by_collective: dict = dataclasses.field(default_factory=dict)
    loops: list = dataclasses.field(default_factory=list)
    dot_flops: float = 0.0
    peak_bytes: float = 0.0
    # {"aten.mm": [calls, flops, bytes], ...}
    by_op: dict = dataclasses.field(default_factory=dict)

    def add_collective(self, kind: str, operand: float, link: float,
                       group: int, mult: float) -> None:
        """``hlo_cost.CostResult.add_collective``."""
        self.collective_operand_bytes += operand * mult
        self.collective_link_bytes += link * mult
        d = self.by_collective.setdefault(f"{kind}:g{group}", {
            "operand": 0.0, "link": 0.0, "count": 0.0})
        d["operand"] += operand * mult
        d["link"] += link * mult
        d["count"] += mult

    def _add_op(self, name: str, flops: float, nbytes: float,
                dot: bool) -> None:
        self.flops += flops
        self.bytes_accessed += nbytes
        if dot:
            self.dot_flops += flops
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def extend(self, c1: "CostResult", c2: "CostResult", k: int) -> None:
        """Add ``c1 + (k - 1) (c2 - c1)``: from a loop's runs of n and n + 1
        steps, its run of n + k - 1."""
        def aff(a, b):
            return a + (k - 1) * (b - a)
        for f in ("flops", "bytes_accessed", "dot_flops",
                  "collective_operand_bytes", "collective_link_bytes"):
            setattr(self, f, getattr(self, f) + aff(getattr(c1, f),
                                                    getattr(c2, f)))
        for name in set(c1.by_op) | set(c2.by_op):
            a = c1.by_op.get(name, [0, 0.0, 0.0])
            b = c2.by_op.get(name, [0, 0.0, 0.0])
            row = self.by_op.setdefault(name, [0, 0.0, 0.0])
            for i in range(3):
                row[i] += aff(a[i], b[i])
        for key in set(c1.by_collective) | set(c2.by_collective):
            a = c1.by_collective.get(key, {})
            b = c2.by_collective.get(key, {})
            d = self.by_collective.setdefault(key, {
                "operand": 0.0, "link": 0.0, "count": 0.0})
            for f in d:
                d[f] += aff(a.get(f, 0.0), b.get(f, 0.0))
        self.loops.extend(c1.loops)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostTrace(TorchDispatchMode):
    """Counts what runs under it into ``self.result`` (a ``CostResult``)::

        with CostTrace() as t:
            step(*args)
        t.result.flops, t.result.dot_flops, t.result.peak_bytes

    ``loop_shortcut``: count ``trace_hooks.recurrence`` loops on ``meta``
    from their first steps (the module note).  Collectives are read from
    ``distributed.collectives`` while the trace is open."""

    def __init__(self, loop_shortcut: bool = True):
        super().__init__()
        self.result = CostResult()
        self.loop_shortcut = loop_shortcut
        self._live = 0
        self._tracked: dict[int, int] = {}
        self._saved: list = []

    # -- entering and leaving ---------------------------------------------
    def __enter__(self):
        self._saved = [trace_hooks.TRACE]
        trace_hooks.TRACE = self
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            trace_hooks.TRACE = self._saved[0]

    # -- collectives ---------------------------------------------------------
    def collective(self, op: str, nbytes: int, group: int) -> None:
        """``trace_hooks.collective``: one counted collective."""
        kind = _KINDS[op]
        # the result's size: an all-gather's is every rank's block, a
        # reduce-scatter's one block of what the rank hands it
        size = (nbytes * group if kind == "all-gather"
                else nbytes / group if kind == "reduce-scatter" else nbytes)
        operand, link = collective_stats(kind, float(size), group)
        self.result.add_collective(kind, operand, link, group, 1.0)

    # -- memory --------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = n
        self._live += n
        self.result.peak_bytes = max(self.result.peak_bytes, self._live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._tracked.pop(key, 0)

    # -- the loop shortcut --------------------------------------------------
    def loop(self, run: Callable[[int], Any], trips: int) -> Any:
        """``trace_hooks.recurrence``' shortcut: ``run(trips)`` counted from
        ``run(2)`` and ``run(3)`` (the module note).  Returns ``run(3)``'s
        carry (the shapes of the full loop's)."""
        outer, live0 = self.result, self._live
        runs = []
        for n in (2, 3):
            carry = None        # run(2)'s is not held while run(3) runs
            self.result = CostResult(peak_bytes=live0)
            try:
                carry = run(n)
            finally:
                part, self.result = self.result, outer
            shapes = [t.shape for t in _tensors(carry)]
            runs.append((part, part.peak_bytes - live0, shapes))
        (c2, d2, s2), (c3, d3, s3) = runs
        if s2 != s3:
            raise ValueError("loop shortcut: a carry whose shape grows with "
                             "the steps")
        outer.extend(c2, c3, trips - 1)
        name = getattr(run, "__qualname__", "loop").split(".<locals>")[0]
        outer.loops.append((name, trips))
        outer.peak_bytes = max(outer.peak_bytes,
                               live0 + d2 + (trips - 2) * (d3 - d2))
        return carry

    # -- counting ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in _FREE or func.namespace != "aten":
            # views, and the process group's own ops (counted as
            # collectives from ``distributed.collectives``)
            return out
        outs, ins = _tensors(out), _tensors((args, kwargs))
        written = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            if id(t.untyped_storage()) not in written:   # not in place
                self._track(t)
        self._count(func, packet, args, kwargs, out, outs, ins)
        return out

    def _count(self, func, packet, args, kwargs, out, outs, ins) -> None:
        dot = packet in flop_registry
        if dot:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        elif torch.Tag.pointwise in func.tags:
            flops = float(sum(t.numel() for t in outs))
        elif packet in _REDUCTIONS and ins:
            flops = float(ins[0].numel())
        else:
            flops = 0.0
        if packet in _EMPTY:
            nbytes = 0
        elif packet in _WRITE_ONLY:
            nbytes = sum(_nbytes(t) for t in outs)
        elif packet in _GATHER:
            nbytes = 2 * sum(_nbytes(t) for t in outs)
        elif packet in _SCATTER:
            upd = args[_SCATTER[packet]]
            nbytes = 2 * sum(_nbytes(t) for t in _tensors(upd))
        elif packet is aten.copy_:
            nbytes = 2 * _nbytes(args[1])
        else:
            nbytes = (sum(_nbytes(t) for t in ins)
                      + sum(_nbytes(t) for t in outs))
        self.result._add_op(str(packet), flops, float(nbytes), dot)
