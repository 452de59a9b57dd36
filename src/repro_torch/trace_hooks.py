"""The hooks through which a cost trace (``analysis.trace_cost.CostTrace``)
sees the program it traces.

The analysis layer opens and closes the trace (``TRACE``); the kernels,
the models and the collectives only call the hooks below, which do
nothing while no trace is open:

* ``plain_device``: the LM kernels' wrappers take their plain versions on
  the CPU, and on ``meta`` inside a trace (shapes, no values).  Outside a
  trace a ``meta`` tensor stands for a device without a kernel, and the
  wrappers raise for it as for any other; a CUDA tensor never falls back.
* ``recurrence``: loops whose every step does the same work (the plain
  recurrences over positions or chunks, the training step's microbatches)
  run through it, so that a trace can count a long one from two short
  ones.
* ``collective``: every counted collective (``distributed.collectives``)
  reports its operation, bytes and group size.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

# The open cost trace, or None.
TRACE: Any = None
# the fewest steps a trace counts from two shorter runs (below: runs them)
SHORTCUT_MIN = 6


def plain_device(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper takes the plain version for ``t``: on the
    CPU, and on ``meta`` inside a cost trace."""
    return t.device.type == "cpu" or (t.device.type == "meta"
                                      and TRACE is not None)


def recurrence(run: Callable[[int], Any], trips: int,
               device: torch.device) -> Any:
    """``run(trips)``: a loop over its first ``trips`` steps (positions,
    chunks, microbatches), each step the same work on ``device``.  ``run``
    writes what grows with the steps into tensors allocated before it and
    returns only what does not (a carry).  On ``meta``, inside a cost
    trace with its loop shortcut, a loop of at least ``SHORTCUT_MIN``
    steps is counted from ``run(2)`` and ``run(3)`` instead
    (``analysis.trace_cost.CostTrace.loop``)."""
    if (TRACE is None or not TRACE.loop_shortcut or trips < SHORTCUT_MIN
            or device.type != "meta"):
        return run(trips)
    return TRACE.loop(run, trips)


def collective(op: str, nbytes: int, group: int) -> None:
    """A collective ``op`` (``all_reduce``, ``all_gather``, ``broadcast``,
    ``send_recv``) of ``nbytes`` bytes a rank over ``group`` ranks."""
    if TRACE is not None:
        TRACE.collective(op, nbytes, group)
