"""Backend-selectable SCHED candidate evaluation.

One entry point — ``eval_candidates`` — scores a ``BatchedModelCandidates``
batch on one of three backends, on the caller's device:

* ``torch``     — ``cost.eval_model_candidates``, float64.  The parity
  oracle, and the choice for small batches.
* ``torch_ref`` — the plain float32 version of the kernel
  (``kernels.scar_eval.scar_eval_window_plain``) over ``pack_window``'s
  one-model batch.  Large batches take it on the CPU.
* ``cuda``      — the ``scar_eval`` CUDA kernel, float32.  Large batches
  take it on a GPU.

The float32 backends compute their comm terms as ``cost.comm_from_parts``
(and, under the congestion model, ``cost.congestion_correction``) — the
functions the float64 oracle runs — do (the plain version calls them, the
kernel repeats their float32 operations), so the comm geometry is shared
by construction.

Selection: explicit ``backend=`` (``SearchConfig.eval_backend`` everywhere
in the pipeline), else ``"auto"``, which keeps the reference's rule: below
``AUTO_WORK_THRESHOLD`` B*Lw elements the float64 oracle, above it the
kernel on a CUDA device and its plain version on the CPU.  ``cuda`` on a
CPU device raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.scar_eval import ops as scar_eval_ops
from repro_torch.launch import platform

from .chiplet import MCM
from .cost import (BatchedModelCandidates, check_comm_model,
                   eval_model_candidates, link_bandwidths, n_interposer_links)
from .maestro import CostDB

BACKENDS = ("auto", "torch", "torch_ref", "cuda")

# `evaluator.eval_calls.<backend>` counts every dispatch per resolved
# backend.
_EVAL_CALLS = {b: obs.counter(f"evaluator.eval_calls.{b}")
               for b in BACKENDS[1:]}

# auto: batches below this many B*Lw elements stay on the float64 oracle
# (the reference's threshold: 3x3 batches sit at <= 9k elements, 16x16
# path_cap=1024 batches at 50k-260k).
AUTO_WORK_THRESHOLD = 32_768


def resolve_backend(backend: Optional[str], work: int,
                    device: torch.device) -> str:
    """Concrete backend name for a request (see module docstring)."""
    b = backend or "auto"
    if b not in BACKENDS:
        raise KeyError(f"unknown eval backend {b!r}; have {BACKENDS}")
    if b == "cuda" and device.type != "cuda":
        raise RuntimeError(f"eval backend 'cuda' needs a CUDA device, got "
                           f"{device}; use 'torch_ref' on the CPU")
    if b != "auto":
        return b
    if work < AUTO_WORK_THRESHOLD:
        return "torch"
    return "cuda" if device.type == "cuda" else "torch_ref"


def eval_candidates(db: CostDB, mcm: MCM, cand: BatchedModelCandidates,
                    n_active: int, prev_end: Optional[int] = None,
                    pipelined: bool = True,
                    backend: Optional[str] = None,
                    comm_model: str = "analytic",
                    link_occ: Optional[np.ndarray] = None, *,
                    device: Optional[torch.device] = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """``(lat[B], energy[B])`` float64 host arrays via the selected backend.

    Latencies are seconds, energies joules, for the ``B`` candidate plans
    in ``cand``.  ``device`` defaults to CUDA (``launch.platform``) and the
    scores come back through one counted ``device_fetch``.  The float32
    backends are parity-tested against the float64 oracle within float32
    tolerance; callers that need deterministic cross-backend ordering
    quantise scores before sorting (``sched.build_candidates``).

    ``comm_model="congestion"`` routes transfers over interposer links and
    prices contention with the background byte occupancy ``link_occ``
    (``[n_links]``, None = uncontended); every backend applies the same
    ``cost.congestion_correction`` terms.  The float32 backends take the
    per-link waiting time ``link_occ / bandwidth``, divided in float64 on
    the host and rounded to float32, as the reference builds its wait
    tables.
    """
    dev = platform.resolve_device(device)
    check_comm_model(comm_model)
    B, Lw = cand.seg_id.shape
    resolved = resolve_backend(backend, B * Lw, dev)
    _EVAL_CALLS[resolved].inc()
    with obs.span("eval_candidates", cat="evaluator", backend=resolved,
                  batch=B, layers=Lw):
        if resolved == "torch":
            lat, energy = platform.device_fetch(*eval_model_candidates(
                db, mcm, cand, n_active, prev_end=prev_end,
                pipelined=pipelined, comm_model=comm_model,
                link_occ=link_occ, device=dev))
            return lat, energy
        cost = None
        if comm_model == "congestion":
            if link_occ is None:
                link_occ = np.zeros(n_interposer_links(mcm.rows, mcm.cols))
            cost = (np.asarray(link_occ, np.float64)
                    / link_bandwidths(mcm)).astype(np.float32)
        batch = scar_eval_ops.pack_window(
            [scar_eval_ops.model_inputs(db, cand, prev_end,
                                        pipelined=pipelined,
                                        link_cost=cost)],
            mcm.class_map, mcm.pkg, mcm.cols, n_active, device=dev,
            rows=mcm.rows, noc=mcm.noc)
        (out,) = platform.device_fetch(
            scar_eval_ops.evaluate(batch, use_kernel=(resolved == "cuda")))
    return out[:, 0].astype(np.float64), out[:, 1].astype(np.float64)

