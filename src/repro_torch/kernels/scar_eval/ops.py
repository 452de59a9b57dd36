"""Bridge from ``repro_torch.core`` candidate batches to the kernel inputs.

``pack_candidates`` turns a ``BatchedModelCandidates`` + CostDB + MCM into
the compact float32 tensors ``scar_eval`` consumes, on the caller's device:
per-segment chiplet classes, last-layer indices and live counts (host
integers copied once), the window's cost tables, and the per-segment comm
terms.  The comm terms are computed here in torch, before the launch, as the
reference's jitted wrapper computes them outside its kernel
(``repro/kernels/scar_eval/ops.py::evaluate_traceable``): per-segment weight
bytes are prefix-sum differences at the segment boundaries and the
formulas are ``core.cost.comm_from_parts``, the function the float64 oracle
runs.  ``evaluate`` then picks the kernel or its plain version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.cost import comm_from_parts

from .kernel import blocked_cumsum, scar_eval, scar_eval_plain

__all__ = ["PackedCandidates", "evaluate", "pack_candidates"]


class PackedCandidates(NamedTuple):
    """Kernel inputs of one batch, in ``scar_eval``'s argument order."""

    lat_tab: torch.Tensor
    e_tab: torch.Tensor
    seg_cls: torch.Tensor
    last: torch.Tensor
    n_segs: torch.Tensor
    comm_lat: torch.Tensor
    comm_e: torch.Tensor
    pipelined: bool


def pack_candidates(db, mcm, cand, n_active: int,
                    prev_end: Optional[int] = None, *,
                    pipelined: bool = True,
                    device: torch.device) -> PackedCandidates:
    """Compact float32 kernel inputs of one candidate batch on ``device``.

    The segment axis is shrunk to the batch's largest segment count.  No
    batch padding: the kernel masks its ragged last block.
    """
    B, Lw = cand.seg_id.shape
    S = max(1, int(cand.n_segs.max()))
    sl = slice(cand.start, cand.end)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=device)

    lat_tab = t(db.lat[sl], np.float32)
    e_tab = t(db.energy[sl], np.float32)
    w_bytes = t(db.w_bytes[sl], np.float32)
    out_bytes = t(db.out_bytes[sl], np.float32)
    class_map = t(mcm.class_map, np.int32)
    chips = t(cand.chiplets[:, :S], np.int32)
    n_segs = t(cand.n_segs, np.int32)
    if cand.seg_ends is not None:                # free at construction time
        last_np = cand.seg_ends[:, :S] - cand.start - 1
    else:
        from repro_torch.core.cost import segment_last_layers
        last_np = segment_last_layers(cand.seg_id, S)
    last = t(last_np, np.int32)

    cpos = chips.clamp(min=0)
    seg_cls = class_map[cpos.long()]                             # [B, S]
    exists = torch.arange(S, device=device)[None, :] < n_segs[:, None]
    hi = last.long().clamp(0, Lw - 1)
    lo = torch.cat([torch.zeros_like(hi[:, :1]),
                    last[:, :-1].long().clamp(min=-1) + 1], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    # per-segment reductions at the boundaries (cf. cost.segment_reductions)
    seg_last_out = torch.where(exists, out_bytes[hi], zero)
    cw = torch.cat([w_bytes.new_zeros(1), blocked_cumsum(w_bytes)])
    seg_w = torch.where(exists, cw[hi + 1] - cw[lo], zero)
    ip_lat, ip_e, op_lat, op_e = comm_from_parts(
        mcm.pkg, mcm.cols, cpos, seg_w, seg_last_out, n_segs, n_active,
        float(np.float32(db.in_bytes[cand.start])), prev_end)
    return PackedCandidates(lat_tab, e_tab, seg_cls, last, n_segs,
                            (ip_lat + op_lat).contiguous(),
                            (ip_e + op_e).contiguous(), pipelined)


def evaluate(packed: PackedCandidates, *, use_kernel: bool) -> torch.Tensor:
    """``[B, 2]`` float32 (latency, energy) of a packed batch.

    ``use_kernel=True`` launches the CUDA kernel (and raises on a CPU
    device: there is no kernel to run there); ``False`` runs the plain
    torch version on the batch's device.
    """
    if not use_kernel:
        return scar_eval_plain(*packed)
    if packed.lat_tab.device.type != "cuda":
        raise RuntimeError("the scar_eval kernel needs a CUDA device; "
                           f"the batch is on {packed.lat_tab.device}")
    return scar_eval(*packed)
