"""Bridge from ``repro_torch.core`` candidate batches to the kernel inputs.

``model_inputs`` takes what the host holds for one model's candidate batch
(``BatchedModelCandidates``: chiplet and end layer of each segment, live
segment counts) and the window's CostDB rows, as numpy.
``window_arrays`` concatenates any number of models into the host arrays
of a ``WindowBatch``; ``pack_window`` copies them to the device in one copy
per dtype (``launch.platform.device_upload``) and wraps them for
``scar_eval``, whose one launch then computes everything the reference's
jitted wrapper (``repro/kernels/scar_eval/ops.py::evaluate_traceable``)
computes around its kernel.  ``evaluate`` picks the kernel or its plain
version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import platform

from .kernel import (CANDS_PER_CTA, DESC_INTS, ModelSlot, WindowBatch,
                     _check, scar_eval, scar_eval_window_plain)

__all__ = ["ModelInputs", "evaluate", "model_inputs", "pack_window",
           "window_arrays"]


class ModelInputs(NamedTuple):
    """One model's host arrays: its window's CostDB rows (``lat_tab`` /
    ``e_tab`` ``[Lw, C]``, ``w_bytes`` / ``out_bytes`` ``[Lw]``), its input
    activation bytes, and per candidate the chiplet and window-relative
    last layer of each segment (``[B, S]``) and the live segment count."""

    lat_tab: np.ndarray
    e_tab: np.ndarray
    w_bytes: np.ndarray
    out_bytes: np.ndarray
    act_in: float
    chips: np.ndarray
    last: np.ndarray
    n_segs: np.ndarray
    prev_end: Optional[int] = None
    pipelined: bool = True


def model_inputs(db, cand, prev_end: Optional[int] = None, *,
                 pipelined: bool = True) -> ModelInputs:
    """``ModelInputs`` of a ``BatchedModelCandidates`` over ``db``."""
    S = max(1, int(cand.n_segs.max()))
    sl = slice(cand.start, cand.end)
    if cand.seg_ends is not None:                # free at construction time
        last = cand.seg_ends[:, :S] - cand.start - 1
    else:
        from repro_torch.core.cost import segment_last_layers
        last = segment_last_layers(cand.seg_id, S)
    return ModelInputs(db.lat[sl], db.energy[sl], db.w_bytes[sl],
                       db.out_bytes[sl],
                       float(np.float32(db.in_bytes[cand.start])),
                       cand.chiplets[:, :S], last, cand.n_segs, prev_end,
                       pipelined)


def _widen(a: np.ndarray, S: int) -> np.ndarray:
    """``[B, s]`` ints as ``[B, S]`` int32, padded with -1."""
    out = np.full((a.shape[0], S), -1, np.int32)
    out[:, :min(S, a.shape[1])] = a[:, :S]
    return out


def window_arrays(models: Sequence[ModelInputs], class_map
                  ) -> tuple[dict[str, np.ndarray], tuple[ModelSlot, ...]]:
    """The host arrays of one ``WindowBatch`` of ``models``, keyed and
    ordered by its tensor fields, and the models' slots.

    The segment axis is the widest model's live segment count.
    """
    S = max(max(1, int(np.max(m.n_segs))) for m in models)
    slots, desc = [], np.zeros((len(models), DESC_INTS), np.int32)
    cand = tab = cta = 0
    for i, m in enumerate(models):
        B, Lw = m.n_segs.shape[0], m.lat_tab.shape[0]
        slots.append(ModelSlot(cand, B, tab, Lw, m.prev_end,
                               bool(m.pipelined), float(m.act_in), cta))
        desc[i, :7] = (cand, B, tab, Lw,
                       -1 if m.prev_end is None else m.prev_end,
                       int(bool(m.pipelined)), cta)
        cand += B
        tab += Lw
        cta += -(-B // CANDS_PER_CTA)

    def cat(key, dtype):
        return np.concatenate([np.asarray(getattr(m, key), dtype)
                               for m in models])

    arrays = {
        "lat_tab": cat("lat_tab", np.float32),
        "e_tab": cat("e_tab", np.float32),
        "w_bytes": cat("w_bytes", np.float32),
        "out_bytes": cat("out_bytes", np.float32),
        "act_in": np.array([m.act_in for m in models], np.float32),
        "chips": np.concatenate([_widen(m.chips, S) for m in models]),
        "last": np.concatenate([_widen(m.last, S) for m in models]),
        "n_segs": cat("n_segs", np.int32),
        "class_map": np.asarray(class_map, np.int32),
        "desc": desc,
    }
    return arrays, tuple(slots)


def pack_window(models: Sequence[ModelInputs], class_map, pkg, cols: int,
                n_active: int, *, device: torch.device) -> WindowBatch:
    """One ``WindowBatch`` of ``models`` on ``device``, uploaded in one
    copy per dtype."""
    arrays, slots = window_arrays(models, class_map)
    dev = platform.device_upload(arrays, device)
    return WindowBatch(*(dev[k] for k in arrays), models=slots, pkg=pkg,
                       cols=int(cols), n_active=int(n_active))


def evaluate(batch: WindowBatch, *, use_kernel: bool) -> torch.Tensor:
    """``[B, 2]`` float32 (latency, energy) of a window batch.

    ``use_kernel=True`` launches the CUDA kernel (and raises on a CPU
    device: there is no kernel to run there); ``False`` runs the plain
    torch version on the batch's device.  Both check the batch as the
    kernel's wrapper does.
    """
    if not use_kernel:
        _check(batch)
        return scar_eval_window_plain(batch)
    if batch.chips.device.type != "cuda":
        raise RuntimeError("the scar_eval kernel needs a CUDA device; "
                           f"the batch is on {batch.chips.device}")
    return scar_eval(batch)
