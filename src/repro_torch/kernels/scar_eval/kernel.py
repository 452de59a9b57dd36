"""The ``scar_eval`` CUDA kernel's wrapper and its plain torch version.

Counterpart of the Pallas kernel ``repro/kernels/scar_eval/kernel.py`` and
of the jitted code around it (``repro/kernels/scar_eval/ops.py::
evaluate_traceable`` with the analytic comm model).  One call scores every
candidate of every model of a window (a ``WindowBatch``, made by
``ops.pack_window``) and returns ``[B, 2]`` float32 (window latency,
window energy), ``B`` the candidates of all models in model order.

``scar_eval`` launches the kernel (``kernels/csrc/scar_eval.cu``) for
CUDA tensors and uses ``scar_eval_window_plain`` only for tensors on the
CPU; a CUDA tensor never falls back.  ``scar_eval_window_plain`` is
``core.cost.comm_from_parts`` plus ``scar_eval_plain`` per model: the
kernel does the same float32 operations in the same order, so the two
give the same bits.

``scar_eval_plain`` is the scoring half in the compact form the Pallas
kernel's tests compare (per-segment class, last layer, live count and
comm terms):

  lat_tab, e_tab     [Lw, C]  float32  per-(layer, chiplet class) costs
  seg_cls            [B, S]   int32    chiplet class of each segment
  last               [B, S]   int32    window-relative last layer of each
                                       segment (ascending over live ones)
  n_segs             [B]      int32    live segments (0 = padding row)
  comm_lat, comm_e   [B, S]   float32  per-segment comm terms
  pipelined          bool     latency = max over live segments when more
                              than one is live, else their sum
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..build import load_library

__all__ = ["CANDS_PER_CTA", "ModelSlot", "WindowBatch", "blocked_cumsum",
           "comm_constants", "scar_eval", "scar_eval_plain",
           "scar_eval_window_plain"]

PREFIX_BLOCK = 16
CANDS_PER_CTA = 32        # candidates (threads) a CTA of the kernel
DESC_INTS = 8             # descriptor ints a model (scar_eval.cu kDesc)
_SMEM_MAX = 232_448       # dynamic shared memory a CTA can opt into


class ModelSlot(NamedTuple):
    """Host-side description of one model of a ``WindowBatch``.

    ``cand_off`` / ``n_cand``: its rows of the candidate arrays;
    ``tab_off`` / ``n_layers``: its rows of the cost tables; ``prev_end``:
    the anchor chiplet of its first segment's input (None: cold DRAM);
    ``act_in``: its input activation bytes (float32); ``cta_off``: its
    first CTA in the kernel's grid.  The device descriptor
    ``WindowBatch.desc`` holds the same integers.
    """

    cand_off: int
    n_cand: int
    tab_off: int
    n_layers: int
    prev_end: Optional[int]
    pipelined: bool
    act_in: float
    cta_off: int


class WindowBatch(NamedTuple):
    """Inputs of one ``scar_eval`` call: every model of a window.

    Device tensors: the window's CostDB rows, model after model
    (``lat_tab`` / ``e_tab`` ``[L, C]``, ``w_bytes`` / ``out_bytes``
    ``[L]``, float32), ``act_in`` ``[M]`` float32, the candidates' raw
    integers, model after model (``chips`` and ``last`` ``[B, S]``: the
    chiplet and window-relative last layer of each segment, -1 past the
    live ones; ``n_segs`` ``[B]``), ``class_map`` ``[n_chiplets]`` and the
    ``[M, 8]`` int32 descriptor ``desc``.  Host values: ``models`` (one
    ``ModelSlot`` each, the descriptor's integers), the package constants
    ``pkg``, the mesh width ``cols`` and the window's ``n_active``.
    """

    lat_tab: torch.Tensor
    e_tab: torch.Tensor
    w_bytes: torch.Tensor
    out_bytes: torch.Tensor
    act_in: torch.Tensor
    chips: torch.Tensor
    last: torch.Tensor
    n_segs: torch.Tensor
    class_map: torch.Tensor
    desc: torch.Tensor
    models: tuple[ModelSlot, ...]
    pkg: object
    cols: int
    n_active: int


def blocked_cumsum(x: torch.Tensor, block: int = PREFIX_BLOCK
                   ) -> torch.Tensor:
    """Inclusive prefix sums along dim 0 in a fixed association.

    Sequential within blocks of ``block`` rows, then each block offset by
    the prefix of the earlier blocks' totals, computed the same way.  This
    is the association of the reference's float32 evaluator (``jnp.cumsum``
    on the CPU), and the one the CUDA kernel uses, so all three give the
    same float32 bits; ``torch.cumsum`` sums in another order.
    """
    n = x.shape[0]
    if n <= block:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[0])
        for i in range(n):
            acc = acc + x[i]
            out[i] = acc
        return out
    nb = -(-n // block)
    pad = x.new_zeros((nb * block - n,) + tuple(x.shape[1:]))
    xb = torch.cat([x, pad]).reshape((nb, block) + tuple(x.shape[1:]))
    within = torch.empty_like(xb)
    acc = torch.zeros_like(xb[:, 0])
    for i in range(block):
        acc = acc + xb[:, i]
        within[:, i] = acc
    carry = blocked_cumsum(within[:, -1], block)
    out = within.clone()
    out[1:] = within[1:] + carry[:-1].unsqueeze(1)
    return out.reshape((nb * block,) + tuple(x.shape[1:]))[:n]


def scar_eval_plain(lat_tab: torch.Tensor, e_tab: torch.Tensor,
                    seg_cls: torch.Tensor, last: torch.Tensor,
                    n_segs: torch.Tensor, comm_lat: torch.Tensor,
                    comm_e: torch.Tensor, pipelined: bool) -> torch.Tensor:
    """``[B, 2]`` (latency, energy) of the compact form, in float32."""
    B, S = seg_cls.shape
    Lw, C = lat_tab.shape
    zrow = lat_tab.new_zeros((1, C))
    cum_lat = torch.cat([zrow, blocked_cumsum(lat_tab)])         # [Lw+1, C]
    cum_e = torch.cat([zrow, blocked_cumsum(e_tab)])
    cls = seg_cls.long().clamp(0, C - 1)
    hi = last.long().clamp(0, Lw - 1) + 1
    lo = torch.cat([torch.zeros_like(hi[:, :1]),
                    (last[:, :-1].long().clamp(min=-1) + 1).clamp(max=Lw)],
                   dim=1)
    seg_lat = (cum_lat[hi, cls] - cum_lat[lo, cls]) + comm_lat
    seg_e = (cum_e[hi, cls] - cum_e[lo, cls]) + comm_e
    live = torch.arange(S, device=seg_cls.device)[None, :] < n_segs[:, None]
    zero = lat_tab.new_zeros(())
    lat_sum = lat_tab.new_zeros(B)
    e_sum = lat_tab.new_zeros(B)
    lat_max = torch.full((B,), float("-inf"), dtype=lat_tab.dtype,
                         device=lat_tab.device)
    for s in range(S):                 # segment order, as the kernel sums
        lat_sum = lat_sum + torch.where(live[:, s], seg_lat[:, s], zero)
        e_sum = e_sum + torch.where(live[:, s], seg_e[:, s], zero)
        lat_max = torch.maximum(lat_max, torch.where(
            live[:, s], seg_lat[:, s], lat_max))
    lat = torch.where(n_segs > 1, lat_max, lat_sum) if pipelined else lat_sum
    return torch.stack([lat, e_sum], dim=1)


def scar_eval_window_plain(w: WindowBatch) -> torch.Tensor:
    """Plain torch version of the kernel: ``[B, 2]`` float32.

    Per model: the segment weight sums (differences of the blocked prefix
    of ``w_bytes``) and last-layer output bytes, ``comm_from_parts`` for
    the comm terms, then ``scar_eval_plain``.
    """
    # imported here: repro_torch.core imports this package
    from repro_torch.core.cost import comm_from_parts

    outs = []
    for slot in w.models:
        rows = slice(slot.cand_off, slot.cand_off + slot.n_cand)
        tabs = slice(slot.tab_off, slot.tab_off + slot.n_layers)
        chips, last, n_segs = w.chips[rows], w.last[rows], w.n_segs[rows]
        w_bytes, out_bytes = w.w_bytes[tabs], w.out_bytes[tabs]
        Lw, S = slot.n_layers, chips.shape[1]
        cpos = chips.clamp(min=0)
        exists = torch.arange(S, device=chips.device)[None, :] \
            < n_segs[:, None]
        hi = last.long().clamp(0, Lw - 1)
        lo = torch.cat([torch.zeros_like(hi[:, :1]),
                        last[:, :-1].long().clamp(min=-1) + 1], dim=1)
        zero = w_bytes.new_zeros(())
        seg_last_out = torch.where(exists, out_bytes[hi], zero)
        cw = torch.cat([w_bytes.new_zeros(1), blocked_cumsum(w_bytes)])
        seg_w = torch.where(exists, cw[hi + 1] - cw[lo], zero)
        ip_lat, ip_e, op_lat, op_e = comm_from_parts(
            w.pkg, w.cols, cpos, seg_w, seg_last_out, n_segs, w.n_active,
            slot.act_in, slot.prev_end)
        outs.append(scar_eval_plain(
            w.lat_tab[tabs], w.e_tab[tabs], w.class_map[cpos.long()], last,
            n_segs, ip_lat + op_lat, ip_e + op_e, slot.pipelined))
    return torch.cat(outs)


def comm_constants(pkg, n_active: int) -> np.ndarray:
    """The kernel's 10 float32 package constants (``Consts`` order).

    Each is the float32 that torch computes with when ``comm_from_parts``
    meets the Python float against a float32 tensor: the double rounded
    to nearest; the bandwidths as float32 reciprocals
    (``cost._per_bandwidth``).
    """
    f = np.float32
    crowd = max(0, n_active - 1)
    return np.array([f(1) / f(pkg.dram_bw), f(1) / f(pkg.nop_bw),
                     pkg.nop_hop_lat_s, pkg.dram_lat_s,
                     pkg.contention_delta * crowd / pkg.dram_bw,
                     pkg.contention_delta * crowd / pkg.nop_bw,
                     pkg.dram_e_pj_per_bit, pkg.nop_e_pj_per_bit, 8.0,
                     1e-12], dtype=np.float32)


def _check(w: WindowBatch) -> None:
    n_models = len(w.models)
    B = sum(s.n_cand for s in w.models)
    L = sum(s.n_layers for s in w.models)
    C = w.lat_tab.shape[1] if w.lat_tab.dim() == 2 else -1
    S = w.chips.shape[1] if w.chips.dim() == 2 else -1
    want = {"lat_tab": (torch.float32, (L, C)),
            "e_tab": (torch.float32, (L, C)),
            "w_bytes": (torch.float32, (L,)),
            "out_bytes": (torch.float32, (L,)),
            "act_in": (torch.float32, (n_models,)),
            "chips": (torch.int32, (B, S)), "last": (torch.int32, (B, S)),
            "n_segs": (torch.int32, (B,)),
            "class_map": (torch.int32, (w.class_map.shape[0],)),
            "desc": (torch.int32, (n_models, DESC_INTS))}
    dev = w.chips.device
    for name, (dtype, shape) in want.items():
        t = getattr(w, name)
        if t.device != dev:
            raise ValueError(f"scar_eval: {name} on {t.device}, chips on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"scar_eval: {name} is {t.dtype}, want {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"scar_eval: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"scar_eval: {name} is not contiguous")
    cand = tab = cta = 0
    for s in w.models:
        if (s.cand_off, s.tab_off, s.cta_off) != (cand, tab, cta) \
                or s.n_cand < 1 or s.n_layers < 1:
            raise ValueError(f"scar_eval: bad model slot {s}")
        cand += s.n_cand
        tab += s.n_layers
        cta += -(-s.n_cand // CANDS_PER_CTA)
    if n_models < 1 or not 1 <= C <= 64 or S < 1:
        raise ValueError(f"scar_eval: unsupported M={n_models}, C={C}, "
                         f"S={S}")


def scar_eval(w: WindowBatch) -> torch.Tensor:
    """``[B, 2]`` (latency, energy): the CUDA kernel on CUDA tensors.

    Tensors on the CPU take ``scar_eval_window_plain``.
    ``scar_eval.launches`` counts kernel launches (one per call).
    """
    _check(w)
    dev = w.chips.device
    if dev.type == "cpu":
        return scar_eval_window_plain(w)
    if dev.type != "cuda":
        raise ValueError(f"scar_eval: no kernel for {dev}")
    C = w.lat_tab.shape[1]
    B, S = w.chips.shape
    lw_max = max(s.n_layers for s in w.models)
    lib = _lib()
    smem = lib.scar_eval_smem_bytes(lw_max, C)
    if smem > _SMEM_MAX:
        raise ValueError(f"scar_eval: Lw={lw_max}, C={C} needs {smem} B of "
                         f"shared memory (limit {_SMEM_MAX})")
    n_ctas = sum(-(-s.n_cand // CANDS_PER_CTA) for s in w.models)
    consts = comm_constants(w.pkg, w.n_active)
    out = torch.empty((B, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scar_eval_launch(
            w.lat_tab.data_ptr(), w.e_tab.data_ptr(), w.w_bytes.data_ptr(),
            w.out_bytes.data_ptr(), w.act_in.data_ptr(), w.chips.data_ptr(),
            w.last.data_ptr(), w.n_segs.data_ptr(), w.class_map.data_ptr(),
            w.desc.data_ptr(), len(w.models), n_ctas, CANDS_PER_CTA, lw_max,
            consts.ctypes.data, w.cols, C, S, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scar_eval launch failed: CUDA error {err}")
    scar_eval.launches += 1
    return out


scar_eval.launches = 0


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with typed entry points."""
    global _LIB
    if _LIB is None:
        lib = load_library("scar_eval")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.scar_eval_launch.argtypes = [p] * 10 + [i, i, i, i, p, i, i, i,
                                                    p, p]
        lib.scar_eval_launch.restype = i
        lib.scar_eval_smem_bytes.argtypes = [i, i]
        lib.scar_eval_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB
