"""Schedule evaluation: latency/energy/EDP of SCAR schedules (Sec. III-E/F).

Terms follow the paper exactly:

* ``Lat^com``: 0 on the same chiplet; ``Sz/BW_nop + hops * Lat_hop + delta``
  across the package; ``Sz/BW_dram + hops * Lat_hop + Lat_mem + delta``
  off-chip.
* ``Lat(sg) = sum Lat^comp(l) + Lat^ip_com(sg) + Lat^op_com(sg)`` where
  ``ip_com`` loads segment weights (and, for the first segment of a model in a
  window without cross-window locality, its input activations) from DRAM, and
  ``op_com`` forwards the segment output to the next segment's chiplet (NoP) or
  writes back to DRAM at the window boundary.  Producer pays the activation
  transfer, so nothing is double counted.
* ``Lat(tw)``: per model, ``max`` over segments when pipelined (inter-chiplet
  pipelining), ``sum`` when end-to-end; the window is the ``max`` over models.
* Energies are always aggregated (Sec. III-F).

``delta`` (NoP traffic conflicts) is modelled as a serialization penalty
proportional to the number of concurrently active models sharing the package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .chiplet import MCM
from .maestro import CostDB


@dataclasses.dataclass(frozen=True)
class ModelWindowPlan:
    """One model's execution plan inside a time window.

    ``start``/``end``: flat CostDB layer range assigned to this window.
    ``seg_ends``: segment boundaries as flat end-indices, strictly increasing,
    last == ``end`` (segments are contiguous layer runs, Theorem 1).
    ``chiplets``: one chiplet id per segment.
    ``pipelined``: inter-chiplet pipelining (max) vs end-to-end (sum).
    """

    model_idx: int
    start: int
    end: int
    seg_ends: tuple[int, ...]
    chiplets: tuple[int, ...]
    pipelined: bool = True

    @property
    def n_segments(self) -> int:
        return len(self.seg_ends)

    def validate(self) -> None:
        if self.end <= self.start:
            raise ValueError("empty window plan")
        if len(self.chiplets) != len(self.seg_ends):
            raise ValueError("one chiplet per segment required")
        prev = self.start
        for e in self.seg_ends:
            if e <= prev:
                raise ValueError("segment boundaries must increase")
            prev = e
        if prev != self.end:
            raise ValueError("segments must cover the window slice")


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    plans: tuple[ModelWindowPlan, ...]

    def validate(self) -> None:
        used: set[int] = set()
        for p in self.plans:
            p.validate()
            for c in p.chiplets:
                if c in used:
                    raise ValueError(f"chiplet {c} used by two models in one window")
                used.add(c)


@dataclasses.dataclass(frozen=True)
class WindowResult:
    latency: float
    energy: float
    per_model_latency: dict[int, float]
    end_chiplet: dict[int, int]          # data-locality anchor for next window
    # Resumable execution chunks per model: (latency, end chiplet) per unit
    # the runtime can pause at — one per segment for sequential plans, one
    # per window for pipelined plans (whose segments overlap in time and
    # cannot be cut individually).  Chunk latencies sum to exactly
    # per_model_latency[mi] (same float summation order), which is what lets
    # the online simulator preempt an in-flight iteration at a chunk
    # boundary and conserve the remaining work (repro.online.simulator).
    per_model_segments: dict[int, tuple[tuple[float, int], ...]] = \
        dataclasses.field(default_factory=dict)

    @property
    def edp(self) -> float:
        return self.latency * self.energy


@dataclasses.dataclass(frozen=True)
class ScheduleResult:
    latency: float
    energy: float
    windows: tuple[WindowResult, ...]

    @property
    def edp(self) -> float:
        return self.latency * self.energy

    def metric(self, name: str) -> float:
        if name == "latency":
            return self.latency
        if name == "energy":
            return self.energy
        if name == "edp":
            return self.edp
        raise KeyError(name)


def _nop_lat(sz: float, hops: int, mcm: MCM, n_active: int) -> float:
    if hops == 0 or sz == 0:
        return 0.0
    pkg = mcm.pkg
    delta = pkg.contention_delta * max(0, n_active - 1) * (sz / pkg.nop_bw)
    return sz / pkg.nop_bw + hops * pkg.nop_hop_lat_s + delta


def _dram_lat(sz: float, hops_to_port: int, mcm: MCM, n_active: int) -> float:
    if sz == 0:
        return 0.0
    pkg = mcm.pkg
    delta = pkg.contention_delta * max(0, n_active - 1) * (sz / pkg.dram_bw)
    return (sz / pkg.dram_bw + hops_to_port * pkg.nop_hop_lat_s
            + pkg.dram_lat_s + delta)


def _nop_energy(sz: float, hops: int, mcm: MCM) -> float:
    return sz * 8.0 * mcm.pkg.nop_e_pj_per_bit * hops * 1e-12


def _dram_energy(sz: float, hops_to_port: int, mcm: MCM) -> float:
    bits = sz * 8.0
    return (bits * mcm.pkg.dram_e_pj_per_bit
            + bits * mcm.pkg.nop_e_pj_per_bit * hops_to_port) * 1e-12


def check_comm_model(comm_model: str) -> None:
    """Raise unless ``comm_model`` is one this port implements.

    Only the analytic model (paper Sec. III-E hop geometry) is ported; the
    reference's routed ``"congestion"`` model is ROADMAP queue 1 item 4b.
    """
    if comm_model == "congestion":
        raise NotImplementedError(
            "comm_model='congestion' is not ported yet (ROADMAP.md queue 1, "
            "item 4b: the congestion comm model)")
    if comm_model != "analytic":
        raise ValueError(f"unknown comm_model {comm_model!r}")


def evaluate_window(db: CostDB, mcm: MCM, wp: WindowPlan,
                    prev_end: Optional[dict[int, int]] = None,
                    validate: bool = False,
                    comm_model: str = "analytic") -> WindowResult:
    """Evaluate one time window of co-scheduled model plans.

    Window latency (seconds) is the max over the per-model latencies,
    energy (joules) the sum over every compute and transfer term, under the
    analytic comm model (``check_comm_model``).  This scalar float64 host
    path is the parity oracle for the batched forms
    (``eval_model_candidates`` and the ``kernels.scar_eval`` bridge) and
    gives every reported schedule metric.
    """
    if validate:
        wp.validate()
    check_comm_model(comm_model)
    prev_end = prev_end or {}
    n_active = len(wp.plans)
    per_model_lat: dict[int, float] = {}
    per_model_segs: dict[int, tuple[tuple[float, int], ...]] = {}
    end_chiplet: dict[int, int] = {}
    total_energy = 0.0
    for p in wp.plans:
        seg_lats = []
        seg_start = p.start
        for si, seg_end in enumerate(p.seg_ends):
            cid = p.chiplets[si]
            cls_idx = mcm.class_idx(cid)
            sl = slice(seg_start, seg_end)
            comp_lat = float(db.lat[sl, cls_idx].sum())
            comp_e = float(db.energy[sl, cls_idx].sum())
            # ip_com: weights always stream from DRAM; first segment also
            # loads its input activations unless the previous window of this
            # model ended on this very chiplet (cross-window locality).
            w_sz = float(db.w_bytes[sl].sum())
            hops_dram = mcm.hops_to_dram(cid)
            ip_lat = _dram_lat(w_sz, hops_dram, mcm, n_active)
            ip_e = _dram_energy(w_sz, hops_dram, mcm)
            if si == 0:
                act_in = float(db.in_bytes[seg_start])
                if prev_end.get(p.model_idx) == cid:
                    pass  # activations already resident on-chiplet
                elif p.model_idx in prev_end:
                    hops = mcm.hops(prev_end[p.model_idx], cid)
                    ip_lat += _nop_lat(act_in, hops, mcm, n_active)
                    ip_e += _nop_energy(act_in, hops, mcm)
                else:
                    ip_lat += _dram_lat(act_in, hops_dram, mcm, n_active)
                    ip_e += _dram_energy(act_in, hops_dram, mcm)
            # op_com: forward activations to next segment (NoP), or write the
            # model's window output back to DRAM at the window boundary.
            act_out = float(db.out_bytes[seg_end - 1])
            if si + 1 < p.n_segments:
                hops = mcm.hops(cid, p.chiplets[si + 1])
                op_lat = _nop_lat(act_out, hops, mcm, n_active)
                op_e = _nop_energy(act_out, hops, mcm)
            else:
                op_lat = _dram_lat(act_out, hops_dram, mcm, n_active)
                op_e = _dram_energy(act_out, hops_dram, mcm)
                end_chiplet[p.model_idx] = cid
            seg_lats.append(comp_lat + ip_lat + op_lat)
            total_energy += comp_e + ip_e + op_e
            seg_start = seg_end
        if p.pipelined and p.n_segments > 1:
            per_model_lat[p.model_idx] = max(seg_lats)
            per_model_segs[p.model_idx] = (
                (max(seg_lats), p.chiplets[-1]),)
        else:
            per_model_lat[p.model_idx] = sum(seg_lats)
            per_model_segs[p.model_idx] = tuple(
                (sl, p.chiplets[si]) for si, sl in enumerate(seg_lats))
    latency = max(per_model_lat.values()) if per_model_lat else 0.0
    return WindowResult(latency=latency, energy=total_energy,
                        per_model_latency=per_model_lat,
                        end_chiplet=end_chiplet,
                        per_model_segments=per_model_segs)


def evaluate_schedule(db: CostDB, mcm: MCM,
                      windows: Sequence[WindowPlan],
                      validate: bool = False,
                      prev_end: Optional[dict[int, int]] = None,
                      comm_model: str = "analytic") -> ScheduleResult:
    """Lat(Sc) = sum over windows; E(Sc) = sum (Sec. III-E/F).

    ``prev_end`` seeds the cross-window data-locality anchors before the
    first window — the online re-scheduler uses it to account activations a
    persisting tenant left on-package at the previous epoch boundary.
    ``comm_model`` selects the per-window communication model (see
    ``evaluate_window``).
    """
    results = []
    prev_end = dict(prev_end) if prev_end else {}
    for wp in windows:
        res = evaluate_window(db, mcm, wp, prev_end, validate=validate,
                              comm_model=comm_model)
        results.append(res)
        prev_end = dict(prev_end)
        prev_end.update(res.end_chiplet)
    lat = float(sum(r.latency for r in results))
    energy = float(sum(r.energy for r in results))
    return ScheduleResult(latency=lat, energy=energy, windows=tuple(results))


# ---------------------------------------------------------------------------
# Batched per-model evaluation (the SCHED hot loop; mirrored by the CUDA
# kernel in repro_torch.kernels.scar_eval)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedModelCandidates:
    """B candidate (segmentation x placement) plans of one model's window.

    ``seg_id``: [B, Lw] int segment index per layer (monotone, starts at 0,
    contiguous ids ``0..n_segs-1``).
    ``chiplets``: [B, S_max] chiplet id per segment (-1 padding).
    ``n_segs``: [B] number of segments per candidate.
    ``seg_ends``: optional [B, S_max] *absolute* segment end indices (-1
    padding) — redundant with ``seg_id`` but free at construction time; when
    present the kernel bridge skips recomputing segment boundaries.
    """

    model_idx: int
    start: int
    end: int
    seg_id: np.ndarray
    chiplets: np.ndarray
    n_segs: np.ndarray
    seg_ends: Optional[np.ndarray] = None


def segment_last_layers(seg_id: np.ndarray, s_max: int) -> np.ndarray:
    """[B, S] window-relative index of each segment's *last* layer.

    One flat ``bincount`` plus a count prefix-sum over the monotone
    ``seg_id`` rows (the ``BatchedModelCandidates`` invariant: monotone
    non-decreasing, contiguous ids ``0..n_segs-1``).  Rows ``s >= n_segs``
    carry the running prefix value and must be masked by the caller.
    Shared by ``segment_reductions`` and the kernel bridge
    so the boundary derivation exists once.
    """
    B, Lw = seg_id.shape
    flat = (seg_id
            + s_max * np.arange(B, dtype=seg_id.dtype)[:, None]).ravel()
    counts = np.bincount(flat, minlength=B * s_max).reshape(B, s_max)
    return np.cumsum(counts, axis=1) - 1


def segment_reductions(seg_id: np.ndarray, n_segs: np.ndarray,
                       w_bytes: np.ndarray, out_bytes: np.ndarray,
                       s_max: Optional[int] = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Batched per-segment reductions over monotone ``seg_id`` rows.

    Returns ``(seg_w, seg_last_out)``, each ``[B, S]`` float64: the summed
    weight bytes of every segment and the output bytes of its *last* layer.
    One flat weighted ``bincount`` pass plus ``segment_last_layers``
    replaces the per-segment Python loop — no ``[B, Lw, S]`` one-hot is
    materialised.
    """
    B, Lw = seg_id.shape
    S = int(s_max) if s_max is not None else int(n_segs.max())
    flat = (seg_id + S * np.arange(B, dtype=seg_id.dtype)[:, None]).ravel()
    seg_w = np.bincount(
        flat, weights=np.broadcast_to(w_bytes, (B, Lw)).ravel(),
        minlength=B * S).reshape(B, S)
    exists = np.arange(S)[None, :] < n_segs[:, None]
    last = segment_last_layers(seg_id, S)                        # [B, S]
    seg_last_out = np.where(exists, out_bytes[np.clip(last, 0, Lw - 1)], 0.0)
    return seg_w, seg_last_out


def _per_bandwidth(pkg, fdt: torch.dtype, device: torch.device):
    """``(sz -> sz / dram_bw, sz -> sz / nop_bw)`` in the reference's
    rounding for ``fdt``.

    Float64 divides, as the numpy oracle does.  Float32 multiplies by the
    float32 reciprocal (``float32(1) / float32(bw)``), as the reference's
    compiled float32 program does: XLA rewrites division by a constant
    that way.  Both operands are device tensors: CUDA divides by a Python
    scalar through its reciprocal, which is not the IEEE quotient the CPU
    computes.
    """
    def const(v):
        return torch.tensor(v, dtype=fdt, device=device)

    if fdt == torch.float32:
        inv_dram = const(np.float32(1) / np.float32(pkg.dram_bw))
        inv_nop = const(np.float32(1) / np.float32(pkg.nop_bw))
        return (lambda sz: sz * inv_dram), (lambda sz: sz * inv_nop)
    dram_bw, nop_bw = const(pkg.dram_bw), const(pkg.nop_bw)
    return (lambda sz: sz / dram_bw), (lambda sz: sz / nop_bw)


def comm_from_parts(pkg, cols: int, cpos: torch.Tensor, seg_w: torch.Tensor,
                    seg_last_out: torch.Tensor, n_segs: torch.Tensor,
                    n_active: int, act_in: float,
                    prev_end: Optional[int]):
    """Sec. III-E comm formulas over precomputed per-segment reductions.

    The torch form of the reference's xp-generic ``comm_from_parts``: the
    same code computes the float64 oracle terms (``comm_terms``) and the
    float32 terms the ``kernels.scar_eval`` bridge feeds the kernel, on
    whatever device the inputs live on.  ``pkg`` constants stay Python
    floats, so float32 inputs stay float32, and the operations run in the
    reference's order.

    ``cpos`` is ``[B, S]`` non-negative chiplet ids, ``seg_w`` /
    ``seg_last_out`` the ``[B, S]`` segment weight sums and last-layer output
    bytes (zero on segments ``>= n_segs``), ``n_segs`` ``[B]``.
    ``prev_end`` is None (cold DRAM input) or the anchor chiplet id.
    Returns ``(ip_lat, ip_e, op_lat, op_e)``, each ``[B, S]`` in the dtype
    of ``seg_w``.
    """
    S = cpos.shape[1]
    fdt = seg_w.dtype
    # hop counts enter the formulas as floats of the working dtype, as the
    # reference's int * float promotion does (torch would promote to the
    # default float32 instead)
    rows_, cols_ = cpos // cols, cpos % cols
    hops_dram = torch.minimum(cols_, cols - 1 - cols_).to(fdt)   # [B, S]
    nxt = torch.roll(cpos, -1, dims=1)
    r2, c2 = nxt // cols, nxt % cols
    hops_next = ((rows_ - r2).abs() + (cols_ - c2).abs()).to(fdt)

    delta_nop = pkg.contention_delta * max(0, n_active - 1) / pkg.nop_bw
    delta_dram = pkg.contention_delta * max(0, n_active - 1) / pkg.dram_bw
    zero = torch.zeros((), dtype=fdt, device=seg_w.device)
    per_dram, per_nop = _per_bandwidth(pkg, fdt, seg_w.device)

    def dram_lat(sz, hops):
        return torch.where(sz > 0,
                           per_dram(sz) + hops * pkg.nop_hop_lat_s
                           + pkg.dram_lat_s + delta_dram * sz, zero)

    def nop_lat(sz, hops):
        return torch.where((sz > 0) & (hops > 0),
                           per_nop(sz) + hops * pkg.nop_hop_lat_s
                           + delta_nop * sz, zero)

    def dram_e(sz, hops):
        return (sz * 8.0 * (pkg.dram_e_pj_per_bit
                            + pkg.nop_e_pj_per_bit * hops)) * 1e-12

    def nop_e(sz, hops):
        return sz * 8.0 * pkg.nop_e_pj_per_bit * hops * 1e-12

    # ip_com: weights from DRAM for every segment
    ip_lat = dram_lat(seg_w, hops_dram)
    ip_e = dram_e(seg_w, hops_dram)
    # first segment input activations: DRAM cold, or NoP from the anchor
    fr, fc = cpos[:, 0] // cols, cpos[:, 0] % cols
    act = torch.full(fc.shape, act_in, dtype=fdt, device=seg_w.device)
    if prev_end is None:
        f_hops_dram = torch.minimum(fc, cols - 1 - fc).to(fdt)
        add_lat = dram_lat(act, f_hops_dram)
        add_e = dram_e(act, f_hops_dram)
    else:
        pr, pc = prev_end // cols, prev_end % cols
        hops0 = ((fr - pr).abs() + (fc - pc).abs()).to(fdt)
        add_lat = nop_lat(act, hops0)
        add_e = nop_e(act, hops0)
    first = (torch.arange(S, device=cpos.device) == 0)[None, :]
    ip_lat = ip_lat + torch.where(first, add_lat[:, None], zero)
    ip_e = ip_e + torch.where(first, add_e[:, None], zero)

    # op_com: boundary activations; DRAM writeback on the last segment
    is_last = (torch.arange(S, device=cpos.device)[None, :]
               == (n_segs - 1)[:, None])
    op_lat = torch.where(is_last,
                         dram_lat(seg_last_out, hops_dram),
                         nop_lat(seg_last_out, hops_next))
    op_e = torch.where(is_last,
                       dram_e(seg_last_out, hops_dram),
                       nop_e(seg_last_out, hops_next))
    return ip_lat, ip_e, op_lat, op_e


def comm_terms(db: CostDB, mcm: MCM, cand: BatchedModelCandidates,
               n_active: int, prev_end: Optional[int] = None,
               s_max: Optional[int] = None, *,
               device: torch.device) -> tuple[torch.Tensor, ...]:
    """Float64 per-segment communication terms for one candidate batch.

    Returns ``(ip_lat, ip_e, op_lat, op_e)``, each ``[B, S]`` float64 on
    ``device``:

    * ``ip``: segment weights stream from DRAM; the first segment also loads
      its input activations — from DRAM when ``prev_end`` is None, else over
      the NoP from the anchor chiplet (0 when already resident there);
    * ``op``: boundary activations forward to the next segment's chiplet
      (NoP) or, for the last segment, write back to DRAM.

    The per-segment reductions stay host numpy (``segment_reductions``,
    exactly the reference's); ``s_max`` shrinks the segment axis.
    """
    S = int(s_max) if s_max is not None else cand.chiplets.shape[1]
    sl = slice(cand.start, cand.end)
    seg_w, seg_last_out = segment_reductions(
        cand.seg_id, cand.n_segs, db.w_bytes[sl], db.out_bytes[sl], s_max=S)
    cpos = np.maximum(cand.chiplets[:, :S], 0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    prev = int(prev_end) if prev_end is not None else None
    return comm_from_parts(mcm.pkg, mcm.cols, t(cpos), t(seg_w),
                           t(seg_last_out), t(cand.n_segs), n_active,
                           float(db.in_bytes[cand.start]), prev)


def eval_model_candidates(db: CostDB, mcm: MCM, cand: BatchedModelCandidates,
                          n_active: int,
                          prev_end: Optional[int] = None,
                          pipelined: bool = True,
                          comm_model: str = "analytic", *,
                          device: torch.device
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float64 ``(lat[B], energy[B])`` tensors on ``device`` for one batch.

    Latencies are seconds, energies joules.  The torch form of the
    reference's numpy oracle, with its operations in the same order, so
    the two agree bit for bit (tested).  It is the ``torch`` backend of
    ``core.evaluator``, which the ``auto`` policy picks for small batches.
    """
    check_comm_model(comm_model)
    B, Lw = cand.seg_id.shape
    S = cand.chiplets.shape[1]
    sl = slice(cand.start, cand.end)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    class_map = t(np.asarray(mcm.class_map, dtype=np.int64))
    cpos = t(np.maximum(cand.chiplets, 0)).long()
    seg_id = t(cand.seg_id).long()
    n_segs = t(cand.n_segs).long()
    seg_cls = class_map[cpos]                                    # [B, S]
    ar_s = torch.arange(S, device=device)
    valid_seg = ar_s[None, :] < n_segs[:, None]                  # [B, S]

    lat_tab = t(db.lat[sl])                                      # [Lw, C]
    e_tab = t(db.energy[sl])
    layer_cls = torch.gather(seg_cls, 1, seg_id)                 # [B, Lw]
    lidx = torch.arange(Lw, device=device)[None, :]
    lat_l = lat_tab[lidx, layer_cls]                             # [B, Lw]
    e_l = e_tab[lidx, layer_cls]

    # segment-sum compute terms, summed over layers in order: the order of
    # the reference's einsum, so the sums match its bits on any device
    one_hot = (seg_id[:, :, None] == ar_s[None, None, :]).to(torch.float64)
    seg_comp_lat = torch.zeros((B, S), dtype=torch.float64, device=device)
    seg_comp_e = torch.zeros_like(seg_comp_lat)
    for layer in range(Lw):
        seg_comp_lat = seg_comp_lat + lat_l[:, layer, None] * one_hot[:, layer]
        seg_comp_e = seg_comp_e + e_l[:, layer, None] * one_hot[:, layer]

    ip_lat, ip_e, op_lat, op_e = comm_terms(db, mcm, cand, n_active,
                                            prev_end=prev_end, device=device)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    seg_lat = torch.where(valid_seg, seg_comp_lat + ip_lat + op_lat, zero)
    energy = numpy_row_sum(torch.where(valid_seg, seg_comp_e + ip_e + op_e,
                                       zero))
    if pipelined:
        lat = torch.where(n_segs > 1, seg_lat.amax(1), numpy_row_sum(seg_lat))
    else:
        lat = numpy_row_sum(seg_lat)
    return lat, energy


def numpy_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's association (``pairwise_sum``).

    Sequential below 8 elements; eight strided accumulators combined as a
    tree up to 128; halves (cut at a multiple of 8) beyond.  The float64
    oracle sums segments this way so its bits match the reference's
    ``ndarray.sum`` on any device; ``Tensor.sum`` uses another order.
    """
    n = x.shape[-1]
    if n < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[..., i]
        return res
    if n <= 128:
        r = [x[..., j] for j in range(8)]
        i = 8
        while i < n - n % 8:
            r = [r[j] + x[..., i + j] for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for k in range(i, n):
            res = res + x[..., k]
        return res
    half = n // 2
    half -= half % 8
    return numpy_row_sum(x[..., :half]) + numpy_row_sum(x[..., half:])
