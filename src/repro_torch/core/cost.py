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

from ..launch import platform
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
    """Raise ``ValueError`` unless ``comm_model`` is ``"analytic"`` (paper
    Sec. III-E hop geometry) or ``"congestion"`` (routed interposer links,
    below)."""
    if comm_model not in ("analytic", "congestion"):
        raise ValueError(f"unknown comm_model {comm_model!r}")


# ---------------------------------------------------------------------------
# Interposer NoC link model (comm_model="congestion")
#
# The analytic model above prices hop *count*; the congestion model routes
# every transfer over the concrete interposer links (XY routing), rate-limits
# it by the slowest link class it traverses (NoCConfig.h_bw / v_bw), and adds
# a waiting term on the bottleneck link shared with co-scheduled tenants.
# Link id layout: horizontal link (r, c)-(r, c+1) has id ``r*(cols-1) + c``;
# vertical link (r, c)-(r+1, c) has id ``rows*(cols-1) + r*cols + c``.
# ---------------------------------------------------------------------------

def n_interposer_links(rows: int, cols: int) -> int:
    """Number of interposer mesh links: horizontal then vertical ids."""
    return rows * (cols - 1) + (rows - 1) * cols


def dram_edge_col(cols: int, c: int) -> int:
    """Column of the DRAM port a chiplet in column ``c`` streams through.

    Nearest package edge; ties (odd-width centre column) break left, and
    ``MCM.hops_to_dram`` equals the resulting horizontal distance.
    """
    return 0 if c <= cols - 1 - c else cols - 1


def xy_route_links(rows: int, cols: int, src: int, dst: int) -> list[int]:
    """Interposer link ids of the XY route ``src -> dst`` (X first, then Y).

    The horizontal leg runs on the *source* row, the vertical leg on the
    *destination* column; the list is empty when ``src == dst``.  Link
    count always equals ``MCM.hops(src, dst)``.
    """
    n_h = rows * (cols - 1)
    r1, c1 = divmod(src, cols)
    r2, c2 = divmod(dst, cols)
    links = [r1 * (cols - 1) + c for c in range(min(c1, c2), max(c1, c2))]
    links += [n_h + r * cols + c2 for r in range(min(r1, r2), max(r1, r2))]
    return links


def dram_route_links(rows: int, cols: int, cid: int) -> list[int]:
    """Interposer link ids between chiplet ``cid`` and its DRAM port.

    Horizontal-only (ports sit on the left/right package edges); empty when
    the chiplet is itself a port.  Link count equals ``MCM.hops_to_dram``.
    """
    r, c = divmod(cid, cols)
    e = dram_edge_col(cols, c)
    return [r * (cols - 1) + cc for cc in range(min(c, e), max(c, e))]


def link_bandwidths(mcm: MCM) -> np.ndarray:
    """Per-link bandwidth (bytes/s), ``[n_links]`` float64, h then v ids."""
    n_h = mcm.rows * (mcm.cols - 1)
    bw = np.empty(n_interposer_links(mcm.rows, mcm.cols), dtype=np.float64)
    bw[:n_h] = mcm.noc.h_bw
    bw[n_h:] = mcm.noc.v_bw
    return bw


def plan_link_bytes(db: CostDB, mcm: MCM, plan: ModelWindowPlan,
                    prev_end: Optional[dict[int, int]] = None) -> np.ndarray:
    """Bytes one plan pushes over each interposer link, ``[n_links]`` f64.

    Accumulates exactly the transfers ``evaluate_window`` prices: every
    segment's weight stream to/from its DRAM port, the first segment's
    input activations (DRAM route when cold, XY route from the anchor in
    ``prev_end``, nothing when resident), inter-segment activation
    forwards (XY), and the last segment's DRAM writeback.  The scalar
    occupancy oracle of the placement co-search.
    """
    prev_end = prev_end or {}
    rows, cols = mcm.rows, mcm.cols
    occ = np.zeros(n_interposer_links(rows, cols), dtype=np.float64)
    seg_start = plan.start
    for si, seg_end in enumerate(plan.seg_ends):
        cid = plan.chiplets[si]
        dram_links = dram_route_links(rows, cols, cid)
        w_sz = float(db.w_bytes[seg_start:seg_end].sum())
        occ[dram_links] += w_sz
        if si == 0:
            act_in = float(db.in_bytes[seg_start])
            if prev_end.get(plan.model_idx) == cid:
                pass  # resident on-chiplet: no interposer traffic
            elif plan.model_idx in prev_end:
                occ[xy_route_links(rows, cols, prev_end[plan.model_idx],
                                   cid)] += act_in
            else:
                occ[dram_links] += act_in
        act_out = float(db.out_bytes[seg_end - 1])
        if si + 1 < plan.n_segments:
            occ[xy_route_links(rows, cols, cid,
                               plan.chiplets[si + 1])] += act_out
        else:
            occ[dram_links] += act_out
        seg_start = seg_end
    return occ


def window_link_occupancy(db: CostDB, mcm: MCM, wp: WindowPlan,
                          prev_end: Optional[dict[int, int]] = None
                          ) -> np.ndarray:
    """Total per-link byte occupancy of all plans in a window, ``[n_links]``."""
    occ = np.zeros(n_interposer_links(mcm.rows, mcm.cols), dtype=np.float64)
    for p in wp.plans:
        occ += plan_link_bytes(db, mcm, p, prev_end)
    return occ


def _route_wait(bg_cost: np.ndarray, links: list[int]) -> float:
    """Bottleneck waiting time (s) over a route: max of ``bg_cost[links]``."""
    return float(bg_cost[links].max()) if links else 0.0


def _dram_corr(sz: float, hops: int, wait: float, mcm: MCM) -> float:
    """Congestion correction (s) added to ``_dram_lat`` for one transfer."""
    if sz == 0:
        return 0.0
    noc = mcm.noc
    rate = ((1.0 / min(mcm.pkg.dram_bw, noc.h_bw) - 1.0 / mcm.pkg.dram_bw)
            if hops > 0 else 0.0)
    return sz * rate + noc.congestion_alpha * wait


def _nop_corr(sz: float, h_hops: int, v_hops: int, wait: float,
              mcm: MCM) -> float:
    """Congestion correction (s) added to ``_nop_lat`` for one transfer."""
    if sz == 0 or h_hops + v_hops == 0:
        return 0.0
    noc = mcm.noc
    inv_route = max(1.0 / noc.h_bw if h_hops > 0 else 0.0,
                    1.0 / noc.v_bw if v_hops > 0 else 0.0)
    return sz * (inv_route - 1.0 / mcm.pkg.nop_bw) + noc.congestion_alpha * wait


def evaluate_window(db: CostDB, mcm: MCM, wp: WindowPlan,
                    prev_end: Optional[dict[int, int]] = None,
                    validate: bool = False,
                    comm_model: str = "analytic") -> WindowResult:
    """Evaluate one time window of co-scheduled model plans.

    Window latency (seconds) is the max over the per-model latencies,
    energy (joules) the sum over every compute and transfer term.

    ``comm_model`` selects the communication cost model: ``"analytic"``
    (paper Sec. III-E hop geometry) or ``"congestion"``, which adds a
    routed link-occupancy correction per transfer — each plan's traffic
    is routed over concrete interposer links (``xy_route_links``) and
    waits on the bottleneck link it shares with the *other* plans in the
    window (see ``_dram_corr`` / ``_nop_corr``).  Corrections affect
    latency only; bytes moved, and therefore energy, are identical under
    both models.  This scalar float64 host path is the parity oracle for
    the batched forms (``eval_model_candidates`` and the
    ``kernels.scar_eval`` bridge) and gives every reported schedule
    metric.
    """
    if validate:
        wp.validate()
    check_comm_model(comm_model)
    prev_end = prev_end or {}
    congestion = comm_model == "congestion"
    rows, cols = mcm.rows, mcm.cols
    if congestion:
        occs = [plan_link_bytes(db, mcm, p, prev_end) for p in wp.plans]
        bw = link_bandwidths(mcm)
    n_active = len(wp.plans)
    per_model_lat: dict[int, float] = {}
    per_model_segs: dict[int, tuple[tuple[float, int], ...]] = {}
    end_chiplet: dict[int, int] = {}
    total_energy = 0.0
    for pi, p in enumerate(wp.plans):
        if congestion:
            # background = co-tenants' bytes on each link, never own traffic
            bg = np.zeros_like(occs[pi])
            for j, o in enumerate(occs):
                if j != pi:
                    bg = bg + o
            bg_cost = bg / bw
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
            ip_corr = op_corr = 0.0
            if congestion:
                wait_d = _route_wait(bg_cost,
                                     dram_route_links(rows, cols, cid))
                ip_corr = _dram_corr(w_sz, hops_dram, wait_d, mcm)
            if si == 0:
                act_in = float(db.in_bytes[seg_start])
                if prev_end.get(p.model_idx) == cid:
                    pass  # activations already resident on-chiplet
                elif p.model_idx in prev_end:
                    src = prev_end[p.model_idx]
                    hops = mcm.hops(src, cid)
                    ip_lat += _nop_lat(act_in, hops, mcm, n_active)
                    ip_e += _nop_energy(act_in, hops, mcm)
                    if congestion:
                        (r1, c1), (r2, c2) = mcm.pos(src), mcm.pos(cid)
                        wait0 = _route_wait(
                            bg_cost, xy_route_links(rows, cols, src, cid))
                        ip_corr += _nop_corr(act_in, abs(c1 - c2),
                                             abs(r1 - r2), wait0, mcm)
                else:
                    ip_lat += _dram_lat(act_in, hops_dram, mcm, n_active)
                    ip_e += _dram_energy(act_in, hops_dram, mcm)
                    if congestion:
                        ip_corr += _dram_corr(act_in, hops_dram, wait_d, mcm)
            # op_com: forward activations to next segment (NoP), or write the
            # model's window output back to DRAM at the window boundary.
            act_out = float(db.out_bytes[seg_end - 1])
            if si + 1 < p.n_segments:
                nxt = p.chiplets[si + 1]
                hops = mcm.hops(cid, nxt)
                op_lat = _nop_lat(act_out, hops, mcm, n_active)
                op_e = _nop_energy(act_out, hops, mcm)
                if congestion:
                    (r1, c1), (r2, c2) = mcm.pos(cid), mcm.pos(nxt)
                    wait_n = _route_wait(
                        bg_cost, xy_route_links(rows, cols, cid, nxt))
                    op_corr = _nop_corr(act_out, abs(c1 - c2), abs(r1 - r2),
                                        wait_n, mcm)
            else:
                op_lat = _dram_lat(act_out, hops_dram, mcm, n_active)
                op_e = _dram_energy(act_out, hops_dram, mcm)
                if congestion:
                    op_corr = _dram_corr(act_out, hops_dram, wait_d, mcm)
                end_chiplet[p.model_idx] = cid
            if congestion:
                seg_lats.append(comp_lat + (ip_lat + ip_corr)
                                + (op_lat + op_corr))
            else:
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
    ``evaluate_window``); anchors thread identically under both.
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
    computes.  The constants are filled on the device (each value is
    exact in ``fdt``), not copied from the host, which would block.
    """
    def const(v):
        return torch.full((), float(v), dtype=fdt, device=device)

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
    exactly the reference's) and go up in one copy per dtype
    (``launch.platform.device_upload``); ``s_max`` shrinks the segment
    axis.
    """
    up = platform.device_upload(_comm_parts(db, cand, s_max), device)
    return _comm_terms_on(db, mcm, cand, up, n_active, prev_end)


def _comm_parts(db: CostDB, cand: BatchedModelCandidates,
                s_max: Optional[int]) -> dict[str, np.ndarray]:
    """The host arrays ``comm_from_parts`` and ``congestion_correction``
    price a batch from: chiplet ids, segment weight sums and last-layer
    output bytes (``[B, S]``), and the segment counts."""
    S = int(s_max) if s_max is not None else cand.chiplets.shape[1]
    sl = slice(cand.start, cand.end)
    seg_w, seg_last_out = segment_reductions(
        cand.seg_id, cand.n_segs, db.w_bytes[sl], db.out_bytes[sl], s_max=S)
    return {"cpos": np.maximum(cand.chiplets[:, :S], 0).astype(np.int64),
            "seg_w": seg_w, "seg_last_out": seg_last_out,
            "n_segs": np.asarray(cand.n_segs, np.int64)}


def _comm_terms_on(db: CostDB, mcm: MCM, cand: BatchedModelCandidates,
                   up: dict[str, torch.Tensor], n_active: int,
                   prev_end: Optional[int]) -> tuple[torch.Tensor, ...]:
    """``comm_terms`` over the uploaded ``_comm_parts``."""
    prev = int(prev_end) if prev_end is not None else None
    return comm_from_parts(mcm.pkg, mcm.cols, up["cpos"], up["seg_w"],
                           up["seg_last_out"], up["n_segs"], n_active,
                           float(db.in_bytes[cand.start]), prev)


def _span_bottleneck_mask(n: int) -> np.ndarray:
    """Static ``[n, n, n-1]`` bool mask of 1-D span membership.

    Entry ``[a, b, k]`` is True iff consecutive-link ``k`` lies on the
    1-D span ``a -> b``.  Pure mesh geometry over Python ints, a host
    constant.
    """
    a = np.arange(n)
    lo = np.minimum(a[:, None], a[None, :])[..., None]
    hi = np.maximum(a[:, None], a[None, :])[..., None]
    span = np.arange(n - 1)[None, None, :]
    return (span >= lo) & (span < hi)


def _mesh_route_index(rows: int, cols: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static per-chiplet ``(row, col, dram_edge_col)`` index arrays.

    ``dram_edge_col`` is the nearer of columns 0 / ``cols - 1`` (ties to
    0), matching ``dram_route_links``.
    """
    idx = np.arange(rows * cols)
    r, c = idx // cols, idx % cols
    edge = np.where(c <= cols - 1 - c, 0, cols - 1)
    return r, c, edge


_ROUTE_TABLES: dict[tuple[int, int, torch.device],
                    dict[str, torch.Tensor]] = {}


def route_tables(rows: int, cols: int,
                 device: torch.device) -> dict[str, torch.Tensor]:
    """The static route masks and index arrays of a mesh on ``device``,
    uploaded once (one copy per dtype) and kept.

    ``h_mask`` / ``v_mask`` are ``_span_bottleneck_mask(cols)`` /
    ``(rows)``; ``r``, ``c``, ``edge`` are ``_mesh_route_index``.  A
    host-to-device copy blocks the host, so ``route_wait_tables`` reuses
    these across batches, as ``quantize.pow10_table`` is reused.
    """
    key = (rows, cols, torch.device(device))
    if key not in _ROUTE_TABLES:
        r, c, edge = _mesh_route_index(rows, cols)
        _ROUTE_TABLES[key] = platform.device_upload(
            {"h_mask": _span_bottleneck_mask(cols),
             "v_mask": _span_bottleneck_mask(rows),
             "r": r, "c": c, "edge": edge}, key[2])
    return _ROUTE_TABLES[key]


def route_tables_clear() -> None:
    """Drop the device copies of the route tables (``clear_caches``)."""
    _ROUTE_TABLES.clear()


def route_wait_tables(link_cost, rows: int, cols: int):
    """Bottleneck-wait lookup tables over all XY routes of a mesh.

    ``link_cost`` is ``[n_links]`` per-link waiting time in seconds
    (background bytes / link bandwidth, h then v link ids), a torch tensor
    (the tables come back on its device, in its dtype) or a numpy array
    (the tables come back as numpy: the host form).  Returns
    ``(wait_pair, wait_dram)``: ``wait_pair[s, d]`` is the max link cost
    on the XY route ``s -> d`` (``[n, n]``), ``wait_dram[c]`` the max on
    chiplet ``c``'s DRAM-port route (``[n]``), 0 over an empty route.
    Built from the static range masks of ``_span_bottleneck_mask`` /
    ``_mesh_route_index``; a max is exact, so the tables equal
    ``_route_wait`` over ``xy_route_links`` / ``dram_route_links``.
    """
    if isinstance(link_cost, np.ndarray):
        wp, wd = route_wait_tables(torch.from_numpy(link_cost), rows, cols)
        return wp.numpy(), wd.numpy()
    tab = route_tables(rows, cols, link_cost.device)
    zero = link_cost.new_zeros(())
    n_h = rows * (cols - 1)
    if cols > 1:
        h = link_cost[:n_h].reshape(rows, cols - 1)
        hmax = torch.where(tab["h_mask"][None], h[:, None, None, :],
                           zero).amax(-1)            # [rows, cols, cols]
    else:
        hmax = link_cost.new_zeros((rows, 1, 1))
    if rows > 1:
        v = link_cost[n_h:].reshape(rows - 1, cols).T  # [cols, rows-1]
        vmax = torch.where(tab["v_mask"][None], v[:, None, None, :],
                           zero).amax(-1)            # [cols, rows, rows]
    else:
        vmax = link_cost.new_zeros((cols, 1, 1))
    r, c, edge = tab["r"], tab["c"], tab["edge"]
    # XY route s->d: horizontal leg on the source row, vertical on the
    # destination column — max of the two leg bottlenecks.
    wait_pair = torch.maximum(hmax[r[:, None], c[:, None], c[None, :]],
                              vmax[c[None, :], r[:, None], r[None, :]])
    wait_dram = hmax[r, c, edge]
    return wait_pair, wait_dram


def congestion_constants(pkg, noc) -> tuple[float, float, float, float,
                                             float]:
    """``(alpha, rate_d, 1/h_bw, 1/v_bw, 1/nop_bw)`` as Python floats.

    ``rate_d`` is the extra seconds a byte of a DRAM stream spends when
    its route crosses links slower than the DRAM interface.
    """
    return (noc.congestion_alpha,
            1.0 / min(pkg.dram_bw, noc.h_bw) - 1.0 / pkg.dram_bw,
            1.0 / noc.h_bw, 1.0 / noc.v_bw, 1.0 / pkg.nop_bw)


def congestion_correction(pkg, noc, cols: int, cpos: torch.Tensor,
                          seg_w: torch.Tensor, seg_last_out: torch.Tensor,
                          n_segs: torch.Tensor, act_in: float,
                          prev_end: Optional[int], wait_pair: torch.Tensor,
                          wait_dram: torch.Tensor):
    """Routed-link latency corrections added on top of ``comm_from_parts``.

    Mirrors the analytic term structure transfer for transfer (weights
    stream, first-segment activations, boundary forwards, writeback) but
    prices two link-level effects the hop-geometry model cannot see:

    * **rate**: a transfer is limited by the slowest link *class* on its
      XY route (``noc.h_bw`` / ``noc.v_bw``) instead of the flat
      ``pkg.nop_bw`` / ``pkg.dram_bw``, contributing
      ``sz * (1/bw_route - 1/bw_flat)``;
    * **wait**: ``noc.congestion_alpha`` times the bottleneck-link
      background serialization time, gathered from the ``wait_pair`` /
      ``wait_dram`` tables (``route_wait_tables``).

    The torch form of the reference's xp-generic function: the same code
    gives the float64 oracle terms and the float32 terms of the kernel's
    plain version, in the dtype of ``seg_w``.  The per-route rates are
    tensors of that dtype: ``torch.where`` of two Python floats would be
    float32 whatever the batch.  Returns ``(ip_corr, op_corr)``, each
    ``[B, S]`` seconds; energy has no correction (bytes moved are
    identical under both models).
    """
    S = cpos.shape[1]
    fdt, dev = seg_w.dtype, seg_w.device
    rows_, cols_ = cpos // cols, cpos % cols
    hops_dram = torch.minimum(cols_, cols - 1 - cols_)           # [B, S]
    nxt = torch.roll(cpos, -1, dims=1)
    r2, c2 = nxt // cols, nxt % cols
    h_next = (cols_ - c2).abs()
    v_next = (rows_ - r2).abs()

    alpha, rate_d, inv_h, inv_v, inv_nop = congestion_constants(pkg, noc)

    def const(v):
        return torch.full((), v, dtype=fdt, device=dev)

    zero, rate_d, inv_h, inv_v = (const(v) for v in (0.0, rate_d, inv_h,
                                                     inv_v))

    def dram_corr(sz, hops, wait):
        return torch.where(sz > 0, sz * torch.where(hops > 0, rate_d, zero)
                           + alpha * wait, zero)

    def nop_corr(sz, h_hops, v_hops, wait):
        inv_route = torch.maximum(torch.where(h_hops > 0, inv_h, zero),
                                  torch.where(v_hops > 0, inv_v, zero))
        return torch.where((sz > 0) & (h_hops + v_hops > 0),
                           sz * (inv_route - inv_nop) + alpha * wait, zero)

    wd = wait_dram[cpos]                                         # [B, S]
    ip_corr = dram_corr(seg_w, hops_dram, wd)
    fr, fc = cpos[:, 0] // cols, cpos[:, 0] % cols
    act = torch.full(fc.shape, act_in, dtype=fdt, device=dev)
    if prev_end is None:
        f_hops_dram = torch.minimum(fc, cols - 1 - fc)
        add = dram_corr(act, f_hops_dram, wait_dram[cpos[:, 0]])
    else:
        pr, pc = prev_end // cols, prev_end % cols
        add = nop_corr(act, (fc - pc).abs(), (fr - pr).abs(),
                       wait_pair[prev_end, cpos[:, 0]])
    first = (torch.arange(S, device=dev) == 0)[None, :]
    ip_corr = ip_corr + torch.where(first, add[:, None], zero)

    is_last = torch.arange(S, device=dev)[None, :] == (n_segs - 1)[:, None]
    op_corr = torch.where(is_last,
                          dram_corr(seg_last_out, hops_dram, wd),
                          nop_corr(seg_last_out, h_next, v_next,
                                   wait_pair[cpos, nxt]))
    return ip_corr, op_corr


def congestion_terms(db: CostDB, mcm: MCM, cand: BatchedModelCandidates,
                     prev_end: Optional[int] = None,
                     link_occ: Optional[np.ndarray] = None,
                     s_max: Optional[int] = None, *,
                     device: torch.device) -> tuple[torch.Tensor, ...]:
    """Float64 congestion corrections for one candidate batch.

    ``link_occ`` is the background byte occupancy ``[n_links]`` of all
    *other* co-scheduled traffic (None means an uncontended interposer).
    Returns ``(ip_corr, op_corr)``, each ``[B, S]`` float64 seconds on
    ``device``, to be added to the corresponding ``comm_terms`` latencies.
    The per-link cost (bytes / bandwidth) is divided on the host, as the
    reference divides it; the batch goes up in one copy per dtype.
    """
    up = platform.device_upload({**_comm_parts(db, cand, s_max),
                                 "link_cost": _link_cost(mcm, link_occ)},
                                device)
    return _congestion_terms_on(db, mcm, cand, up, prev_end)


def _link_cost(mcm: MCM, link_occ: Optional[np.ndarray]) -> np.ndarray:
    """Float64 per-link waiting time ``link_occ / bandwidth`` (seconds)."""
    if link_occ is None:
        link_occ = np.zeros(n_interposer_links(mcm.rows, mcm.cols))
    return np.asarray(link_occ, dtype=np.float64) / link_bandwidths(mcm)


def _congestion_terms_on(db: CostDB, mcm: MCM, cand: BatchedModelCandidates,
                         up: dict[str, torch.Tensor],
                         prev_end: Optional[int]) -> tuple[torch.Tensor, ...]:
    """``congestion_terms`` over the uploaded ``_comm_parts`` and
    ``link_cost``."""
    wait_pair, wait_dram = route_wait_tables(up["link_cost"], mcm.rows,
                                             mcm.cols)
    prev = int(prev_end) if prev_end is not None else None
    return congestion_correction(mcm.pkg, mcm.noc, mcm.cols, up["cpos"],
                                 up["seg_w"], up["seg_last_out"],
                                 up["n_segs"], float(db.in_bytes[cand.start]),
                                 prev, wait_pair, wait_dram)


def eval_model_candidates(db: CostDB, mcm: MCM, cand: BatchedModelCandidates,
                          n_active: int,
                          prev_end: Optional[int] = None,
                          pipelined: bool = True,
                          comm_model: str = "analytic",
                          link_occ: Optional[np.ndarray] = None, *,
                          device: torch.device
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float64 ``(lat[B], energy[B])`` tensors on ``device`` for one batch.

    Latencies are seconds, energies joules.  The torch form of the
    reference's numpy oracle, with its operations in the same order, so
    the two agree bit for bit (tested).  It is the ``torch`` backend of
    ``core.evaluator``, which the ``auto`` policy picks for small batches.
    Under ``comm_model="congestion"`` pass the co-tenants' byte occupancy
    as ``link_occ`` (``[n_links]``, e.g. from ``plan_link_bytes``).
    The batch's host arrays go up in one copy per dtype
    (``launch.platform.device_upload``): two, whatever the comm model.
    """
    check_comm_model(comm_model)
    B, Lw = cand.seg_id.shape
    S = cand.chiplets.shape[1]
    sl = slice(cand.start, cand.end)
    host = {**_comm_parts(db, cand, None),
            "class_map": np.asarray(mcm.class_map, dtype=np.int64),
            "seg_id": np.asarray(cand.seg_id, np.int64),
            "lat_tab": db.lat[sl], "e_tab": db.energy[sl]}   # [Lw, C]
    if comm_model == "congestion":
        host["link_cost"] = _link_cost(mcm, link_occ)
    up = platform.device_upload(host, device)

    cpos, seg_id, n_segs = up["cpos"], up["seg_id"], up["n_segs"]
    seg_cls = up["class_map"][cpos]                              # [B, S]
    ar_s = torch.arange(S, device=device)
    valid_seg = ar_s[None, :] < n_segs[:, None]                  # [B, S]

    lat_tab, e_tab = up["lat_tab"], up["e_tab"]
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

    ip_lat, ip_e, op_lat, op_e = _comm_terms_on(db, mcm, cand, up,
                                                n_active, prev_end)
    if comm_model == "congestion":
        ip_corr, op_corr = _congestion_terms_on(db, mcm, cand, up, prev_end)
        ip_lat = ip_lat + ip_corr
        op_lat = op_lat + op_corr
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
