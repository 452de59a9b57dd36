"""MAESTRO-extended intra-chiplet cost model (paper Sec. III-E, IV-E).

The paper offline-profiles every layer on every chiplet *dataflow class* with
MAESTRO [24,25] and stores a (layer x class) latency/energy database consumed
by the engines.  We reimplement the data-centric analytical core for the two
dataflow styles the paper evaluates:

* **NVDLA-style** (weight-stationary): PEs are spatially partitioned over the
  output-channel x input-channel (K x C) dims; weights stay resident, inputs
  and partial sums stream.  Strong on GEMM-heavy layers (transformers, 1x1
  convs), weak on shallow-channel spatial layers.
* **Shi-diannao-style** (output-stationary): PEs tile the output feature map
  (N x Y x X); each PE accumulates one output across C,R,S.  Strong on
  early/spatial convolutions, weak on FC/GEMM with small M.

Latency = max(compute-bound, L2-streaming-bound) cycles / clock.
Energy   = MACs * E_mac + L2 traffic * E_sram (per-bit), with dataflow-specific
re-fetch multipliers when the working set exceeds the 10 MB L2.

The derived (layer x class) tables reproduce the affinity structure the paper
relies on (Sec. V-B "Model Suite Diversity"): transformer layers prefer NVDLA,
spatial convs prefer Shi-diannao, with a crossover for late-stage 1x1 convs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .chiplet import ChipletClass, Dataflow, PackageParams
from .workload import Layer, OpType, Scenario

_RAMP_CYCLES = 64.0  # pipeline fill/drain per layer (systolic ramp)


def _ws_tile(n_pe: int) -> int:
    """Fixed WS array geometry: a sqrt(N_PE) x sqrt(N_PE) K x C MAC grid."""
    return max(1, int(math.isqrt(n_pe)))


def _gemm_cycles_ws(B: int, M: int, N: int, K: int, n_pe: int) -> float:
    """Weight-stationary (NVDLA) cycles for a batched GEMM."""
    t = _ws_tile(n_pe)
    ct = min(K, t)
    kt = min(N, t)
    steps = math.ceil(N / kt) * math.ceil(K / ct) * M * B
    return float(steps)


def _gemm_cycles_os(B: int, M: int, N: int, K: int, n_pe: int) -> float:
    """Output-stationary (Shi-diannao) cycles for a batched GEMM."""
    return float(math.ceil(B * M / n_pe) * N * K)


def _conv_cycles_ws(l: Layer, n_pe: int) -> float:
    t = _ws_tile(n_pe)
    ct = min(l.C, t)
    kt = min(l.K, t)
    steps = math.ceil(l.K / kt) * math.ceil(l.C / ct) * l.Y * l.X * l.R * l.S * l.N
    return float(steps)


def _conv_cycles_os(l: Layer, n_pe: int) -> float:
    return float(math.ceil(l.N * l.Y * l.X / n_pe) * l.K * l.C * l.R * l.S)


def compute_cycles(l: Layer, cls: ChipletClass) -> float:
    """Compute-bound cycles of layer ``l`` on chiplet class ``cls``."""
    n_pe = cls.n_pe
    if l.op == OpType.CONV:
        cyc = _conv_cycles_ws(l, n_pe) if cls.dataflow == Dataflow.NVDLA \
            else _conv_cycles_os(l, n_pe)
    elif l.op == OpType.DWCONV:
        if cls.dataflow == Dataflow.NVDLA:
            # depthwise: only C-parallelism available to a KC-partitioned array
            ct = min(l.C, n_pe)
            cyc = math.ceil(l.C / ct) * l.Y * l.X * l.R * l.S * l.N
        else:
            cyc = math.ceil(l.N * l.Y * l.X / n_pe) * l.R * l.S * l.C
    elif l.op == OpType.GEMM:
        f = _gemm_cycles_ws if cls.dataflow == Dataflow.NVDLA else _gemm_cycles_os
        cyc = f(l.B, l.M, l.Ndim, l.Kdim, n_pe)
    elif l.op == OpType.ATTN:
        # fused score (M x KV x hd) + context (M x hd x KV) batched GEMMs
        f = _gemm_cycles_ws if cls.dataflow == Dataflow.NVDLA else _gemm_cycles_os
        cyc = (f(l.B, l.M, l.Ndim, l.Kdim, n_pe)
               + f(l.B, l.M, l.Kdim, l.Ndim, n_pe))
    elif l.op in (OpType.POOL, OpType.ELEM):
        cyc = 0.0
    else:
        raise ValueError(l.op)
    return cyc + _RAMP_CYCLES


def l2_traffic_bytes(l: Layer, cls: ChipletClass) -> float:
    """L2 scratchpad traffic with dataflow-specific re-fetch multipliers.

    The asymmetry that creates the paper's affinity structure:
    * WS (NVDLA): weights are resident, but the sliding window re-reads each
      input activation R*S times from the L2 (im2col-style streaming), and
      inputs are re-streamed once per K-tile pass when the working set spills.
      GEMMs (R=S=1) pay no such penalty -> transformer affinity.
    * OS (Shi-diannao): inputs are fetched ~once (inter-PE shift-register
      reuse) and outputs stay resident, but the weight stream is re-read for
      every spatial output tile -> strong on spatial convs, weak on
      weight-heavy FC/GEMM with little output parallelism.
    """
    w, i, o = float(l.weight_bytes), float(l.in_bytes), float(l.out_bytes)
    fits = (w + i + o) <= cls.sz_mem
    if l.op in (OpType.POOL, OpType.ELEM):
        return i + o
    if cls.dataflow == Dataflow.NVDLA:
        window = float(l.R * l.S) if l.op in (OpType.CONV, OpType.DWCONV) else 1.0
        t = _ws_tile(cls.n_pe)
        spill = 1.0 if fits else math.ceil(max(l.K, l.Ndim) / t)
        return w + i * window * spill + o
    # output-stationary: weight stream repeats per spatial output tile
    n_sp_tiles = math.ceil(max(l.N * l.Y * l.X, l.B * l.M) / cls.n_pe)
    return w * min(n_sp_tiles, 16) + i + o


def layer_cost(l: Layer, cls: ChipletClass,
               pkg: PackageParams) -> tuple[float, float]:
    """(latency seconds, energy joules) of layer ``l`` on class ``cls``.

    This is Lat^comp / E^comp of Sec. III-E/F: the intra-chiplet part only;
    NoP/off-chip terms are added by ``repro_torch.core.cost`` per schedule.
    """
    cyc = compute_cycles(l, cls)
    traffic = l2_traffic_bytes(l, cls)
    stream_cyc = traffic / pkg.l2_bytes_per_cycle
    lat = max(cyc, stream_cyc) / pkg.clock_hz
    energy = (l.macs * pkg.mac_e_pj + traffic * 8.0 * pkg.sram_e_pj_per_bit) * 1e-12
    return lat, energy


@dataclasses.dataclass(frozen=True)
class CostDB:
    """Offline (layer x class) database, the engines' lookup table.

    ``lat``/``energy``: [n_layers, n_classes];
    ``w_bytes``/``in_bytes``/``out_bytes``: [n_layers];
    ``model_of``/``pos_in_model``: [n_layers] flat-index bookkeeping.
    """

    lat: np.ndarray
    energy: np.ndarray
    w_bytes: np.ndarray
    in_bytes: np.ndarray
    out_bytes: np.ndarray
    model_of: np.ndarray
    pos_in_model: np.ndarray
    model_names: tuple[str, ...]
    model_offsets: tuple[int, ...]   # start index of each model's layers

    @property
    def n_layers(self) -> int:
        return int(self.lat.shape[0])

    @property
    def n_models(self) -> int:
        return len(self.model_names)

    def model_slice(self, i: int) -> slice:
        start = self.model_offsets[i]
        end = (self.model_offsets[i + 1] if i + 1 < self.n_models
               else self.n_layers)
        return slice(start, end)


def build_cost_db(sc: Scenario, classes: tuple[ChipletClass, ...],
                  pkg: PackageParams) -> CostDB:
    """Offline-analyse every layer of ``sc`` on every chiplet class."""
    rows_lat, rows_e = [], []
    wb, ib, ob, mo, pim = [], [], [], [], []
    offsets = []
    idx = 0
    for mi, m in enumerate(sc.models):
        offsets.append(idx)
        for li, l in enumerate(m.layers):
            lats, es = [], []
            for cls in classes:
                lat, e = layer_cost(l, cls, pkg)
                lats.append(lat)
                es.append(e)
            rows_lat.append(lats)
            rows_e.append(es)
            wb.append(l.weight_bytes)
            ib.append(l.in_bytes)
            ob.append(l.out_bytes)
            mo.append(mi)
            pim.append(li)
            idx += 1
    return CostDB(
        lat=np.asarray(rows_lat, dtype=np.float64),
        energy=np.asarray(rows_e, dtype=np.float64),
        w_bytes=np.asarray(wb, dtype=np.float64),
        in_bytes=np.asarray(ib, dtype=np.float64),
        out_bytes=np.asarray(ob, dtype=np.float64),
        model_of=np.asarray(mo, dtype=np.int32),
        pos_in_model=np.asarray(pim, dtype=np.int32),
        model_names=tuple(m.name for m in sc.models),
        model_offsets=tuple(offsets),
    )


def expected_latency(db: CostDB, class_counts: np.ndarray) -> np.ndarray:
    """Eq. (1): dataflow-marginalised expected latency per layer, [n_layers]."""
    frac = class_counts.astype(np.float64) / class_counts.sum()
    return db.lat @ frac


def expected_energy(db: CostDB, class_counts: np.ndarray) -> np.ndarray:
    frac = class_counts.astype(np.float64) / class_counts.sum()
    return db.energy @ frac


def cost_db_from_arrays(d: dict[str, np.ndarray]) -> CostDB:
    """Build a ``CostDB`` from the reference CostDB's fields as arrays.

    The state bridge between the two packages: ``d`` holds ``lat``,
    ``energy`` ``[n_layers, n_classes]``, ``w_bytes``, ``in_bytes``,
    ``out_bytes``, ``model_of``, ``pos_in_model`` ``[n_layers]`` and
    ``model_names``, ``model_offsets``.  Dtypes are normalised to the ones
    ``build_cost_db`` produces, and the shapes are checked, so a table
    carried across from elsewhere feeds the scheduler exactly like one
    built here.
    """
    lat = np.asarray(d["lat"], dtype=np.float64)
    energy = np.asarray(d["energy"], dtype=np.float64)
    if lat.ndim != 2 or energy.shape != lat.shape:
        raise ValueError(f"lat {lat.shape} / energy {energy.shape} must be "
                         "equal [n_layers, n_classes] tables")
    n = lat.shape[0]
    vec = {}
    for k, dt in (("w_bytes", np.float64), ("in_bytes", np.float64),
                  ("out_bytes", np.float64), ("model_of", np.int32),
                  ("pos_in_model", np.int32)):
        vec[k] = np.asarray(d[k], dtype=dt)
        if vec[k].shape != (n,):
            raise ValueError(f"{k} has shape {vec[k].shape}, want ({n},)")
    names = tuple(str(x) for x in d["model_names"])
    offsets = tuple(int(x) for x in d["model_offsets"])
    if len(offsets) != len(names):
        raise ValueError("model_offsets and model_names differ in length")
    return CostDB(lat=lat, energy=energy, model_names=names,
                  model_offsets=offsets, **vec)
