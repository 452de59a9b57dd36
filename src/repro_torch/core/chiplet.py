"""MCM hardware model (paper Definitions 2-3, Table I, Fig. 6 patterns).

A chiplet is an accelerator die with a dataflow class, PE count, NoC/memory
bandwidths and an L2 scratchpad (Definition 2).  The MCM is a 2D mesh of
chiplets with XY routing, NoP links, and off-chip DRAM interfaces on the
left/right package edges (Definition 3, Simba-style).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Dataflow(enum.Enum):
    NVDLA = "nvdla"            # weight-stationary, K/C-parallel
    SHIDIANNAO = "shidiannao"  # output-stationary, Y/X-parallel

DATAFLOW_CLASSES = (Dataflow.NVDLA, Dataflow.SHIDIANNAO)


# --- Table I constants (28 nm), plus documented extra-paper constants -------
@dataclasses.dataclass(frozen=True)
class PackageParams:
    dram_lat_s: float = 200e-9          # DRAM latency
    dram_e_pj_per_bit: float = 14.8     # DRAM energy
    dram_bw: float = 64e9               # DRAM bandwidth (bytes/s)
    nop_hop_lat_s: float = 35e-9        # NoP interconnect latency / hop
    nop_e_pj_per_bit: float = 2.04      # NoP energy
    nop_bw: float = 100e9               # NoP bandwidth (bytes/s/chiplet)
    clock_hz: float = 500e6             # Fig. 11: windows computed over 500 MHz
    # Extra-paper intra-chiplet constants (28 nm class, documented in DESIGN):
    mac_e_pj: float = 0.2               # int8 MAC energy
    sram_e_pj_per_bit: float = 0.6      # 10 MB L2 access energy (28 nm class)
    l2_bytes_per_cycle: float = 128.0   # chiplet shared-memory bandwidth
    # NoP contention: fraction of serialization added per concurrently active
    # model sharing the package (delta term in Lat^com).
    contention_delta: float = 0.05


@dataclasses.dataclass(frozen=True)
class NoCConfig:
    """Interposer NoC link parameters for the congestion comm model.

    The interposer is the 2D-mesh link graph between chiplet sites:
    ``rows * (cols - 1)`` horizontal links plus ``(rows - 1) * cols``
    vertical links (see ``cost.xy_route_links`` for the id layout).  The
    analytic comm model (``cost.comm_from_parts``) ignores it — transfers
    see the flat per-chiplet ``PackageParams.nop_bw`` — while
    ``comm_model="congestion"`` routes every transfer over XY links,
    rate-limits it by the slowest link *class* it traverses, and adds a
    bottleneck-link waiting term from co-scheduled tenants' traffic.

    All bandwidths are bytes/s.  ``congestion_alpha`` is a documented
    extra-paper constant: the fraction of the bottleneck link's
    background serialization time (bg bytes / link bw) a transfer waits,
    i.e. 0 = no contention, 1 = fully serialized behind co-tenants.
    With the defaults (``h_bw == v_bw == PackageParams.nop_bw`` and both
    >= ``dram_bw``) the rate terms vanish and congestion differs from
    the analytic model *only* by the waiting term, which is what makes
    zero route-overlap reduce to the analytic model exactly.
    """

    h_bw: float = 100e9                 # horizontal interposer links (bytes/s)
    v_bw: float = 100e9                 # vertical interposer links (bytes/s)
    congestion_alpha: float = 0.5       # bottleneck-wait fraction per transfer


@dataclasses.dataclass(frozen=True)
class ChipletClass:
    """Definition 2: c = {df, N_PE, BW_noc, BW_mem, Sz_mem}."""

    dataflow: Dataflow
    n_pe: int = 4096                    # 4096 datacenter / 256 AR-VR
    bw_noc: float = 256e9               # on-chiplet NoC (bytes/s)
    bw_mem: float = 64e9                # chiplet shared-mem BW (bytes/s)
    sz_mem: int = 10 * 2**20            # 10 MB L2 (Hexagon-inspired)


@dataclasses.dataclass(frozen=True)
class MCM:
    """Definition 3: H = {C, BW_offchip, BW_nop} on a 2D mesh."""

    name: str
    rows: int
    cols: int
    class_map: tuple[int, ...]          # per-position index into ``classes``
    classes: tuple[ChipletClass, ...]
    pkg: PackageParams = PackageParams()
    noc: NoCConfig = NoCConfig()        # interposer links (congestion model)

    @property
    def n_chiplets(self) -> int:
        return self.rows * self.cols

    def pos(self, cid: int) -> tuple[int, int]:
        return divmod(cid, self.cols)

    def cid(self, r: int, c: int) -> int:
        return r * self.cols + c

    def class_of(self, cid: int) -> ChipletClass:
        return self.classes[self.class_map[cid]]

    def class_idx(self, cid: int) -> int:
        return self.class_map[cid]

    def hops(self, a: int, b: int) -> int:
        """XY routing hop count between chiplets a and b."""
        (ra, ca), (rb, cb) = self.pos(a), self.pos(b)
        return abs(ra - rb) + abs(ca - cb)

    def neighbors(self, cid: int) -> list[int]:
        r, c = self.pos(cid)
        out = []
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            rr, cc = r + dr, c + dc
            if 0 <= rr < self.rows and 0 <= cc < self.cols:
                out.append(self.cid(rr, cc))
        return out

    def dram_ports(self) -> list[int]:
        """Chiplets with a direct off-chip interface: left & right columns."""
        out = []
        for r in range(self.rows):
            out.append(self.cid(r, 0))
            if self.cols > 1:
                out.append(self.cid(r, self.cols - 1))
        return sorted(set(out))

    def hops_to_dram(self, cid: int) -> int:
        _, c = self.pos(cid)
        return min(c, self.cols - 1 - c)

    def class_counts(self) -> np.ndarray:
        """n_{df_i} of Eq. (1): chiplet count per class index."""
        counts = np.zeros(len(self.classes), dtype=np.int64)
        for idx in self.class_map:
            counts[idx] += 1
        return counts


# ---------------------------------------------------------------------------
# Fig. 6 organisations: Simba(NVDLA), Simba(Shi), Het-CB, Het-Sides, Het-Cross
# ---------------------------------------------------------------------------

def _classes(n_pe: int) -> tuple[ChipletClass, ChipletClass]:
    return (ChipletClass(Dataflow.NVDLA, n_pe=n_pe),
            ChipletClass(Dataflow.SHIDIANNAO, n_pe=n_pe))


def make_mcm(pattern: str, rows: int = 3, cols: int = 3,
             n_pe: int = 4096, noc: NoCConfig | None = None) -> MCM:
    """Build one of the five evaluated MCM organisations.

    Patterns: ``simba_nvdla``, ``simba_shi`` (homogeneous), ``het_cb``
    (checkerboard), ``het_sides`` (left half NVDLA / right half Shi-diannao),
    ``het_cross`` (Shi-diannao on the centre row+column, NVDLA elsewhere).
    ``noc`` overrides the interposer link parameters used by the
    congestion comm model (defaults to uniform 100 GB/s links).
    """
    classes = _classes(n_pe)
    n = rows * cols
    if pattern == "simba_nvdla":
        cmap = [0] * n
    elif pattern == "simba_shi":
        cmap = [1] * n
    elif pattern == "het_cb":
        cmap = [(r + c) % 2 for r in range(rows) for c in range(cols)]
    elif pattern == "het_sides":
        cmap = [0 if c < (cols + 1) // 2 else 1
                for r in range(rows) for c in range(cols)]
    elif pattern == "het_cross":
        cmap = [1 if (r == rows // 2 or c == cols // 2) else 0
                for r in range(rows) for c in range(cols)]
    else:
        raise ValueError(f"unknown MCM pattern {pattern!r}")
    return MCM(name=f"{pattern}_{rows}x{cols}", rows=rows, cols=cols,
               class_map=tuple(cmap), classes=classes,
               noc=noc if noc is not None else NoCConfig())


ALL_PATTERNS = ("simba_nvdla", "simba_shi", "het_cb", "het_sides", "het_cross")
HET_PATTERNS = ("het_cb", "het_sides", "het_cross")
