"""Roofline terms from dry-run records (counterpart of
``repro.analysis.roofline``), with the NVIDIA H100 SXM5 80GB's figures.

compute_s    = flops (per rank) / PEAK_FLOPS
memory_s     = bytes_accessed (per rank) / HBM_BW   (an upper bound: the
               trace counts the plain path's unfused ops,
               ``analysis.trace_cost``)
collective_s = ring link bytes (per rank) / LINK_BW

The figures:

* ``PEAK_FLOPS``: 989.4e12 FLOP/s, dense bf16 on the tensor cores
  (NVIDIA H100 Tensor Core GPU datasheet, SXM5: 1 979 TFLOP/s with 2:4
  sparsity, half of it dense), at the card's 700 W limit.
* ``HBM_BW``: 3.35e12 B/s, HBM3 (same datasheet, SXM5 80GB).
* ``LINK_BW``: 50e9 B/s, one 400 Gb/s ConnectX-7 NIC per GPU (NVIDIA DGX
  H100 datasheet: eight 400 Gb/s InfiniBand ports for eight GPUs).  A
  group of the 16x16 and 2x16x16 meshes spans more than one 8-GPU node,
  so its ring crosses the NIC, which sets its pace; NVLink's 450 GB/s a
  direction (900 GB/s both ways, datasheet) joins only the ranks of one
  node.
"""
from __future__ import annotations

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "terms"]

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 50e9


def terms(rec: dict) -> dict:
    """The reference's ``terms``: the three times, the bottleneck, the
    roofline time (their maximum) and the compute share of it."""
    ct = rec["cost"]["flops"] / PEAK_FLOPS
    mt = rec["cost"]["bytes_accessed"] / HBM_BW
    lt = rec["collectives"]["total_link_bytes"] / LINK_BW
    dom = max(("compute", ct), ("memory", mt), ("collective", lt),
              key=lambda kv: kv[1])
    return {"compute_s": ct, "memory_s": mt, "collective_s": lt,
            "bottleneck": dom[0], "roofline_s": max(ct, mt, lt),
            "compute_fraction": ct / max(ct, mt, lt)}
