"""Where the port's float32 scores differ from the JAX reference's.

Takes the reference's own scoring batches of four schedules (dc5, xr10 and
dc4 on the 6x6 ``het_cross`` package, dc4 on the 16x16 ``het_cb`` pod at
``path_cap=1024``), scores each with the reference's compiled float32
evaluator (``repro.kernels.scar_eval.evaluate(..., use_kernel=False)``, JAX
on the CPU) and with the port's float32 path (``pack_window`` +
``scar_eval_window_plain``, which the CUDA kernel matches bit for bit), and
prints per batch the rows whose latency or energy differ, with the ulp
differences of the dc5 window-0 model-1 batch.

Three more columns explain the rest:

* ``divide``: the port with its comm terms divided by the bandwidths, as
  before it multiplied by their float32 reciprocals as XLA does;
* ``model seq`` / ``model halving``: a numpy model of the reference's
  compiled program, with the multiply-adds its LLVM backend fuses into
  FMAs, summing the ``[B, S]`` energies sequentially or by vector halving
  (``(x0 + x2) + (x1 + x3)`` at S = 4); which one XLA emits depends on
  the compiled program.

Last, the float32 quantiser against ``jax.jit(quantize_scores_jax)`` on
200 000 seeded scores, in the port's multiply form and in the divide form.

Usage: python scripts/torch_f32_parity.py
"""
from __future__ import annotations

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.provision import provision  # noqa: E402
from repro.core.reconfig import greedy_pack  # noqa: E402
from repro.core.sched import assemble_candidates  # noqa: E402
from repro.core.scheduler import get_cost_db  # noqa: E402
from repro.core.segmentation import top_k_segmentations  # noqa: E402
from repro.kernels.scar_eval import ops as ref_ops  # noqa: E402
from repro_torch.core import cost as port_cost  # noqa: E402
from repro_torch.core.cost import BatchedModelCandidates  # noqa: E402
from repro_torch.core.maestro import cost_db_from_arrays  # noqa: E402
from repro_torch.kernels.scar_eval import (blocked_cumsum,  # noqa: E402
                                           model_inputs, pack_window,
                                           scar_eval_window_plain)

SCHEDULES = [("dc5_lms_seg_image_wide", "het_cross", 6, 128),
             ("xr10_vr_gaming", "het_cross", 6, 128),
             ("dc4_lms_seg_image", "het_cross", 6, 128),
             ("dc4_lms_seg_image", "het_cb", 16, 1024)]
F32 = np.float32
CPU = torch.device("cpu")


def reference_batches():
    """Per scoring batch of each schedule: its key, the reference's packed
    arguments and float32 scores, and the port's view of the same batch."""
    for scn, pattern, rows, cap in SCHEDULES:
        n_pe = 4096 if scn.startswith("dc") else 256
        mcm = R.make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe)
        cfg = R.SearchConfig(path_cap=cap)
        plan = R.schedule(R.get_scenario(scn), mcm, cfg)
        db = get_cost_db(R.get_scenario(scn), mcm)
        tdb = cost_db_from_arrays({f.name: getattr(db, f.name)
                                   for f in dataclasses.fields(db)})
        tmcm = T.make_mcm(pattern, rows=rows, cols=rows, n_pe=n_pe)
        anchors: dict[int, int] = {}
        for w, ranges in enumerate(greedy_pack(db, mcm.class_counts(),
                                               cfg.n_splits).ranges):
            alloc = provision(db, mcm.class_counts(), ranges,
                              mcm.n_chiplets, metric=cfg.metric,
                              max_nodes_per_model=cfg.max_nodes_per_model)
            for mi, (s, e) in sorted(ranges.items()):
                segs = top_k_segmentations(db, mcm, s, e, alloc[mi],
                                           k=cfg.seg_top_k, cap=cfg.seg_cap,
                                           metric=cfg.metric)
                cand, _, _ = assemble_candidates(
                    mcm, mi, (s, e), segs, anchors.get(mi), path_cap=cap,
                    frontier_cap=cfg.frontier_cap)
                args, statics, b = ref_ops.pack_candidates(
                    db, mcm, cand, len(ranges), prev_end=anchors.get(mi),
                    pad_b=128, dense=False)
                ref = np.asarray(ref_ops.evaluate(
                    *args, **statics, use_kernel=False))[:b]
                tcand = BatchedModelCandidates(
                    **{f.name: getattr(cand, f.name)
                       for f in dataclasses.fields(cand)})
                port = (tdb, tmcm, tcand, len(ranges), anchors.get(mi))
                yield ((scn, rows, w, mi), [np.asarray(a) for a in args],
                       statics, b, ref, port)
            anchors.update(plan.windows[w].result.end_chiplet)


def port_scores(port) -> np.ndarray:
    tdb, tmcm, tcand, n_active, prev = port
    batch = pack_window([model_inputs(tdb, tcand, prev)], tmcm.class_map,
                        tmcm.pkg, tmcm.cols, n_active, device=CPU)
    return scar_eval_window_plain(batch).numpy()


def divide_scores(port) -> np.ndarray:
    """The port's scores with the comm terms divided by the bandwidths."""
    real = port_cost._per_bandwidth

    def divide(pkg, fdt, device):
        dram = torch.tensor(pkg.dram_bw, dtype=fdt, device=device)
        nop = torch.tensor(pkg.nop_bw, dtype=fdt, device=device)
        return (lambda sz: sz / dram), (lambda sz: sz / nop)

    port_cost._per_bandwidth = divide
    try:
        return port_scores(port)
    finally:
        port_cost._per_bandwidth = real


def fma(a, b, c):
    """float32 fused multiply-add, through float64 (exact product)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def model_scores(args, statics, b, halving: bool) -> np.ndarray:
    """numpy model of the reference's compiled float32 evaluator: the
    HLO's operations, FMAs where its LLVM backend fuses a multiply into the
    add that consumes it, and the chosen order of the energy sum."""
    (lat_tab, e_tab, w_bytes, out_bytes, class_map, chips, _, last, n_segs,
     act_in, prev_idx, _, _) = args
    pkg, cols = statics["pkg"], statics["mcm_cols"]
    n_active = statics["n_active"]
    B, S = chips.shape
    Lw = lat_tab.shape[0]
    cpos = np.maximum(chips, 0)
    cls = class_map[cpos]
    exists = np.arange(S)[None, :] < n_segs[:, None]
    hi = np.clip(last, 0, Lw - 1)
    lo = np.maximum(np.concatenate([np.full((B, 1), -1, np.int32),
                                    last[:, :-1]], 1), -1) + 1
    zero = F32(0)

    def prefix(x):
        out = blocked_cumsum(torch.from_numpy(np.array(x)))
        return np.concatenate([np.zeros((1,) + x.shape[1:], F32),
                               out.numpy()])
    slo = np.where(exists, out_bytes[hi], zero).astype(F32)
    cw = prefix(w_bytes)
    sw = np.where(exists, cw[hi + 1] - cw[lo], zero).astype(F32)
    r, c = cpos // cols, cpos % cols
    hd = np.minimum(c, cols - 1 - c).astype(F32)
    nxt = np.roll(cpos, -1, 1)
    hn = (np.abs(r - nxt // cols) + np.abs(c - nxt % cols)).astype(F32)
    busy = max(0, n_active - 1)
    d_dram = F32(pkg.contention_delta * busy / pkg.dram_bw)
    d_nop = F32(pkg.contention_delta * busy / pkg.nop_bw)
    inv_dram = F32(1) / F32(pkg.dram_bw)
    inv_nop = F32(1) / F32(pkg.nop_bw)
    hop, e12 = F32(pkg.nop_hop_lat_s), F32(1e-12)

    def dram_lat(sz, h):
        v = fma(sz, inv_dram, (h * hop).astype(F32)) + F32(pkg.dram_lat_s)
        return np.where(sz > 0, fma(sz, d_dram, v), zero).astype(F32)

    def nop_lat(sz, h):
        v = fma(sz, d_nop, fma(sz, inv_nop, (h * hop).astype(F32)))
        return np.where((sz > 0) & (h > 0), v, zero).astype(F32)

    def dram_pj(h):
        return fma(h, F32(pkg.nop_e_pj_per_bit), F32(pkg.dram_e_pj_per_bit))

    act = np.full(B, act_in, F32)
    fr, fc = cpos[:, 0] // cols, cpos[:, 0] % cols
    if statics["has_prev"]:
        pr, pc = int(prev_idx) // cols, int(prev_idx) % cols
        h0 = (np.abs(fr - pr) + np.abs(fc - pc)).astype(F32)
        add_lat = nop_lat(act, h0)
        add_e = ((act * F32(8) * F32(pkg.nop_e_pj_per_bit) * h0)
                 .astype(F32) * e12).astype(F32)
    else:
        fh = np.minimum(fc, cols - 1 - fc).astype(F32)
        add_lat = dram_lat(act, fh)
        add_e = (((act * F32(8)) * dram_pj(fh)).astype(F32) * e12)
    first = (np.arange(S) == 0)[None, :]
    is_last = np.arange(S)[None, :] == (n_segs - 1)[:, None]
    ip_lat = (dram_lat(sw, hd) + np.where(first, add_lat[:, None], zero))
    ip_e = fma(((sw * F32(8)) * dram_pj(hd)).astype(F32), e12,
               np.where(first, add_e[:, None], zero))
    op_lat = np.where(is_last, dram_lat(slo, hd), nop_lat(slo, hn))
    op_x = np.where(is_last, ((slo * F32(8)) * dram_pj(hd)).astype(F32),
                    ((slo * F32(8 * F32(pkg.nop_e_pj_per_bit))).astype(F32)
                     * hn).astype(F32))
    comm_e = fma(op_x, e12, ip_e)
    cl, ce = prefix(lat_tab), prefix(e_tab)
    seg_lat = np.where(exists, ((cl[hi + 1, cls] - cl[lo, cls]).astype(F32)
                                + (ip_lat + op_lat).astype(F32)), zero)
    seg_e = np.where(exists, (ce[hi + 1, cls] - ce[lo, cls]).astype(F32)
                     + comm_e, zero).astype(F32)
    cols_e = [seg_e[:, s] for s in range(S)]
    if halving and S in (2, 4, 8):
        while len(cols_e) > 1:
            half = len(cols_e) // 2
            cols_e = [cols_e[i] + cols_e[i + half] for i in range(half)]
        energy = cols_e[0]
    else:
        energy = np.zeros(B, F32)
        for x in cols_e:
            energy = energy + x
    lat_max = np.max(np.where(exists, seg_lat, -np.inf), 1).astype(F32)
    lat = np.where(n_segs > 1, lat_max, seg_lat.sum(1, dtype=F32))
    return np.stack([lat, energy], 1)[:b]


def quantiser_report() -> None:
    import jax
    import jax.numpy as jnp
    from repro.core.quantize import quantize_scores_jax
    from repro_torch.core.quantize import SCORE_SIG, quantize_scores_torch
    x = (10.0 ** np.random.default_rng(0).uniform(-20, 3, 200_000)
         ).astype(F32)
    want = np.asarray(jax.jit(
        lambda v: quantize_scores_jax(v, sig=SCORE_SIG))(jnp.asarray(x)))
    mult = quantize_scores_torch(torch.from_numpy(x), sig=SCORE_SIG).numpy()
    # the divide form: float64 rounds, then float32 scale, as a division
    xd = torch.from_numpy(x)
    exp = torch.floor(torch.log10(xd))
    scale = torch.from_numpy((10.0 ** (exp - SCORE_SIG).double().numpy())
                             .astype(F32))
    div = (torch.round(xd / scale) * scale).numpy()
    print(f"quantiser, 200 000 float32 scores vs jax.jit: multiply form "
          f"{int((mult != want).sum())} differ, divide form "
          f"{int((div != want).sum())} differ")


def main() -> None:
    total = np.zeros(4, int)
    lat_total = np.zeros(2, int)
    n_rows = 0
    print("batch (scenario, rows, window, model)  B  S  anchor | "
          "energy rows differing: port, divide, model seq, model halving | "
          "latency rows differing: port, divide")
    for key, args, statics, b, ref, port in reference_batches():
        ours, div = port_scores(port), divide_scores(port)
        seq = model_scores(args, statics, b, halving=False)
        halv = model_scores(args, statics, b, halving=True)
        e = [int((x[:, 1] != ref[:, 1]).sum()) for x in (ours, div, seq,
                                                         halv)]
        lt = [int((x[:, 0] != ref[:, 0]).sum()) for x in (ours, div)]
        total += e
        lat_total += lt
        n_rows += b
        print(f"{key} {b} {args[5].shape[1]} {statics['has_prev']} | "
              f"{e} | {lt}")
        if key == ("dc5_lms_seg_image_wide", 6, 0, 1):
            d = ours[:, 1].view(np.int32).astype(np.int64) \
                - ref[:, 1].view(np.int32)
            ulps, counts = np.unique(d[d != 0], return_counts=True)
            print(f"  dc5 window 0 model 1 energy ulp differences: "
                  f"{dict(zip(ulps.tolist(), counts.tolist()))}")
    print(f"all {n_rows} rows: energy differing {total.tolist()} (port, "
          f"divide, model seq, model halving); latency differing "
          f"{lat_total.tolist()} (port, divide)")
    quantiser_report()


if __name__ == "__main__":
    main()
