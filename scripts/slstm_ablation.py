"""Where the sLSTM kernels' time goes: ``slstm_fwd`` and ``slstm_bwd``
timed whole and with parts of their work taken out.

    python scripts/slstm_ablation.py [--parent CHECKOUT] [--turns 2]
                                     [--decode] [--cell-error]

Builds ``src/repro_torch/kernels/csrc/slstm.cu`` as it is and in variants
made by editing the source text (each edit must find its anchor, else the
script fails), loads each library in turn behind the wrappers, and
prints, at xlstm-350m's training shape (gx [4, 1024, 4, 1024], r [4, 256,
1024], bf16, seeded), each variant's time per call of the forward and of
the backward kernel (CUDA events, 5 calls after one), in turns, the order
reversed every other turn.  The first three variants compute wrong
values by design; only their times mean anything:

* ``no_product``: the gate product h r (forward) and the partial dg r^T
  (backward) taken out;
* ``no_exchange``: every st.async of the hand-off sent to the CTA itself
  (the same stores and bytes, none leaving the SM);
* ``empty_chain``: no product and no cell, only the hand-off and its wait
  (the backward keeps its barrier of the four warps): that time over the
  1 024 positions is the design's floor a position;
* ``wgmma``: the bf16 products by the four warps as a warpgroup, wgmma
  m64n8k16, in place of each warp's mma.sync m16n8k16 (the same
  registers of r, the same sums; the code is this script's, inserted
  into the source); right values;
* ``cluster16``: two warps and 16 units a CTA, a head on a cluster of 16
  (non-portable, allowed by the launcher's attribute that this variant
  adds): twice the CTAs, half the product a CTA, twice the fan-out; right
  values;
* ``library_log_tanh``: the bf16 cell's log1p of softplus and its tanh
  by the library's log1pf and tanhf (precise near 0) in place of
  __logf(1 + e) and 1 - 2 / (e^2z + 1), exp and division still the
  hardware's; right values;
* ``accurate_math``: the bf16 cell with the library's functions and IEEE
  division throughout (as float32's); right values;
* ``two_cells``: batch rows 2 t and 2 t + 1 at a lane's two columns
  whatever the tile's height, so with 4 rows or fewer half the lanes run
  two cells and half none; right values.

With ``--parent``, that checkout's ``slstm.cu`` is built as it is and
timed as the variant ``parent`` (its entry points take the same
arguments), first in even turns and last in odd ones: the pair reads
parent, whole, whole, parent over two turns.  With ``--decode``, only
``whole`` (and ``parent``) are built, and the forward is timed at the
decode steps' L = 1 (B 128, 4 and 1: xlstm-350m's decode_32k, serving
and long_500k batches): CUDA events over 50 launches after one, and the
host's enqueue time a launch (50 launches on the host's clock, then a
synchronize).  With ``--cell-error``, after the times, each variant that
computes the function runs the bf16 forward with ``save`` at r = 0, where
h r is exactly 0 and the gate inputs are gx itself, so that the carries
c, n and m after every position depend on the cell alone: at xlstm-350m's
shape
and over a long sequence of one row (B 1, L 16 384), against
``slstm_scan_plain`` (float32 torch functions), each carry's largest
error over its largest plain entry and the largest elementwise relative
error over the entries above 1e-3 of the largest.

Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.slstm import kernel as K  # noqa: E402
from repro_torch.kernels.slstm import slstm_scan, slstm_scan_bwd  # noqa

OUT = os.path.join(ROOT, "build", "ablation")

F_PRODUCT = ("      if (ks == kKSteps)\n"
             "        fwd_product<true>(acc, a, hcur, ks, lane);\n"
             "      else\n"
             "        fwd_product<false>(acc, a, hcur, ks, lane);")
B_PRODUCT = "      bwd_product(acc, a, smem_u32(dgb), tiles, lane);"
B_SYNC = ("    named_sync(1, 32 * kWarps);        "
          "// every unit's dg in the buffer")
ME = "(int)cg::this_cluster().block_rank()"
F_SEND = "st_async(mapa(la, k), pack2(hv[0], hv[1]), mapa(lb, k));"
B_DEST = "const int k = d / kUnits;"
F_CELL = "const Cell sc = cell<sizeof(T) == 2>(pre, c[j], n[j], m[j]);"
B_SAVED = "ks[j] = cell_saved<sizeof(T) == 2>(pre, cp, np, mp);"
B_CELL = ("cell_grad<sizeof(T) == 2>(ks[j], dhf, dc[j], dn[j], dm[j], "
          "dg);")
FORWARD = ("// ------------------------------- forward "
           "------------------------------------\n")
RAISED = "    if (dev < 64) raised[bwd][dev] = true;\n"
SOFTPLUS_LOG = ("(kFast ? __logf(1.f + __expf(-fabsf(x)))\n"
                "                                : log1pf(expf(-fabsf(x))))")
TANH = ("return kFast ? 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f) : "
        "tanhf(x);")
# The wgmma products: N = 8 from A in registers, B (h, or dg) in shared
# memory as [k][8 columns] bf16, MN-major core matrices of 8 k-rows x 16 B,
# a k-step's two 128 B apart; st.async's and the threads' writes (the
# generic proxy) fenced before wgmma reads them.
WGMMA_CODE = r"""
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <bool kFull>
__device__ __forceinline__ void fwd_product_wg(
    float (&s)[2][4], const uint32_t (&a)[2][kKSteps][4], uint32_t hbase,
    int ks) {
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[x][e] = 0.f;
  fence_async_smem();
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    if (kFull || kk < ks) {
      const uint64_t db = desc_plain(hbase + kk * 256, 128, 256);
      Wgmma<8>::rs(s[0], a[0][kk], db);
      Wgmma<8>::rs(s[1], a[1][kk], db);
    }
  }
  wg_commit();
  wg_wait<0>();
  fence_regs<4>(s[0]);
  fence_regs<4>(s[1]);
}
__device__ __forceinline__ void bwd_product_wg(
    float (&s)[kTilesB][4], const uint32_t (&a)[kTilesB][kKStepsB][4],
    uint32_t base, int tiles) {
#pragma unroll
  for (int i = 0; i < kTilesB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kKStepsB; ++kk) {
    const uint64_t db = desc_plain(base + kk * 256, 128, 256);
#pragma unroll
    for (int i = 0; i < kTilesB; ++i)
      if (i < tiles) Wgmma<8>::rs(s[i], a[i][kk], db);
  }
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < kTilesB; ++i) fence_regs<4>(s[i]);
}

"""
NO_PRODUCT = [(F_PRODUCT, "{}"), (B_PRODUCT, "{}")]
VARIANTS = {
    "whole": [],
    "no_product": NO_PRODUCT,
    "no_exchange": [(F_SEND, F_SEND.replace(", k)", f", {ME})")),
                    (B_DEST, f"const int k = {ME};")],
    "empty_chain": NO_PRODUCT + [
        (F_CELL, "Cell sc = {}; sc.hv = hl[j];"),
        (B_SAVED, "ks[j] = Saved{};"),
        (B_CELL, "dg[0] = dg[1] = dg[2] = dg[3] = dhf;")],
    "wgmma": [
        (FORWARD, WGMMA_CODE + FORWARD),
        (F_PRODUCT, F_PRODUCT.replace("fwd_product<", "fwd_product_wg<")
         .replace(", lane)", ")")),
        (B_SYNC, "    fence_async_smem();\n" + B_SYNC),
        (B_PRODUCT, "      bwd_product_wg(acc, a, smem_u32(dgb), tiles);")],
    "cluster16": [
        ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),
        (RAISED, RAISED + "    err = cudaFuncSetAttribute(\n        kern, "
         "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
         "    if (err != cudaSuccess) return (int)err;\n")],
    "library_log_tanh": [(SOFTPLUS_LOG, "log1pf(ex<kFast>(-fabsf(x)))"),
                         (TANH, "return tanhf(x);")],
    "accurate_math": [(x, x.replace("<sizeof(T) == 2>", "<false>"))
                      for x in (F_CELL, B_SAVED, B_CELL)],
    "two_cells": [("return tl.nb <= 4 ? tq + 4 * j : 2 * tq + j;",
                   "return 2 * tq + j;")],
}
# the variants that compute the function (the rest only time)
RIGHT = ("whole", "wgmma", "cluster16", "library_log_tanh", "accurate_math",
         "two_cells")


def libraries(parent: str | None) -> dict:
    """Each variant compiled, one ``nvcc`` each, all at once."""
    src = (build.CSRC / "slstm.cu").read_text()
    os.makedirs(OUT, exist_ok=True)
    sources = {}
    if parent:
        sources["parent"] = (Path(parent) / "src" / "repro_torch" / "kernels"
                             / "csrc" / "slstm.cu").read_text()
    for name, edits in VARIANTS.items():
        s = src
        for old, new in edits:
            if old not in s:
                raise SystemExit(f"{name}: anchor not found: {old!r}")
            s = s.replace(old, new)
        sources[name] = s
    procs = {}
    for name, s in sources.items():
        cu, so = (os.path.join(OUT, f"slstm_{name}{ext}")
                  for ext in (".cu", ".so"))
        with open(cu, "w") as fh:
            fh.write(s)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode and name in ("whole", "parent"):
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        if proc.returncode:               # the other variants are dropped
            print(f"{name}: nvcc failed, not timed\n{log}")
            continue
        out[name] = so
    return out


def events_ms(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--cell-error", action="store_true")
    args = ap.parse_args()
    if args.decode:
        for name in list(VARIANTS):
            if name != "whole":
                del VARIANTS[name]
    if not torch.cuda.is_available():
        raise SystemExit("slstm_ablation: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    libs = libraries(args.parent)
    if args.decode:
        return decode(libs, args.turns)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, L, H, dh, bf = 4, 1024, 4, 256, torch.bfloat16

    def rn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)
    gx = rn(B, L, H, 4 * dh, dt=bf)
    r = (rn(H, dh, 4 * dh) / dh ** 0.5).to(bf)
    carry = (rn(B, H, dh), rn(B, H, dh).abs() + 0.5, rn(B, H, dh, dt=bf),
             rn(B, H, dh))
    dys = rn(B, L, H, dh, dt=bf)
    names = list(libs)
    for turn in range(args.turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            use(libs[name])
            ys, _, saved = slstm_scan(gx, r, carry, save=True)
            fwd = events_ms(lambda: slstm_scan(gx, r, carry))
            bwd = events_ms(lambda: slstm_scan_bwd(
                saved[0], r, carry, saved[1:], ys, dys, (None,) * 4))
            print(f"turn {turn} {name}: slstm_fwd {fwd:.4f} ms "
                  f"({1e3 * fwd / L:.4f} us a position), slstm_bwd (with "
                  f"dr's product) {bwd:.4f} ms ({1e3 * bwd / L:.4f} us)")
    if args.cell_error:
        cell_error(libs)


def use(so: str) -> None:
    """The wrappers' library: ``so``."""
    K._LIB = None
    K.load_library = lambda _name: ctypes.CDLL(so)


def decode(libs: dict, turns: int) -> None:
    """The forward at L = 1, a launch: device (events) and host enqueue."""
    g = torch.Generator(device="cuda").manual_seed(0)
    H, dh, bf = 4, 256, torch.bfloat16
    for B in (128, 4, 1):
        gx = torch.randn(B, 1, H, 4 * dh, generator=g, device="cuda").to(bf)
        r = (torch.randn(H, dh, 4 * dh, generator=g, device="cuda")
             / dh ** 0.5).to(bf)
        carry = tuple(torch.randn(B, H, dh, generator=g, device="cuda")
                      for _ in range(4))
        carry = (carry[0], carry[1].abs() + 0.5, carry[2].to(bf), carry[3])
        names = list(libs)
        for turn in range(turns):
            for name in names if turn % 2 == 0 else names[::-1]:
                use(libs[name])
                dev_ms = events_ms(lambda: slstm_scan(gx, r, carry), n=50)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    slstm_scan(gx, r, carry)
                host_us = (time.perf_counter() - t0) / 50 * 1e6
                torch.cuda.synchronize()
                print(f"turn {turn} {name}: B {B} L 1: {1e3 * dev_ms:.1f} "
                      f"us a launch (events), host enqueue {host_us:.1f} us")


def cell_error(libs: dict) -> None:
    """The bf16 cell's carries at r = 0 against the plain version's."""
    from repro_torch.kernels.slstm import slstm_scan_plain
    g = torch.Generator(device="cuda").manual_seed(0)
    H, dh, bf = 4, 256, torch.bfloat16
    for B, L in ((4, 1024), (1, 16384)):
        gx = torch.randn(B, L, H, 4 * dh, generator=g, device="cuda").to(bf)
        r = torch.zeros(H, dh, 4 * dh, device="cuda", dtype=bf)
        carry = tuple(torch.randn(B, H, dh, generator=g, device="cuda")
                      for _ in range(4))
        carry = (carry[0], carry[1].abs() + 0.5, carry[2].to(bf), carry[3])
        _, _, ref = slstm_scan_plain(gx, r, carry, save=True)
        for name in libs:
            if name not in RIGHT:
                continue
            use(libs[name])
            _, _, got = slstm_scan(gx, r, carry, save=True)
            parts = []
            for what, k, p in zip("cnm", got[1:], ref[1:]):
                big = p.abs().max()
                diff = (k - p).abs()
                keep = p.abs() > 1e-3 * big
                elem = float((diff[keep] / p.abs()[keep]).max())
                parts.append(f"{what}: {float(diff.max() / big):.3e} of the "
                             f"largest, elementwise {elem:.3e}")
            print(f"cell error {name}: B {B} L {L} bf16 r = 0: "
                  + "; ".join(parts))


if __name__ == "__main__":
    main()
