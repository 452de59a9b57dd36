"""Where the backward kernels' time goes: each bf16 kernel timed whole and
with parts of its work taken out.

Builds ``flash_attention_bwd.cu``, ``ssd_scan_bwd.cu`` and
``ssd_wide_bwd.cu`` from ``src/repro_torch/kernels/csrc`` as they are and
in variants made by editing the source text (each edit must find its
anchor, else the script fails), loads each library in turn behind the
wrappers, and prints, at zamba2-2.7b's training shapes (attention q, k, v
[4, 1024, 32, 80], causal; the SSD scan q, k [4, 1024, 80, 64] broadcast
over heads, v [4, 1024, 80, 64], chunk 256) and xlstm-350m's (the wide
scan q, k, v, dO [4, 1024, 4, 256], chunk 256, the normaliser), bf16,
seeded, each variant's device time per kernel (``torch.profiler``, 10
calls) and per call (CUDA events, 20 calls), twice in turns.  The variants
compute wrong gradients by design; only their times mean anything:

* attention ``no_products``: the wgmma loops of the score and gradient
  products emptied; ``no_elementwise``: the per-element work on the score
  tiles (exponent, mask, dS) skipped; ``neither``: both.
* SSD ``no_gate``: the gate's ex2 replaced by 1; ``no_gradient_products``:
  the register-A wgmmas (dq, dk, dv) emptied; ``no_products``: every wgmma
  of the fused kernel emptied.
* wide SSD ``no_products``: every wgmma of the states and grads kernels
  emptied; ``no_handoff``: the states chain's wait for the step before
  and its read skipped (each tile publishes its own chunk's state);
  ``hi_only``: the lo term of every split operand (gated scores, S_in,
  dS_out, the decayed k and q) left out, one product where there were
  two; ``no_gate``: the gate's ex2 replaced by 1.

Needs a CUDA device and nvcc.  Usage: python scripts/bwd_kernel_ablation.py
[flash] [ssd] [wide] (the kernels to take apart; all three by default)
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import grad as FG  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa
                                                 lse_buffer)
from repro_torch.kernels.ssd_scan import grad as SG  # noqa: E402

OUT = os.path.join(ROOT, "build", "ablation")

F_SCORES = "  for (int kk = 0; kk < Bw<DP>::kSteps; ++kk) {"
F_GRADS = ("  for (int kk = 0; kk < 4; ++kk)\n"
           "    Wgmma<DP>::rs(acc, f + 4 * kk")
F_PROBS_DQ = ("      auto probs = [&](int t) {\n"
              "        const int k0 = t * kNarrow;")
F_PROBS_DKV = ("      auto probs = [&](int t) {\n"
               "        const float* ls = sStat")
NO_PRODUCTS = [(F_SCORES, F_SCORES.replace("kk < Bw<DP>::kSteps", "kk < 0")),
               (F_GRADS, F_GRADS.replace("kk < 4", "kk < 0"))]
NO_ELEMENTWISE = [
    (F_PROBS_DQ, F_PROBS_DQ.replace("{\n", "{\n        pack_a<32>(dp, df);"
                                    " return;\n", 1)),
    (F_PROBS_DKV, F_PROBS_DKV.replace("{\n", "{\n        pack_a<32>(st, pf);"
                                      " pack_a<32>(dpt, df); return;\n", 1))]
FLASH = {"whole": [], "no_products": NO_PRODUCTS,
         "no_elementwise": NO_ELEMENTWISE,
         "neither": NO_PRODUCTS + NO_ELEMENTWISE}

S_GATE = "      const float gv = ex2(d * kLog2e);"
S_MM = "  for (int kk = 0; kk < 4; ++kk)\n    Wgmma<64>::"
S_RN = "  for (int kk = 0; kk < 4; ++kk)\n    Wgmma<64>::rs("
SSD = {"whole": [], "no_gate": [(S_GATE, "      const float gv = 1.f;")],
       "no_gradient_products": [(S_RN, S_RN.replace("kk < 4", "kk < 0"))],
       "no_products": [(S_MM, S_MM.replace("kk < 4", "kk < 0"))]}

W_NT = "  for (int kk = 0; kk < steps; ++kk)\n    Wgmma<64>::ss<0>"
W_NN = "  for (int kk = 0; kk < 4; ++kk)\n    Wgmma<64>::ss<1>"
W_RN = "  for (int kk = 0; kk < 4; ++kk)\n    Wgmma<64>::rs("
W_LO = ["    mm_rn(own, lo, y_addr, 0);\n",
        "          mm_nt(acc[q], my_do, st + nbP * kBoxBytes, kP, true);\n",
        "          mm_rn(acc[q], gl, st, q);\n",
        "        mm_nt(acc[q], v_j, st + nbP * kBoxBytes, kP, true);\n",
        "          mm_nn(acc[x], k_j, q, st + nbP * kBoxBytes, x);\n",
        "      mm_rn(acc[q], gl, y, q);\n"]
WIDE = {"whole": [],
        "no_products": [(W_NT, W_NT.replace("kk < steps", "kk < 0")),
                        (W_NN, W_NN.replace("kk < 4", "kk < 0")),
                        (W_RN, W_RN.replace("kk < 4", "kk < 0"))],
        "no_handoff": [("  if (step > 0) {", "  if (false) {")],
        "hi_only": [(lo, "") for lo in W_LO],
        "no_gate": [(S_GATE, "      const float gv = 1.f;")]}


def variant_sources(name: str, variants: dict) -> dict:
    src = (build.CSRC / f"{name}.cu").read_text()
    out = {}
    for v, edits in variants.items():
        s = src
        for old, new in edits:
            if old not in s:
                raise SystemExit(f"{name} {v}: anchor not found: {old!r}")
            s = s.replace(old, new)
        out[v] = s
    return out


def build_all(jobs: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    header = (build.CSRC / "hopper.cuh").read_text()
    with open(os.path.join(OUT, "hopper.cuh"), "w") as f:
        f.write(header)
    procs, libs = [], {}
    for key, src in jobs.items():
        cu = os.path.join(OUT, f"{key}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT, f"lib{key}.so")
        procs.append((key, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for key, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{key}: nvcc failed\n{log[-3000:]}")
        libs[key] = so
    return libs


def events_ms(fn, n: int = 20) -> float:
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


def device_ms(fn, n: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: getattr(ev, "device_time_total", 0) / n / 1e3
            for ev in prof.key_averages()
            if getattr(ev, "device_time_total", 0) > 0}


def use(module, base, path: str, attr: str) -> None:
    """Route ``module``'s wrapper (its library global ``attr``) to the
    library at ``path``."""
    lib = ctypes.CDLL(os.path.abspath(path))
    for fn in dir(base):
        if fn.startswith(("flash_attention_bwd_", "ssd_scan_bwd_",
                          "ssd_wide_bwd_")):
            f, b = getattr(lib, fn), getattr(base, fn)
            f.argtypes, f.restype = b.argtypes, b.restype
    setattr(module, attr, lib)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bwd_kernel_ablation: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    kinds = sys.argv[1:] or ["flash", "ssd", "wide"]
    sources = {"flash": ("flash_attention_bwd", FLASH),
               "ssd": ("ssd_scan_bwd", SSD), "wide": ("ssd_wide_bwd", WIDE)}
    jobs = {}
    for kind in kinds:
        name, variants = sources[kind]
        jobs.update({f"{kind}_{v}": s for v, s in
                     variant_sources(name, variants).items()})
    libs = build_all(jobs)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dt)
    q, k, v, do = (rn(4, 1024, 32, 80) for _ in range(4))
    lse = lse_buffer(q)
    o = flash_attention(q, k, v, lse=lse)
    sq = rn(4, 1024, 1, 64).expand(4, 1024, 80, 64)
    sk = rn(4, 1024, 1, 64).expand(4, 1024, 80, 64)
    sv, sdo = rn(4, 1024, 80, 64), rn(4, 1024, 80, 64)
    sa = -torch.nn.functional.softplus(rn(4, 1024, 80, dt=torch.float32))
    wq, wk, wv, wdo = (rn(4, 1024, 4, 256) for _ in range(4))
    wa = -torch.nn.functional.softplus(rn(4, 1024, 4, dt=torch.float32))
    wdd = rn(4, 1024, 4)
    calls = {"flash": (FG, FG._lib(), "_LIB", lambda: FG.flash_attention_bwd(
                 q, k, v, o, do, lse=lse)),
             "ssd": (SG, SG._lib(), "_LIB", lambda: SG.ssd_scan_bwd(
                 sq, sk, sv, sa, sdo, chunk=256)),
             "wide": (SG, SG._wide_lib(), "_WIDE_LIB", lambda: SG.ssd_wide_bwd(
                 wq, wk, wv, wa, wdo, chunk=256, dden=wdd))}
    result = {"device": smi, "runs": []}
    for turn in range(2):
        for key in (list(libs) if turn == 0 else list(libs)[::-1]):
            module, base, attr, fn = calls[key.split("_")[0]]
            use(module, base, libs[key], attr)
            result["runs"].append({"variant": key, "ms": events_ms(fn),
                                   "device_ms": device_ms(fn)})
            print(json.dumps(result["runs"][-1]), flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
