"""Where the sLSTM kernels' time goes: ``slstm_fwd`` and ``slstm_bwd``
timed whole and with parts of their work taken out.

Builds ``src/repro_torch/kernels/csrc/slstm.cu`` as it is and in variants
made by editing the source text (each edit must find its anchor, else the
script fails), loads each library in turn behind the wrappers, and
prints, at xlstm-350m's training shape (gx [4, 1024, 4, 1024], r [4, 256,
1024], bf16, seeded), each variant's time per call of the forward and of
the backward kernel (CUDA events, 5 calls after one), twice in turns.  The
variants compute wrong values by design; only their times mean anything:

* ``no_product``: the gate product h r (forward) and dg r^T (backward)
  emptied;
* ``no_exchange``: each CTA writes its units' h into its own shared memory
  only (forward) and adds only its own partial (backward), in place of
  the distributed-shared-memory hand-off;
* ``no_exchange_no_sync``: that, and the per-step cluster barrier a
  block barrier.

Needs a CUDA device and nvcc.  Usage: python scripts/slstm_ablation.py
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.slstm import kernel as K  # noqa: E402
from repro_torch.kernels.slstm import slstm_scan, slstm_scan_bwd  # noqa

OUT = os.path.join(ROOT, "build", "ablation")

F_PRODUCT = "      for (int d = d_lo; d < d_hi; ++d) {"
B_PRODUCT = "      for (int l = 0; l < C; l += 2) {"
F_SEND = ("      for (int k = 0; k < kCluster; ++k) "
          "*cluster.map_shared_rank(nxt, k) = hf;")
B_GATHER = "        s += *cluster.map_shared_rank(mine + obl * dh + uu, k);"
F_SYNC = "      *nxt = hf;\n    }\n    cluster.sync();"
B_SYNC = ("        if (bl < tl.nb) mine[bl * dh + d] = acc[bl];\n    }\n"
          "    cluster.sync();")
NO_EXCHANGE = [(F_SEND, "      *nxt = hf;"),
               (B_GATHER, "        s += mine[obl * dh + uu];")]
VARIANTS = {
    "whole": [],
    "no_product": [(F_PRODUCT, F_PRODUCT.replace("d < d_hi", "d < d_lo")),
                   (B_PRODUCT, B_PRODUCT.replace("l < C", "l < 0"))],
    "no_exchange": NO_EXCHANGE,
    "no_exchange_no_sync": NO_EXCHANGE + [
        (F_SYNC, F_SYNC.replace("cluster.sync()", "__syncthreads()")),
        (B_SYNC, B_SYNC.replace("cluster.sync()", "__syncthreads()"))]}


def libraries() -> dict:
    """Each variant compiled, one ``nvcc`` each, all at once."""
    src = (build.CSRC / "slstm.cu").read_text()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        s = src
        for old, new in edits:
            if old not in s:
                raise SystemExit(f"{name}: anchor not found: {old!r}")
            s = s.replace(old, new)
        cu, so = (os.path.join(OUT, f"slstm_{name}{ext}")
                  for ext in (".cu", ".so"))
        with open(cu, "w") as fh:
            fh.write(s)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
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
    if not torch.cuda.is_available():
        raise SystemExit("slstm_ablation: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    libs = libraries()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, L, H, dh, bf = 4, 1024, 4, 256, torch.bfloat16

    def rn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)
    gx = rn(B, L, H, 4 * dh, dt=bf)
    r = (rn(H, dh, 4 * dh) / dh ** 0.5).to(bf)
    carry = (rn(B, H, dh), rn(B, H, dh).abs() + 0.5, rn(B, H, dh, dt=bf),
             rn(B, H, dh))
    dys = rn(B, L, H, dh, dt=bf)
    for turn in range(2):
        for name, so in libs.items():
            K._LIB = None
            K.load_library = lambda _name, so=so: ctypes.CDLL(so)
            ys, _, saved = slstm_scan(gx, r, carry, save=True)
            fwd = events_ms(lambda: slstm_scan(gx, r, carry))
            bwd = events_ms(lambda: slstm_scan_bwd(
                saved[0], r, carry, saved[1:], ys, dys, (None,) * 4))
            print(f"turn {turn} {name}: slstm_fwd {fwd:.4f} ms, slstm_bwd "
                  f"(with dr's product) {bwd:.4f} ms")


if __name__ == "__main__":
    main()
