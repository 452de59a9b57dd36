"""Quick timing of the xLSTM training kernels on the card, after an edit.

Builds ``ssd_wide_bwd`` (the SSD scan's backward for wide heads and the
mLSTM's normaliser) and ``slstm`` (the sLSTM recurrence, forward and
backward) from ``src/repro_torch/kernels/csrc`` (printing ``ptxas``'s
register and spill report) and times one call of each at xlstm-350m's
training shape (batch 4, sequence 1024, 4 heads of 256, bf16) with CUDA
events over five calls, beside the plain sLSTM loop.  The kernels'
agreement with their plain versions, at these shapes and smaller ones,
and their repeated bits are the ``cuda`` tests' work:

    python -m pytest -m cuda tests/test_torch_slstm.py tests/test_torch_ssd_grad.py
    python scripts/xlstm_kernel_check.py

``chip_smoke.py`` (phase 2f) is the full check.  Needs a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch

from repro_torch.kernels import build
from repro_torch.kernels.slstm import (slstm_scan, slstm_scan_bwd,
                                       slstm_scan_plain)
from repro_torch.kernels.ssd_scan import ssd_wide_bwd

B, L, H, D, CHUNK = 4, 1024, 4, 256, 256     # xlstm-350m's training shape


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
        raise SystemExit("xlstm_kernel_check: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    build.build(["ssd_wide_bwd", "slstm"])
    print("build", time.perf_counter() - t0, build.build_seconds)
    for name, log in build.build_log.items():
        print(name, log)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    q, k, v, do = (rn(B, L, H, D, dt=bf) for _ in range(4))
    a = -torch.nn.functional.softplus(rn(B, L, H))
    dden = rn(B, L, H, dt=bf)
    print("ssd_wide_bwd ms (normaliser)", events_ms(
        lambda: ssd_wide_bwd(q, k, v, a, do, chunk=CHUNK, dden=dden)))

    gx = rn(B, L, H, 4 * D, dt=bf)
    r = (rn(H, D, 4 * D) / D ** 0.5).to(bf)
    carry = (rn(B, H, D), rn(B, H, D).abs() + 0.5, rn(B, H, D, dt=bf),
             rn(B, H, D))
    ys, _, saved = slstm_scan(gx, r, carry, save=True)
    dys = rn(B, L, H, D, dt=bf)
    dcarry = (rn(B, H, D), rn(B, H, D), rn(B, H, D, dt=bf), rn(B, H, D))
    print("slstm ms", events_ms(lambda: slstm_scan(gx, r, carry)),
          "with save", events_ms(lambda: slstm_scan(gx, r, carry,
                                                    save=True)),
          "slstm_bwd ms", events_ms(lambda: slstm_scan_bwd(
              saved[0], r, carry, saved[1:], ys, dys, dcarry)),
          "plain forward ms",
          events_ms(lambda: slstm_scan_plain(gx, r, carry), n=1))


if __name__ == "__main__":
    main()
