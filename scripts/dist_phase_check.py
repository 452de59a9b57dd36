"""``chip_smoke.py``'s phase 16 alone: the port sharded over two ranks that
share the card, after an edit to ``distributed/`` or the model code.

Builds the LM kernels from ``src/repro_torch/kernels/csrc``, then runs
``chip_smoke.distributed_phase``: two spawned ranks (gloo on CUDA tensors;
NCCL where each rank has a card), gloo's CUDA probe, minitron-8b and
qwen2-moe-a2.7b served at tp = 2 at full width (float32 prefills against
one rank's), minitron-8b at its published widths trained at tp = 2 with
its depth cut, xlstm-350m trained at dp = 2 with ZeRO-1,
``compressed_psum``, and qwen2.5-32b served and trained at its published
widths over data = 2 (FSDP, its depth cut), with the same checks and
per-rank numbers as the full run, then each kernel's launches on rank 0
by path; ``--parts`` picks some of the parts (a)-(e):

    python scripts/dist_phase_check.py [--parts e]

``chip_smoke.py`` is the full check.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def main() -> None:
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="abcde",
                    help="phase 16's parts to run, of a to e")
    args = ap.parse_args()
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("dist_phase_check: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}; {smi}")
    t0 = time.perf_counter()
    build.build(["flash_attention", "ssd_scan", "flash_attention_bwd",
                 "ssd_scan_bwd", "ssd_wide_bwd", "slstm"])
    print(f"kernel build {time.perf_counter() - t0:.1f} s")
    dist = cs.distributed_phase(smi, args.parts)
    print(json.dumps({k: v for k, v in dist.items() if k != "ranks"}))
    for name in cs.lm_counts():
        print(name, cs.dist_launches(dist, name))


if __name__ == "__main__":
    main()
