"""Time the port's full-width training step, as ``chip_smoke.py`` phase 14
runs it, from any checkout of the repo.

    python scripts/train_step_time.py [--root CHECKOUT] [--arch zamba2-2.7b]
                                      [--steps 10]

imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout), so
that two commits can be timed by one call on one card: unpack the other
commit with ``git archive`` into an ignored directory and run this script
once with ``--root`` pointing there and once without, in the order A B B
A.  The model is ``--arch`` at its published widths and depth, seeded
bf16 weights, AdamW with float32 moments, remat "nothing", batch 4 x 1 024
of ``SyntheticLM`` (phase 14's ``training_setup``).  After a warm-up step,
``--steps`` steps are timed on the host's clock (each ends when its loss
and grad norm reach the host), then one more step is profiled (the
device alone): the sum of the device's own events (kernels, copies;
busy seconds) against its wall time, and the largest by name.  Prints
one JSON object as its last line, with the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_step_time: no CUDA device")
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.launch.platform import device_fetch
    from repro_torch.models import ModelDims, get_arch, init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(root), \
        repro_torch.__file__
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build(["flash_attention", "ssd_scan", "flash_attention_bwd",
                 "ssd_scan_bwd", "ssd_wide_bwd", "slstm"])
    build_s = time.perf_counter() - t0

    cfg = get_arch(args.arch)
    dims = ModelDims.create(cfg)
    params = init_params(cfg, dims, generator=torch.Generator(
        device=dev).manual_seed(0))
    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100)
    state = adamw.init_state(opt, params)
    step = make_train_step(cfg, dims, opt, remat=True,
                           remat_policy="nothing", device=dev)
    data = SyntheticLM(cfg, 4, 1024, seed=0)

    def one(i):
        nonlocal params, state
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, data.batch_at(i))
        loss, norm = device_fetch(m["loss"], m["grad_norm"])
        return time.perf_counter() - t, float(loss[()]), float(norm[()])

    warm = one(0)
    runs = [one(1 + i) for i in range(args.steps)]
    times = [r[0] for r in runs]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = one(1 + args.steps)[0]
    by_name = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:   # the device's own events
            by_name[ev.key[:60]] += ev.self_device_time_total / 1e6
    busy = sum(by_name.values())
    print(json.dumps({
        "root": str(root), "arch": args.arch, "batch": 4, "seq": 1024,
        "device": smi, "torch": torch.__version__, "build_s": build_s,
        "warmup_s": warm[0], "step_s": times,
        "median_step_s": float(np.median(times)), "min_step_s": min(times),
        "losses": [warm[1]] + [r[1] for r in runs],
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "profiled_wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1 - busy / wall,
        "top_device_s": by_name.most_common(8)}))


if __name__ == "__main__":
    main()
