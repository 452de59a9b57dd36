"""Time xlstm-350m's serving calls, as ``chip_smoke.py`` phases 12 and 17
(b) make them, from any checkout of the repo.

    python scripts/serve_step_time.py [--root CHECKOUT] [--arch xlstm-350m]
                                      [--reps 20]

imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout), so
that two commits can be timed by one call on one card: unpack the other
commit with ``git archive`` into an ignored directory and run this script
once with ``--root`` pointing there and once without, in the order A B B
A.  ``--arch`` at its published widths and depth, seeded bf16 weights
(seed 17, as phase 17 (b) draws them), on the card:

* ``serve.main`` at phase 12's arguments (batch 4, prompt 1 024, 32
  greedy tokens): its prefill and decode seconds, run twice (the second
  run warm);
* the prefill of batch 4 x 1 024, and the decode steps of the
  ``decode_32k`` (batch 128, a cache of 32 768 positions) and
  ``long_500k`` (batch 1, 524 288) cells, each a call as
  ``make_prefill_step`` / ``make_decode_step`` make it: the median of
  ``--reps`` calls between CUDA events (which include the host's enqueue
  where it is the longer), the median of as many calls on the host's
  clock each ending in a synchronize, and one profiled call's device busy
  time (the sum of the device's own events) and its LM kernels' part.

Prints one JSON object as its last line, with the card's name and power
limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

SHAPES = {"prefill": ("prefill", 4, 1024), "decode_32k": ("decode", 128,
                                                          32768),
          "long_500k": ("decode", 1, 524288)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_step_time: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import ModelDims, get_arch, init_params
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_cache
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(root), \
        repro_torch.__file__
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build(["flash_attention", "ssd_scan", "slstm"])
    out = {"root": str(root), "arch": args.arch, "device": smi,
           "torch": torch.__version__, "build_s": time.perf_counter() - t0}

    runs = [serve.main(["--arch", args.arch, "--batch", "4", "--prompt-len",
                        "1024", "--gen", "32"]) for _ in range(2)]
    out["serve_prefill_s"] = [r["prefill_s"] for r in runs]
    out["serve_decode_s"] = [r["decode_s"] for r in runs]
    del runs
    torch.cuda.empty_cache()

    cfg = get_arch(args.arch)
    dims = ModelDims.create(cfg)
    g = torch.Generator(device=dev).manual_seed(17)
    params = init_params(cfg, dims, generator=g)
    for name, (kind, B, S) in SHAPES.items():
        if kind == "decode":
            cache = init_cache(cfg, dims, B, S, torch.bfloat16, dev)
            tokens = torch.randint(0, cfg.vocab, (B, 1), generator=g,
                                   device=dev)
            step = make_decode_step(cfg, dims)

            def call():
                return step(params, tokens, cache, S - 1)[0]
        else:
            tokens = torch.randint(0, cfg.vocab, (B, S), generator=g,
                                   device=dev)
            step = make_prefill_step(cfg, dims, S)

            def call():
                return step(params, {"tokens": tokens})[0]
        with torch.no_grad():
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            ev, host = [], []
            for _ in range(args.reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                ev.append(a.elapsed_time(b))
            for _ in range(args.reps):
                t = time.perf_counter()
                call()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
        by_name = collections.Counter()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                by_name[e.key[:60]] += e.self_device_time_total / 1e3
        lm = {k: v for k, v in by_name.items()
              if any(n in k for n in ("slstm", "ssd", "flash"))}
        out[name] = {"batch": B, "seq": S, "events_ms": float(np.median(ev)),
                     "host_ms": float(np.median(host)),
                     "device_busy_ms": sum(by_name.values()),
                     "lm_kernels_ms": lm}
        del tokens, step
        if kind == "decode":
            del cache
        torch.cuda.empty_cache()
        print(f"{root.name} {args.arch} {name}: {out[name]}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
