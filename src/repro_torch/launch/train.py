"""Training driver: config-driven, fault-tolerant, resumable (counterpart
of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
      --smoke --device cpu --steps 20 --batch 2 --seq 16 --ckpt-dir /tmp/ckpt

Without ``--device`` it trains on the card (and raises without one), where
attention and the Mamba-2 scan run the ``flash_attention`` and ``ssd_scan``
kernels forward and their backward kernels backward.  ``--smoke`` takes
the reduced config.  Weights are random, drawn from a generator seeded
with ``--seed``; batches are ``data.pipeline.SyntheticLM``'s.  The run
auto-resumes from the newest valid checkpoint under ``--ckpt-dir``, saves
asynchronously every ``--ckpt-every`` steps and once at the end, and
fetches the loss once per step (its one sync).  The reference's
``--mesh`` waits for the port of ``distributed/sharding`` and
``launch/mesh`` (ROADMAP.md, queue 1): the port trains on one device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data.pipeline import StepWatchdog, SyntheticLM
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch.platform import device_fetch, resolve_device
from repro_torch.models import ModelDims, get_arch, init_params
from repro_torch.models.steps import make_train_step
from repro_torch.models.testing import reduced
from repro_torch.optim import AdamWConfig, adamw


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="simulate a crash (fault-tolerance testing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device); "
                    "the reference's --mesh is not ported: one device")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    dims = ModelDims.create(cfg)
    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)

    params = init_params(cfg, dims, generator=torch.Generator(
        device=device).manual_seed(args.seed))
    opt_state = adamw.init_state(opt, params)
    start_step = 0
    if args.ckpt_dir:
        try:
            state, start_step = ckpt.restore(
                args.ckpt_dir, {"params": params, "opt": opt_state},
                device=device)
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {start_step}")
        except FileNotFoundError:
            pass

    step_fn = make_train_step(cfg, dims, opt, accum_steps=args.accum,
                              device=device)
    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    watchdog = StepWatchdog()
    losses = []
    pending = None
    for step in range(start_step, args.steps):
        if args.fail_at_step is not None and step == args.fail_at_step:
            raise RuntimeError(f"simulated failure at step {step}")
        batch = data.batch_at(step)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(device_fetch(metrics["loss"])[0])
        dt = time.time() - t0
        slow = watchdog.record(step, dt)
        losses.append(loss)
        if step % args.log_every == 0 or slow:
            tag = " SLOW" if slow else ""
            print(f"[train] step={step} loss={loss:.4f} "
                  f"dt={dt * 1e3:.1f}ms{tag}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save_async(args.ckpt_dir, step + 1,
                                      {"params": params, "opt": opt_state})
    if pending is not None:
        pending.join()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  {"params": params, "opt": opt_state})
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "slow_steps": watchdog.slow_steps}


if __name__ == "__main__":
    main()
