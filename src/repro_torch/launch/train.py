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
fetches the loss once per step (its one sync).

``--mesh test|prod`` trains on a mesh of the launched ranks (``torchrun
--nproc-per-node N -m repro_torch.launch.train --mesh test ...``), as
``launch.serve`` serves: parameters padded and sharded in the ``tp`` style
(replicated in the ``dp`` style), the batch over the mesh's batch axes,
gradients summed over them and AdamW under ZeRO-1; the FSDP archs' layer
weights and moments as ``(data, model)`` blocks, each layer's weights
gathered over ``data`` in the forward and again in its recomputation, its
gradients reduce-scattered.  Checkpoints hold whole
leaves (``checkpoint.save_sharded``, written by the mesh's first rank,
synchronously), so a run resumes on another mesh of the same model axis.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data.pipeline import StepWatchdog, SyntheticLM
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch.mesh import sharded_setup
from repro_torch.launch.platform import device_fetch
from repro_torch.models import get_arch, init_params
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
                    help="torch device (default: the current CUDA device; "
                    "under --mesh each rank's card)")
    ap.add_argument("--mesh", choices=["test", "prod"], default=None,
                    help="train on a mesh of the launched ranks")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    par, device, dims, shard = sharded_setup(cfg, args.mesh, args.device,
                                             args.batch)
    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)

    params = init_params(cfg, dims, generator=torch.Generator(
        device=device).manual_seed(args.seed),
        **({"shard": shard} if shard else {}))
    if par is None:
        opt_state = adamw.init_state(opt, params)
        save_async = ckpt.save_async
    else:
        from repro_torch.distributed import sharding as shd
        from repro_torch.distributed import tensor_parallel as tpl
        opt_state, ospecs = tpl.init_opt_state(opt, params, par)
        specs = {"params": shd.param_specs(cfg, params), "opt": ospecs}

        def save_async(ckpt_dir, step, tree):
            ckpt.save_sharded(ckpt_dir, step, tree, specs, par)
    start_step = 0
    if args.ckpt_dir:
        try:
            like = {"params": params, "opt": opt_state}
            state, start_step = (
                ckpt.restore(args.ckpt_dir, like, device=device)
                if par is None else ckpt.restore_sharded(
                    args.ckpt_dir, like, specs, par, device=device))
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {start_step}")
        except FileNotFoundError:
            pass

    step_fn = make_train_step(cfg, dims, opt, accum_steps=args.accum,
                              device=device, par=par)
    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    watchdog = StepWatchdog()
    losses = []
    pending = None
    try:
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
                pending = save_async(args.ckpt_dir, step + 1,
                                     {"params": params, "opt": opt_state})
    finally:
        # a checkpoint being written when a step raises is finished first,
        # so that a restart in the same process finds it
        if pending is not None:
            pending.join()
    if args.ckpt_dir:
        if par is None:
            ckpt.save(args.ckpt_dir, args.steps,
                      {"params": params, "opt": opt_state})
        else:
            ckpt.save_sharded(args.ckpt_dir, args.steps,
                              {"params": params, "opt": opt_state}, specs,
                              par)
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "slow_steps": watchdog.slow_steps}


if __name__ == "__main__":
    main()
