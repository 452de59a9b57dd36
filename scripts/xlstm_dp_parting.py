"""How far xlstm-350m's dp = 2 training run parts from the one-rank run,
as ``chip_smoke.py`` phase 16 (c) holds it, over several seeds, with the
sLSTM kernels or their plain version, from any checkout of the repo.

    python scripts/xlstm_dp_parting.py [--root CHECKOUT] [--seeds 0 1 2]
                                       [--slstm kernel|plain]

imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout).
For each seed: xlstm-350m at its published widths and depth, bf16
weights drawn from the seed, batch 4 x 1 024 of ``SyntheticLM`` at the
seed, AdamW at lr 3e-3 from the first step, three steps on the one
batch; first on two spawned ranks sharing the card at dp = 2 with ZeRO-1
(gloo), every seed, then on rank 0 alone once the other rank is done
(phase 16 (c)'s ``_xlstm_losses``; seed 0 is phase 16 (c)'s own run).
Prints each seed's losses and grad norms of both runs, the largest
relative parting of the losses (phase 16 (c) holds it to 1e-3) and of
the first grad norm (1e-2).  ``--slstm plain``
runs the model's sLSTM through ``slstm_scan_plain`` under autograd in
place of the kernels (one torch step a position; slow), to show the
parting that the other operations make alone.  Prints one JSON object
as its last line, with the card's name and power limit.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ARCH, BATCH, SEQ, STEPS = "xlstm-350m", 4, 1024, 3


def _losses(cfg, dims, par, dev, batch, seed):
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.models import init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw
    import torch
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=100)
    params = init_params(
        cfg, dims, generator=torch.Generator(device=dev).manual_seed(seed),
        dtype=torch.bfloat16, shard=None if par is None else (
            lambda path, tree: tpl.shard_params(cfg, tree, par, path)))
    state = (adamw.init_state(opt, params) if par is None
             else tpl.init_opt_state(opt, params, par)[0])
    step = make_train_step(cfg, dims, opt, remat=True, device=dev, par=par)
    losses, norms = [], []
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del params, state
    torch.cuda.empty_cache()
    return losses, norms


def rank_main(rank: int, seeds: list, slstm: str) -> dict:
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.launch.mesh import RankMesh, make_mesh
    from repro_torch.models import ModelDims, blocks, get_arch
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if slstm == "plain":
        from repro_torch.kernels.slstm import slstm_scan_plain
        blocks.slstm_scan = slstm_scan_plain
    cfg = get_arch(ARCH)
    dims = ModelDims.create(cfg)
    par = tpl.make_parallel(cfg, RankMesh(make_mesh(
        (2, 1), ("data", "model"))), BATCH)
    out = {}
    for seed in seeds:                  # the dp = 2 runs, both ranks
        t0 = time.perf_counter()
        batch = SyntheticLM(cfg, BATCH, SEQ, seed=seed).batch_at(0)
        dp, dp_g = _losses(cfg, dims, par, dev, batch, seed)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        out[seed] = {"dp2_losses": dp, "dp2_grad_norms": dp_g,
                     "dp2_wall_s": time.perf_counter() - t0}
    if rank != 0:       # rank 0 alone from here: no collective waits on it
        return out
    for seed in seeds:
        rec = out[seed]
        t0 = time.perf_counter()
        batch = SyntheticLM(cfg, BATCH, SEQ, seed=seed).batch_at(0)
        one, one_g = _losses(cfg, dims, None, dev, batch, seed)
        dp, dp_g = rec["dp2_losses"], rec["dp2_grad_norms"]
        rec.update(one_rank_losses=one, one_rank_grad_norms=one_g,
                   loss_max_rel=max(abs(a - b) / abs(b)
                                    for a, b in zip(dp, one)),
                   grad_norm_first_rel=abs(dp_g[0] - one_g[0]) / one_g[0],
                   one_rank_wall_s=time.perf_counter() - t0)
        print(f"seed {seed} ({slstm}): {rec}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--slstm", choices=("kernel", "plain"), default="kernel")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("xlstm_dp_parting: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import backend_for, spawn
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(root), \
        repro_torch.__file__
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    build.build(["flash_attention", "ssd_scan", "flash_attention_bwd",
                 "ssd_scan_bwd", "ssd_wide_bwd", "slstm"])
    ranks = spawn(rank_main, 2, args.seeds, args.slstm, timeout_s=3000,
                  backend=backend_for(torch.device("cuda"), 2))
    print(json.dumps({"root": str(root), "slstm": args.slstm,
                      "device": smi, "seeds": ranks[0]}))


if __name__ == "__main__":
    main()
