"""Serving driver: prefill + batched autoregressive decode (counterpart of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu

The prefill fills the cache, then the decode step runs once per generated
token.  Every decoder architecture is served (the attention, MoE,
cross-attention, Mamba-2 and xLSTM blocks; a VLM's context is
``synth_batch``'s seeded ``cross_ctx``, handed to every decode step as the
reference does).  On the card (the default device) a prefill's attention,
self and cross, runs the ``flash_attention`` kernel and its Mamba-2 and
mLSTM scans the ``ssd_scan`` kernel; decode steps are plain torch, as in
the reference.  Weights are random, drawn on the device from a
generator seeded with ``--seed``; greedy decoding takes ``argmax`` (the
first index on a tie, as ``jnp.argmax`` does), sampling draws from a second
generator seeded with ``--seed + 1``.

``--mesh test|prod`` serves on a mesh of ranks, as the reference does
(``test``: ``launch.mesh.make_test_mesh`` over the launched ranks;
``prod``: the 16x16 production mesh, 256 ranks):

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch minitron-8b --mesh test --batch 4 --prompt-len 1024 --gen 32

The model is padded to ``tp`` = the mesh's model axis for ``tp``-style
configs (1 for ``dp``-style ones), each rank draws every layer from the
same seed and keeps its shards (``distributed.tensor_parallel``), takes its
rows of the batch, and every rank ends with the same tokens.  The FSDP
archs (qwen2.5-32b, command-r-35b, arctic-480b, llama-3.2-vision-90b)
keep each layer's weights as ``(data, model)`` blocks and gather a
layer's over ``data`` as it runs, in the prefill and in every decode
step; ``--mesh test`` on 8 ranks is ``data`` 2 x ``model`` 4.  Ranks with a
card each run NCCL; ranks that share a card (or ``--device cpu``) gloo.
Without ``--mesh`` the driver serves on one device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.launch.mesh import sharded_setup
from repro_torch.models import get_arch, init_params
from repro_torch.models.steps import make_decode_step, make_prefill_step
from repro_torch.models.testing import reduced, synth_batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                    "under --mesh each rank's card)")
    ap.add_argument("--mesh", choices=["test", "prod"], default=None,
                    help="serve on a mesh of the launched ranks")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode serving")
    par, device, dims, shard = sharded_setup(cfg, args.mesh, args.device,
                                             args.batch)
    max_len = args.prompt_len + args.gen

    with torch.inference_mode():
        params = init_params(cfg, dims, generator=torch.Generator(
            device=device).manual_seed(args.seed),
            **({"shard": shard} if shard else {}))
        batch = synth_batch(cfg, batch=args.batch, seq=args.prompt_len,
                            seed=args.seed, device=device)
        batch.pop("labels", None)
        cross = batch.get("cross_ctx")
        prefill = make_prefill_step(cfg, dims, max_cache_len=max_len,
                                    par=par)
        decode = make_decode_step(cfg, dims, par=par)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        tokens = [logits.argmax(dim=-1)[:, None]]
        _sync(device)
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sampler = torch.Generator(device=device).manual_seed(args.seed + 1)
        for i in range(args.gen - 1):
            logits, cache = decode(params, tokens[-1], cache,
                                   args.prompt_len + i, cross)
            if args.temperature > 0:
                probs = torch.softmax(logits.float() / args.temperature,
                                      dim=-1)
                nxt = torch.multinomial(probs, 1, generator=sampler)
            else:
                nxt = logits.argmax(dim=-1)[:, None]
            tokens.append(nxt)
        _sync(device)
        decode_s = time.perf_counter() - t0
    out = torch.cat(tokens, dim=1)
    tok_per_s = args.batch * (args.gen - 1) / max(decode_s, 1e-9)
    where = (f"{device}, mesh {par.mesh.spec.shape} rank {par.mesh.rank}"
             if par is not None else f"{device}")
    print(f"[serve] {cfg.name} on {where}: prefill({args.batch}x"
          f"{args.prompt_len})={prefill_s * 1e3:.1f}ms decode "
          f"{args.gen - 1} steps -> {tok_per_s:.1f} tok/s; sample tokens "
          f"{out[0, :8].tolist()}")
    return {"tokens": out, "prefill_s": prefill_s, "decode_s": decode_s}


if __name__ == "__main__":
    main()
