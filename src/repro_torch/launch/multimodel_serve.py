"""Multi-model serving end to end: plan three models onto a pod with the
scheduler, realize window 0's placements and run a prefill of each
(counterpart of ``examples/multimodel_serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.multimodel_serve \\
        --device cpu --reduced

The pod is the reference example's 4x2 ``het_sides`` grid under its search
settings (``n_splits=0``, ``max_nodes_per_model=4``); the requests are
minitron-8b, qwen2-moe-a2.7b and xlstm-350m at batch 4, sequence 64.  The
reference builds a sub-mesh per placement on 8 emulated host devices;
``--mesh`` does the same on 8 launched ranks, one a chip of the 4x2 pod
(``torchrun --nproc-per-node 8 -m repro_torch.launch.multimodel_serve
--mesh --reduced``); without it every placement runs on the one device at
tp = 1 (``multimodel.realize``).
``--reduced`` takes the reference's reduced configs (the example's
setting); without it the models are built at full width.  ``--device``
picks where planning and serving run (the current CUDA device by default,
raising without one).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core.scheduler import SearchConfig
from repro_torch.launch.platform import resolve_device
from repro_torch.multimodel import ServeRequest, plan, realize

REQUESTS = (("minitron-8b", 4, 64), ("qwen2-moe-a2.7b", 4, 64),
            ("xlstm-350m", 4, 64))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                    "under --mesh each rank's card)")
    ap.add_argument("--mesh", action="store_true",
                    help="realize on the launched ranks, one a chip")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import init_ranks, make_mesh
        device = init_ranks(args.device)
        mesh = make_mesh((4, 2), ("row", "col"))
        if torch.distributed.get_world_size() != mesh.size:
            raise ValueError("--mesh realizes the 4x2 pod on 8 ranks")
    else:
        device = resolve_device(args.device)
    reqs = [ServeRequest(a, batch=b, seq=s) for a, b, s in REQUESTS]
    pod = plan(reqs, rows=4, cols=2, pattern="het_sides",
               cfg=SearchConfig(metric="edp", n_splits=0,
                                max_nodes_per_model=4), device=device)
    print(f"pod plan: {len(pod.placements)} placements, "
          f"EDP={pod.outcome.edp:.4g}")
    logits = {}
    for pl_ in pod.placements:
        if pl_.window != 0:
            continue
        # one model at a time, released before the next is built
        one = dataclasses.replace(pod, placements=[pl_])
        built = realize(one, reqs, device=device,
                        reduced_archs=args.reduced, mesh=mesh)
        if not built:
            continue          # not on this rank's chips
        (dev, prefill), = built.values()
        last, _ = prefill()
        logits[pl_.arch] = last
        finite = bool(torch.isfinite(last.float()).all())
        print(f"  {pl_.arch:18s} window 0 chips={pl_.chips} "
              f"template={pl_.template} -> prefill logits "
              f"{tuple(last.shape)} on {dev} finite={finite}")
        del prefill
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print("multi-model serving placement realized and executed.")
    return {"plan": pod, "logits": logits}


if __name__ == "__main__":
    main()
