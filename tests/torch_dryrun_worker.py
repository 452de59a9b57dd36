"""The ranks' side of ``tests/test_torch_dryrun.py``: reduced dry-run cells
run for real on gloo CPU ranks (``launch.mesh.spawn``), their collectives
counted.  Imports neither JAX nor the reference.

``run(rank, cases)`` builds the 2 x 2 ``(data, model)`` mesh, then for
each case takes ``launch.dryrun.build_cell``'s step and arguments (rank
0's shapes on ``meta`` are every rank's here), puts seeded values of those
shapes on the CPU (tokens and labels below the vocab), runs the step once
and returns ``distributed.collectives.stats()`` of it.  A training step is
made again for the CPU with the accumulation depth and optimizer
``build_cell`` chose.  A case's ``overrides`` (``seq_parallel``,
``expert_axes``) go to ``build_cell`` and ``make_parallel``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import RankMesh, make_mesh
from repro_torch.models import ModelDims, get_arch
from repro_torch.models.steps import make_train_step
from repro_torch.models.testing import reduced
from repro_torch.optim import AdamWConfig

MESH = make_mesh((2, 2), ("data", "model"))
SHAPES = {"train_s32": dict(kind="train", seq=32, batch=4),
          "prefill_s32": dict(kind="prefill", seq=32, batch=4)}


def config(arch: str, full_name: bool):
    """The reduced config; ``full_name`` keeps the published name, whose
    style the sharding rules read (an FSDP arch stays FSDP)."""
    cfg = reduced(get_arch(arch))
    return dataclasses.replace(cfg, name=arch) if full_name else cfg


def use(case: dict):
    """Point the dry-run modules at the case's reduced config and the
    small shapes (the test process does the same with ``monkeypatch``)."""
    cfg = config(case["arch"], case["full_name"])
    cells.SHAPES.update(SHAPES)
    cells.get_arch = dryrun.get_arch = lambda name: cfg
    return cfg


def _values(tree, gen: torch.Generator, vocab: int):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return (torch.randn(tree.shape, generator=gen) * 0.02).to(
                tree.dtype)
        return torch.randint(0, vocab, tree.shape, generator=gen,
                             dtype=tree.dtype)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_values(x, gen, vocab) for x in tree)
    if isinstance(tree, dict):
        return {k: _values(v, gen, vocab) for k, v in tree.items()}
    return tree


def run(rank: int, cases: list) -> list:
    mesh = RankMesh(MESH)
    out = []
    for case in cases:
        cfg = use(case)
        cell = cells.Cell(case["arch"], case["shape"])
        ov = case.get("overrides", {})
        fn, args = dryrun.build_cell(cell, MESH, ov, mesh)
        args = _values(args, torch.Generator().manual_seed(rank), cfg.vocab)
        if cell.kind == "train":
            tp = MESH.axis_size("model") if shd.style_for(cfg) == "tp" else 1
            opt = AdamWConfig(moment_dtype=torch.bfloat16
                              if cfg.name in dryrun.LOW_MEM_OPT
                              else torch.float32)
            fn = make_train_step(
                cfg, ModelDims.create(cfg, tp), opt, remat=True,
                accum_steps=dryrun.accum_steps_for(cell, MESH),
                device="cpu", par=tpl.make_parallel(
                    cfg, mesh, cell.batch,
                    seq_parallel=ov.get("seq_parallel", False),
                    expert_axes=ov.get("expert_axes", "default")))
        coll.reset_stats()
        fn(*args)
        out.append(coll.stats())
    return out
