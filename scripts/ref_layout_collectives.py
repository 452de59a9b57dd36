"""The JAX reference's collectives under Megatron sequence parallelism and
the two MoE expert layouts, read from its compiled HLO on emulated CPU
devices.

For each case, ``repro.launch.dryrun.build_cell`` builds the reference's
step of a reduced config kept under its published name (so that the
sharding rules treat it as they treat the published config: FSDP for
arctic-480b and qwen2.5-32b) on a small ``(data, model)`` mesh of CPU
devices, with the overrides the hill-climb uses (``seq_parallel``,
``expert_axes="model_major"``); the step is compiled and
``repro.analysis.hlo_cost.analyze_compiled(...).by_collective`` printed:
per collective kind and group size, its count (loop trips multiplied in),
operand bytes and link bytes.  The port's counts for the same cells come
from ``repro_torch.launch.dryrun.run_cell`` (``--port``, rank 0 of a fake
world; no JAX is imported for them).

``--detail`` adds, for each case, the collectives by kind and mesh axis
(``data``, ``model``; read from the HLO's replica groups and permute
pairs, and from the port's process groups), and the largest by link
bytes with their result shapes: what each side moves, and over which
axis.

Usage (CPU only, about a minute):
  PYTHONPATH=src python scripts/ref_layout_collectives.py [--mesh 2x2]
      [--port] [--detail]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

CASES = [  # (arch, kind, overrides)
    ("arctic-480b", "train", {}),
    ("arctic-480b", "train", {"expert_axes": "model_major"}),
    ("arctic-480b", "train", {"expert_axes": "model_major",
                              "seq_parallel": True}),
    ("qwen2.5-32b", "train", {}),
    ("qwen2.5-32b", "train", {"seq_parallel": True}),
    ("qwen2.5-32b", "prefill", {"seq_parallel": True}),
]
SHAPES = {"train_s64": dict(kind="train", seq=64, batch=4),
          "prefill_s64": dict(kind="prefill", seq=64, batch=4)}


def _axis(ranks, mesh_shape: tuple) -> str:
    """The mesh axis of a group holding ``ranks`` (row-major devices of a
    ``(data, model)`` mesh)."""
    d, m = mesh_shape
    ranks = sorted(int(r) for r in ranks)
    if len(ranks) == d * m:
        return "all"
    if all(r // m == ranks[0] // m for r in ranks):
        return "model"
    if all(r % m == ranks[0] % m for r in ranks):
        return "data"
    return str(ranks)


def _hlo_group(line: str) -> list:
    """The first replica group (or permute pair) of an HLO collective."""
    import re

    import numpy as np
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", line)
    if m:
        dims = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(x) for x in m.group(4).split(",")])
        return ids.reshape(int(m.group(1)), int(m.group(2)))[0].tolist()
    m = re.search(r"(?:replica_groups|source_target_pairs)=\{\{([\d,]*)\}",
                  line)
    return [int(x) for x in m.group(1).split(",")] if m and m.group(1) \
        else []


def _detail(rows: list, top: int = 6) -> dict:
    """``rows`` of (kind, axis, shape, count, link) summed by kind and
    axis, and the ``top`` largest (kind, axis, shape) by link bytes."""
    by: dict = {}
    by_shape: dict = {}
    for kind, axis, shape, n, link in rows:
        for d, key in ((by, f"{kind} {axis}"),
                       (by_shape, (kind, axis, shape))):
            e = d.setdefault(key, [0.0, 0.0])
            e[0] += n
            e[1] += link
    return {"by_axis": {k: {"count": v[0], "link": v[1]}
                        for k, v in sorted(by.items())},
            "largest": [[*k, v[0], v[1]] for k, v in sorted(
                by_shape.items(), key=lambda kv: -kv[1][1])[:top]]}


def _summary(by: dict) -> dict:
    return {k: {"count": v["count"], "operand": v["operand"],
                "link": v["link"]} for k, v in sorted(by.items())}


def reference(mesh_shape: tuple, detail: bool = False) -> list:
    n = mesh_shape[0] * mesh_shape[1]
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={n}")
    import jax
    import numpy as np
    from repro.analysis import hlo_cost
    from repro.launch import cells as rcells
    from repro.launch import dryrun as rdry
    from repro.launch.mesh import mesh_context
    from repro.models import get_arch
    from repro.models.testing import reduced

    rcells.SHAPES.update(SHAPES)
    seen: list = []
    if detail:              # each counted collective's op and multiplicity
        stats, add = hlo_cost._collective_stats, \
            hlo_cost.CostResult.add_collective

        def op_stats(op):
            seen.append(op)
            return stats(op)

        def add_collective(self, kind, operand, link, group, mult):
            op = seen.pop()
            seen.append((kind, _axis(_hlo_group(op.line), mesh_shape),
                         ",".join(op.result_shapes), mult, link * mult))
            return add(self, kind, operand, link, group, mult)
        hlo_cost._collective_stats = op_stats
        hlo_cost.CostResult.add_collective = add_collective
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(mesh_shape),
                             ("data", "model"))
    out = []
    for arch, kind, ov in CASES:
        cfg = dataclasses.replace(reduced(get_arch(arch)), name=arch)
        rdry.get_arch = rcells.get_arch = lambda _n, c=cfg: c
        fn, args, in_sh, out_sh, donate = rdry.build_cell(
            rcells.Cell(arch, f"{kind}_s64"), mesh, ov)
        with mesh_context(mesh):
            compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                               donate_argnums=donate).lower(*args).compile()
        seen.clear()
        res = hlo_cost.analyze_compiled(compiled)
        out.append({"arch": arch, "kind": kind, "overrides": ov,
                    "by_collective": _summary(res.by_collective),
                    "link_bytes": res.collective_link_bytes})
        if detail:
            out[-1]["detail"] = _detail(seen)
    return out


def port(mesh_shape: tuple, detail: bool = False) -> list:
    import torch.distributed as dist
    from repro_torch.analysis import trace_cost
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_arch
    from repro_torch.models.testing import reduced

    cells.SHAPES.update(SHAPES)
    seen: list = []
    if detail:              # each counted collective's label, group, shape
        count = coll._count

        def counted(label, t, staged, op, group_size):
            caller = sys._getframe(1).f_locals
            group = caller.get("group") or caller["axis"].group
            size = t.numel() * t.element_size()
            kind = trace_cost._KINDS[op]
            res = (size * group_size if kind == "all-gather" else
                   size / group_size if kind == "reduce-scatter" else size)
            link = trace_cost.collective_stats(kind, float(res),
                                               group_size)[1]
            seen.append((f"{kind} [{label}]", _axis(
                dist.get_process_group_ranks(group), mesh_shape),
                f"{str(t.dtype).split('.')[-1]}{list(t.shape)}", 1, link))
            return count(label, t, staged, op, group_size)
        coll._count = counted
    mesh = make_mesh(mesh_shape, ("data", "model"))
    out = []
    for arch, kind, ov in CASES:
        cfg = dataclasses.replace(reduced(get_arch(arch)), name=arch)
        dryrun.get_arch = cells.get_arch = lambda _n, c=cfg: c
        seen.clear()
        rec = dryrun.run_cell(cells.Cell(arch, f"{kind}_s64"), mesh,
                              "x".join(map(str, mesh_shape)), ov)
        out.append({"arch": arch, "kind": kind, "overrides": ov,
                    "by_collective": _summary(
                        rec["collectives"]["by_group"]),
                    "link_bytes": rec["collectives"]["total_link_bytes"]})
        if detail:
            out[-1]["detail"] = _detail(seen)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--port", action="store_true",
                    help="the port's trace instead of the reference's HLO")
    ap.add_argument("--detail", action="store_true",
                    help="also the collectives by kind and mesh axis, and "
                    "the largest with their shapes")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.mesh.split("x"))
    rows = (port if args.port else reference)(shape, args.detail)
    for r in rows:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    sys.exit(main())
