"""Multi-pod dry-run: trace every (architecture x shape) cell on the
production meshes and record its cost, collectives and memory
(counterpart of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \
      --out results.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b \
      --shape train_4k

Results append to JSONL (one record per cell x mesh); already-recorded
cells are skipped, so the sweep is resumable after interruption.
``--full-loops`` traces every loop in full rather than from its first
steps (``analysis.trace_cost``'s loop shortcut): the same record, slower,
to check the shortcut at full width.

The reference lowers and compiles each cell for 256 or 512 emulated
devices and reads XLA's HLO (``hlo_cost``).  The port runs one process a
rank, so ``run_cell`` traces rank 0 of the mesh in one process: it opens
a fake world of the mesh's size (``torch.distributed``'s ``fake``
backend, whose collectives return at once), builds the port's
``RankMesh`` and the rank's ``Parallel``, draws its parameter shards,
optimizer state, cache and batch on ``meta`` (shapes and types, no
memory), and runs the port's own step function (``make_train_step``,
``make_prefill_step``, ``make_decode_step``) under
``analysis.trace_cost.CostTrace``.  On ``meta`` the LM kernels take their
plain versions, so a record counts the plain path: the same work the
reference's HLO counts, whose models call no Pallas kernel.  A record
holds ``cost``, ``collectives``, ``memory`` (the trace's),
``analytic_memory`` and ``trace_s`` in place of ``lower_s`` /
``compile_s``.  A 1 x 1 mesh traces the one-device path (``par=None``),
with no world.

The port's mesh execution has no Megatron sequence parallelism and no
model-major expert layout (``distributed.sharding`` has them as specs
only), so ``build_cell`` raises ``NotImplementedError`` for the
``seq_parallel`` and ``expert_axes="model_major"`` overrides rather than
trace another program.  ``long_500k`` keeps the whole KV cache on each
rank: the port's execution does not shard the cache over the sequence
(the record's ``note`` says so; ``analytic_memory`` reckons the
reference's sharded cache).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.analysis.trace_cost import CostTrace
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.launch import cells as cellmod
from repro_torch.launch.mesh import MeshSpec, RankMesh, make_production_mesh
from repro_torch.models import ModelDims, get_arch, make_train_step
from repro_torch.models.steps import make_decode_step, make_prefill_step
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.tree import tree_leaves

__all__ = ["CARD_MEMORY_BYTES", "FIT_KEY", "LOW_MEM_OPT", "accum_steps_for",
           "analytic_memory", "build_cell", "fake_world", "main", "run_cell",
           "trace"]

# bf16-moment (low-memory) optimizer for the largest models
LOW_MEM_OPT = {"arctic-480b", "llama-3.2-vision-90b", "command-r-35b",
               "qwen2.5-32b"}

# The card's memory: nvidia-smi's memory.total of an NVIDIA H100 80GB HBM3,
# 81 559 MiB.  ``analytic_memory``'s fit key is judged against it.
CARD_MEMORY_BYTES = 81559 * 2**20
FIT_KEY = "fits_h100_80g"


def analytic_memory(cell: cellmod.Cell, mesh) -> dict:
    """Per-device memory from first principles (the reference's model):
    sharded params + optimizer moments + gradient shard + KV cache + scan
    activation carry + the largest single transient (attention score chunk
    / logits chunk).  ``mesh``: anything with ``axis_names`` and
    ``devices`` (``launch.mesh.MeshSpec``).  ``FIT_KEY``: whether the total
    fits the card's memory."""
    cfg = get_arch(cell.arch)
    style = shd.style_for(cfg)
    n_dev = mesh.devices.size
    model_sz = mesh.devices.shape[-1]
    data_sz = mesh.devices.shape[-2]
    pod_sz = mesh.devices.shape[0] if len(mesh.devices.shape) == 3 else 1
    tp = model_sz if style == "tp" else 1
    dims = ModelDims.create(cfg, tp=tp)
    p_global = cfg.param_count() * 2.0              # bf16
    fsdp = cell.arch in shd.FSDP_ARCHS
    p_shards = (model_sz * data_sz if fsdp
                else (model_sz if style == "tp" else 1))
    p_dev = p_global / p_shards
    out = {"params": p_dev}
    B = cell.batch
    # batch shards over every axis that divides it (mirrors _dp_axes)
    dp = 1
    for ax_sz in ([pod_sz, data_sz] if pod_sz > 1 else [data_sz]) + \
            ([model_sz] if style == "dp" else []):
        if B % (dp * ax_sz) == 0:
            dp *= ax_sz
    B_loc = max(1, B // dp)
    d = cfg.d_model
    if cell.kind == "train":
        mom = 2 if cell.arch in LOW_MEM_OPT else 4
        out["opt_moments"] = 2 * cfg.param_count() * mom / (model_sz * data_sz
                                                            if style == "tp"
                                                            else n_dev)
        # accumulator dtype follows the optimizer's moment dtype
        out["grads"] = p_dev * (1.0 if cell.arch in LOW_MEM_OPT else 2.0)
        accum = accum_steps_for(cell, mesh)
        out["accum_steps"] = accum
        micro_b = max(1, B_loc // accum)
        B_loc = micro_b
        out["act_carry"] = cfg.n_super_blocks * B_loc * cell.seq * d * 2.0
        h_shard = model_sz if (style == "tp" or
                               (cfg.n_heads % model_sz == 0)) else 1
        h_loc = max(1, dims.n_q_pad // h_shard)
        out["attn_transient"] = (B_loc * h_loc * min(cfg.attn_q_chunk,
                                                     cell.seq) * cell.seq * 4.0
                                 if cfg.d_ff or cfg.n_heads else 0.0)
        v_loc = dims.vocab_pad / (model_sz if style == "tp" else 1)
        out["logits_chunk"] = B_loc * min(512, cell.seq) * v_loc * 4.0 * 2
    else:
        n_attn = sum(1 for k in cfg.block_pattern
                     if k.value in ("attn", "moe", "cross_attn",
                                    "shared_attn")) * cfg.n_super_blocks
        kv_heads_loc = max(1, dims.n_kv_pad // model_sz)
        kv_batch_loc = B_loc if not cell.seq_shard else 1
        kv_seq_loc = cell.seq / (data_sz if cell.seq_shard else 1)
        out["kv_cache"] = (2.0 * n_attn * kv_batch_loc * kv_seq_loc
                           * kv_heads_loc * cfg.hd * 2.0)
        if cell.kind == "prefill":
            h_shard = model_sz if (style == "tp" or
                                   (cfg.n_heads % model_sz == 0)) else 1
            h_loc = max(1, dims.n_q_pad // h_shard)
            out["attn_transient"] = (B_loc * h_loc
                                     * min(cfg.attn_q_chunk, cell.seq)
                                     * cell.seq * 4.0)
    out["total"] = sum(out.values())
    out[FIT_KEY] = bool(out["total"] < CARD_MEMORY_BYTES)
    return {k: (round(v, 1) if isinstance(v, float) else v)
            for k, v in out.items()}


def _dp_total(cell: cellmod.Cell, mesh) -> int:
    cfg = get_arch(cell.arch)
    style = shd.style_for(cfg)
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    axes = shd._dp_axes(tuple(mesh.axis_names), cell.batch, shape, style)
    dp = 1
    for a in axes:
        dp *= shape[a]
    return dp


def accum_steps_for(cell: cellmod.Cell, mesh,
                    target_micro_per_device: int | None = None) -> int:
    """Gradient-accumulation depth: microbatch ~2 sequences per device
    (1 for the 480B MoE, whose activations are the fit-limiting term)."""
    if target_micro_per_device is None:
        target_micro_per_device = 1 if cell.arch == "arctic-480b" else 2
    dp = _dp_total(cell, mesh)
    b_loc = max(1, cell.batch // dp)
    accum = max(1, b_loc // target_micro_per_device)
    while accum > 1 and (cell.batch % (accum * dp) != 0):
        accum -= 1
    return accum


@contextlib.contextmanager
def fake_world(mesh: MeshSpec):
    """Rank 0 of a fake world of the mesh's size (``torch.distributed``'s
    ``fake`` backend) with the mesh's ``RankMesh``; None for a mesh of one.
    Refuses to start inside an initialised process group, and destroys
    the fake one on the way out, whatever happened."""
    if mesh.size == 1:
        yield None
        return
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised; trace a cell in a process of its "
                           "own")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield RankMesh(mesh)
    finally:
        dist.destroy_process_group()


def build_cell(cell: cellmod.Cell, mesh: MeshSpec,
               overrides: dict | None = None, rank_mesh=None):
    """``(fn, args)``: the step function of rank 0 of ``mesh``
    (``rank_mesh``, from ``fake_world``; None: the one-device path) and its
    arguments on ``meta``.

    ``overrides`` (perf-iteration knobs, the reference's): remat_policy,
    q_chunk, moe_group, moe_capacity, accum_steps, kv_dtype; seq_parallel
    and expert_axes="model_major" raise ``NotImplementedError``.
    """
    ov = overrides or {}
    if ov.get("seq_parallel"):
        raise NotImplementedError(
            "seq_parallel: the port has no Megatron sequence-parallel "
            "execution (distributed.sharding.make_specs gives its specs "
            "only)")
    if ov.get("expert_axes", "default") != "default":
        raise NotImplementedError(
            f"expert_axes={ov['expert_axes']!r}: the port has no "
            "model-major expert execution (distributed.sharding.make_specs "
            "gives its specs only)")
    cfg = get_arch(cell.arch)
    if "q_chunk" in ov:
        cfg = dataclasses.replace(cfg, attn_q_chunk=ov["q_chunk"])
    if cfg.moe is not None and ("moe_group" in ov or "moe_capacity" in ov):
        moe = dataclasses.replace(
            cfg.moe, group_size=ov.get("moe_group", cfg.moe.group_size),
            capacity_factor=ov.get("moe_capacity",
                                   cfg.moe.capacity_factor))
        cfg = dataclasses.replace(cfg, moe=moe)
    tp = mesh.devices.shape[-1] if shd.style_for(cfg) == "tp" else 1
    dims = ModelDims.create(cfg, tp=tp)
    par = (None if rank_mesh is None
           else tpl.make_parallel(cfg, rank_mesh, cell.batch))
    shard = (None if par is None else
             lambda path, tree: tpl.shard_params(cfg, tree, par, path))
    params = cellmod.param_shapes(cfg, dims, torch.bfloat16, shard)
    binputs = cellmod.input_specs(cell)
    meta = cellmod.META
    if cell.kind == "train":
        opt = AdamWConfig(moment_dtype=torch.bfloat16
                          if cell.arch in LOW_MEM_OPT else torch.float32)
        state = (adamw.init_state(opt, params) if par is None
                 else tpl.init_opt_state(opt, params, par)[0])
        accum = ov.get("accum_steps", accum_steps_for(cell, mesh))
        fn = make_train_step(cfg, dims, opt, remat=True, accum_steps=accum,
                             remat_policy=ov.get("remat_policy", "nothing"),
                             device=meta, par=par)
        return fn, (params, state, binputs)
    if cell.kind == "prefill":
        return make_prefill_step(cfg, dims, max_cache_len=cell.seq,
                                 par=par), (params, binputs)
    kv_dtype = {"bf16": torch.bfloat16,
                "f8": torch.float8_e4m3fn}[ov.get("kv_dtype", "bf16")]
    cache = cellmod.cache_specs(cell, dims, kv_dtype, par)
    args = (params, binputs["tokens"], cache, binputs["index"])
    return make_decode_step(cfg, dims, par=par), args + (
        (binputs["cross_ctx"],) if cfg.cross_ctx_len else ())


def _storages(tree, skip: frozenset = frozenset()) -> dict[int, int]:
    """``{id: nbytes}`` of the distinct storages of a tree's tensors."""
    out: dict[int, int] = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in skip:
                out[id(st)] = st.nbytes()
    return out


def trace(fn, args: tuple, loop_shortcut: bool = True):
    """``fn(*args)`` under a ``CostTrace``: its ``CostResult`` and the
    record's ``memory`` (the arguments' distinct storages, the outputs'
    not among them, the trace's own peak, and their sum the peak a
    device holds)."""
    held = _storages(args)
    with CostTrace(loop_shortcut=loop_shortcut) as t:
        out = fn(*args)
    out_bytes = sum(_storages(out, frozenset(held)).values())
    del out
    arg_bytes = sum(held.values())
    return t.result, {"argument_bytes": int(arg_bytes),
                      "output_bytes": int(out_bytes),
                      "temp_bytes": int(t.result.peak_bytes),
                      "peak_per_device": int(arg_bytes
                                             + t.result.peak_bytes)}


def run_cell(cell: cellmod.Cell, mesh: MeshSpec, mesh_name: str,
             overrides: dict | None = None,
             loop_shortcut: bool = True) -> dict:
    """Trace rank 0's step of ``cell`` on ``mesh`` (the module note) and
    return its record; ``loop_shortcut=False`` traces every loop in full
    (``analysis.trace_cost``'s shortcut off, the same record, slower)."""
    rec = {"arch": cell.arch, "shape": cell.shape, "mesh": mesh_name,
           "kind": cell.kind}
    if overrides:
        rec["overrides"] = overrides
    rec["traced"] = (f"rank 0 of {mesh.size} on meta, the LM kernels' plain "
                     "versions")
    if cell.seq_shard and mesh.size > 1:
        rec["note"] = ("KV cache whole on each rank: the port's execution "
                       "does not shard it over the sequence")
    t0 = time.time()
    with fake_world(mesh) as rank_mesh:
        hc, rec["memory"] = trace(*build_cell(cell, mesh, overrides,
                                              rank_mesh), loop_shortcut)
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["cost"] = {"flops": hc.flops, "bytes_accessed": hc.bytes_accessed,
                   "dot_flops": hc.dot_flops}
    rec["collectives"] = {
        "operand_bytes": hc.collective_operand_bytes,
        "link_bytes": hc.collective_link_bytes,
        "by_group": hc.by_collective,
        "loops": hc.loops[:20],
        "total_bytes": hc.collective_operand_bytes,
        "total_link_bytes": hc.collective_link_bytes,
    }
    rec["analytic_memory"] = analytic_memory(cell, mesh)
    print(f"[dryrun] {cell.arch} x {cell.shape} x {mesh_name}: "
          f"trace={rec['trace_s']}s "
          f"flops/dev={rec['cost']['flops']:.3e} "
          f"peak/dev={rec['memory']['peak_per_device']/2**30:.2f}GiB "
          f"coll_link={rec['collectives']['total_link_bytes']:.3e}B",
          flush=True)
    return rec


def _cell_size_key(cell: cellmod.Cell) -> float:
    cfg = get_arch(cell.arch)
    return cfg.param_count() * (2.0 if cell.kind == "train" else 1.0) \
        + cell.batch * cell.seq * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="JSONL append path")
    ap.add_argument("--order", default="small-first",
                    choices=["small-first", "as-is"])
    ap.add_argument("--full-loops", action="store_true",
                    help="trace every loop in full (no loop shortcut)")
    args = ap.parse_args(argv)

    done: set[tuple] = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if "error" not in r:
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    todo = cellmod.all_cells()
    if args.arch:
        todo = [c for c in todo if c.arch == args.arch]
    if args.shape:
        todo = [c for c in todo if c.shape == args.shape]
    if args.order == "small-first":
        todo.sort(key=_cell_size_key)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod_16x16", make_production_mesh()))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod_2x16x16",
                       make_production_mesh(multi_pod=True)))

    n_fail = 0
    for mesh_name, mesh in meshes:
        for cell in todo:
            if (cell.arch, cell.shape, mesh_name) in done:
                continue
            try:
                rec = run_cell(cell, mesh, mesh_name,
                               loop_shortcut=not args.full_loops)
            except Exception as e:  # noqa: BLE001 - record and continue
                traceback.print_exc()
                rec = {"arch": cell.arch, "shape": cell.shape,
                       "mesh": mesh_name, "error": repr(e)[:500]}
                n_fail += 1
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    skipped = [c for c in cellmod.all_cells(include_skipped=True)
               if not cellmod.cell_valid(c)[0]]
    print(f"[dryrun] complete; {n_fail} failures; "
          f"{len(skipped)} cells skipped by validity rules:")
    for c in skipped:
        print(f"  SKIP {c.arch} x {c.shape}: {cellmod.cell_valid(c)[1]}")


if __name__ == "__main__":
    main()
