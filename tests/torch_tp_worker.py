"""The ranks' side of ``tests/test_torch_tensor_parallel.py``: the port's
sharded runs on gloo CPU ranks (``launch.mesh.spawn``).  Imports neither
JAX nor the reference, so each rank starts in about a second.

``run(rank, cases)`` builds every case's mesh on every rank (group
creation is collective over the world), then runs, in list order, the
cases whose mesh holds the rank; a ``realize`` or ``drivers`` case runs on
every rank.
Weights and batches come from seeds (``models.testing.numpy_tree`` at the
case's padded dims, ``synth_batch``), so the test process rebuilds the same
inputs for the reference.  Results are numpy, from the mesh's first rank
where every rank holds the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.launch.mesh import RankMesh, make_mesh
from repro_torch.models import ModelDims, get_arch
from repro_torch.models.convert import numpy_from_params, params_from_numpy
from repro_torch.models.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.testing import flat_numpy, numpy_tree, reduced, \
    synth_batch
from repro_torch.optim import AdamWConfig

LR = 1e-2


def config(arch: str, full_name: bool = False):
    """The reduced config in float32; ``full_name`` keeps the published
    config's name, whose style (``sharding.style_for``) the rules read:
    the reduced ones are all ``tp``-style by name."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32")
    return dataclasses.replace(cfg, name=arch) if full_name else cfg


def case_config(c: dict):
    return config(c["arch"], c.get("full_name", False))


def case_dims(c: dict) -> ModelDims:
    return ModelDims.create(case_config(c), c.get("tp", 1))


def serve_batch(c: dict) -> dict:
    """The prompt (and a VLM's context, in float32: a float32 model over a
    bf16 context keeps a bf16 cross cache in both packages)."""
    b = synth_batch(config(c["arch"]), batch=c["batch"], seq=c["seq"],
                    seed=c["seed"])
    b.pop("labels")
    if "cross_ctx" in b:
        b["cross_ctx"] = b["cross_ctx"].float()
    return b


def train_batch(c: dict, step: int) -> dict:
    """Step ``step``'s batch: the same each step, as the reference's
    ``test_sharded_train_step_on_4x2_mesh`` trains, so the loss falls."""
    b = synth_batch(config(c["arch"]), batch=c["batch"], seq=c["seq"],
                    seed=100)
    return {k: v.numpy() for k, v in b.items()}


def opt_config() -> AdamWConfig:
    return AdamWConfig(lr=LR, warmup_steps=1, total_steps=50)


def _first(mesh: RankMesh) -> bool:
    return not any(mesh.coords.values())


def _setup(c: dict, mesh: RankMesh):
    cfg = case_config(c)
    dims = case_dims(c)
    par = tpl.make_parallel(cfg, mesh, c["batch"],
                            seq_parallel=c.get("seq_parallel", False),
                            expert_axes=c.get("expert_axes", "default"))
    whole = params_from_numpy(cfg, numpy_tree(cfg, c["seed"], dims=dims),
                              device="cpu", dtype=torch.float32)
    return cfg, dims, par, tpl.shard_params(cfg, whole, par)


def serve(c: dict, mesh: RankMesh) -> dict:
    """Float32 prefill logits and greedy tokens of a sharded run."""
    cfg, dims, par, params = _setup(c, mesh)
    batch = serve_batch(c)
    with torch.inference_mode():
        logits, cache = make_prefill_step(
            cfg, dims, c["seq"] + c["gen"], par=par)(params, batch)
        decode = make_decode_step(cfg, dims, par=par)
        tokens = [logits.argmax(-1)[:, None]]
        for i in range(c["gen"] - 1):
            step_logits, cache = decode(params, tokens[-1], cache,
                                        c["seq"] + i)
            tokens.append(step_logits.argmax(-1)[:, None])
    return {"logits": logits.numpy(), "tokens": torch.cat(tokens, 1).numpy()}


def _train(c: dict, mesh: RankMesh, steps: range, params=None,
           state=None):
    cfg, dims, par, fresh = _setup(c, mesh)
    params = fresh if params is None else params
    if state is None:
        state, _ = tpl.init_opt_state(opt_config(), params, par)
    step = make_train_step(cfg, dims, opt_config(), accum_steps=c["accum"],
                           device="cpu", par=par)
    losses, norms = [], []
    for i in steps:
        params, state, m = step(params, state, train_batch(c, i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return cfg, par, params, state, losses, norms


def train(c: dict, mesh: RankMesh) -> dict:
    """Three AdamW steps: every rank's losses and norms, and the whole
    final parameters from the mesh's first rank."""
    cfg, par, params, _, losses, norms = _train(c, mesh, range(c["steps"]))
    whole = tpl.gather_tree(params, shd.param_specs(cfg, params), par)
    out = {"loss": np.asarray(losses), "grad_norm": np.asarray(norms)}
    if _first(mesh):
        out["params"] = flat_numpy(numpy_from_params(cfg, whole), "params")
    return out


def crash(c: dict, mesh: RankMesh) -> dict:
    """Steps up to ``c["crash_at"]``, a checkpoint of whole leaves, then
    the run stops."""
    cfg, par, params, state, losses, _ = _train(c, mesh,
                                                range(c["crash_at"]))
    specs = {"params": shd.param_specs(cfg, params),
             "opt": shd.opt_state_specs(cfg, params, None, par.data.size)}
    ckpt.save_sharded(c["dir"], c["crash_at"],
                      {"params": params, "opt": state}, specs, par)
    return {"loss": np.asarray(losses)}


def resume(c: dict, mesh: RankMesh) -> dict:
    """The rest of the steps from the checkpoint, on another mesh."""
    cfg, _, par, like = _setup(c, mesh)
    like_state, ospecs = tpl.init_opt_state(opt_config(), like, par)
    specs = {"params": shd.param_specs(cfg, like), "opt": ospecs}
    tree, step = ckpt.restore_sharded(
        c["dir"], {"params": like, "opt": like_state}, specs, par)
    *_, losses, _ = _train(c, mesh, range(step, c["steps"]),
                           tree["params"], tree["opt"])
    return {"loss": np.asarray(losses), "from": step}


def realize_pod(c: dict) -> dict:
    """Every rank realizes the pod plan's window 0 on the 8-rank mesh and
    runs the prefills of its placements."""
    from repro_torch.multimodel import ServeRequest, realize
    from repro_torch.multimodel.orchestrator import placement_tp
    reqs = [ServeRequest(a, b, s) for a, b, s in c["requests"]]
    mesh = make_mesh(c["shape"], ("row", "col"))
    weights = {}
    for pl in c["plan"].placements:
        cfg = config(pl.arch)
        tp = placement_tp(cfg, len(pl.chips))
        weights[pl.arch] = numpy_tree(cfg, 0, dims=ModelDims.create(cfg, tp))
    built = realize(c["plan"], reqs, device="cpu", reduced_archs=True,
                    weights=weights, dtype="float32", mesh=mesh)
    out = {}
    for arch, (sub, prefill) in built.items():
        logits, _ = prefill()
        out[arch] = {"logits": logits.numpy(), "mesh": sub.shape,
                     "ranks": sub.ranks}
    return out


def drivers(c: dict) -> dict:
    """``launch.serve`` and ``launch.train`` with ``--mesh test`` on every
    rank of the world (a 2 x 4 mesh of 8), and ``device_mesh`` over it."""
    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    dm = device_mesh(make_test_mesh(), "cpu")
    served = serve_driver.main([
        "--arch", "qwen2-moe-a2.7b", "--smoke", "--mesh", "test",
        "--device", "cpu", "--batch", "4", "--prompt-len", "8", "--gen",
        "3"])
    trained = train_driver.main([
        "--arch", "minitron-8b", "--smoke", "--mesh", "test", "--device",
        "cpu", "--steps", "2", "--batch", "4", "--seq", "8",
        "--ckpt-dir", c["dir"], "--ckpt-every", "1", "--log-every", "100"])
    return {"mesh": tuple(dm.mesh.shape), "names": dm.mesh_dim_names,
            "tokens": served["tokens"].numpy(),
            "losses": np.asarray(trained["losses"])}


KINDS = {"serve": serve, "train": train, "crash": crash, "resume": resume}
WORLD_KINDS = {"realize": realize_pod, "drivers": drivers}


def run(rank: int, cases: list) -> dict:
    meshes = [RankMesh(make_mesh(c["shape"], ("data", "model"), c["ranks"]))
              if c["kind"] not in WORLD_KINDS else None for c in cases]
    out = {}
    for c, mesh in zip(cases, meshes):
        if c["kind"] in WORLD_KINDS:
            out[c["name"]] = WORLD_KINDS[c["kind"]](c)
        elif mesh.member:
            out[c["name"]] = KINDS[c["kind"]](c, mesh)
    return out
