"""The ranks' side of ``tests/test_torch_fsdp.py``: the FSDP archs sharded
over ``(data, model)`` on gloo CPU ranks (``launch.mesh.spawn``).  Imports
neither JAX nor the reference.

``run(rank, cases)`` builds every case's mesh on every rank (its axes
``c["axes"]``, default ``(data, model)``), then runs, in list order, the
cases whose mesh holds the rank; a ``drivers`` case runs on every rank.
Configs are reduced under their published names (``torch_tp_worker.config(
..., full_name=True)``), which the sharding rules read, so that they stay
FSDP; weights and batches come from ``torch_tp_worker``'s seeds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import torch_tp_worker as W
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.launch.mesh import RankMesh, make_mesh
from repro_torch.models.convert import numpy_from_params, params_from_numpy
from repro_torch.models.steps import make_train_step
from repro_torch.models.testing import flat_numpy, numpy_tree, reduced
from repro_torch.optim import adamw


def _whole(c: dict):
    cfg = W.case_config(c)
    return params_from_numpy(cfg, numpy_tree(cfg, c["seed"],
                                             dims=W.case_dims(c)),
                             device="cpu", dtype=torch.float32)


def _block(n: int, entry, mesh: RankMesh) -> int:
    """The length of this rank's block of a dimension of n under a spec
    entry, from the mesh's coordinates (``ceil(n / k)`` blocks, the last
    shorter)."""
    if entry is None:
        return n
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    k, r = 1, 0
    for name in mesh.spec.axis_names:
        if name in names:
            size = mesh.spec.axis_size(name)
            k, r = k * size, r * size + mesh.coords[name]
    c = -(-n // k)
    return max(0, min(c, n - r * c))


def held(c: dict, mesh: RankMesh, params, state) -> dict:
    """Each layer leaf sharded over 'data': the parameter and both moments
    this rank holds against the block its spec gives it of the whole leaf
    (``{"checked": n, "bad": [...]}``)."""
    cfg = W.case_config(c)
    pspecs = shd.param_specs(cfg, params)
    found = {"checked": 0, "bad": []}

    def one(path, whole, spec, p, mu, nu):
        if path[0] != "layers" or "data" not in spec.axes():
            return
        entries = list(spec) + [None] * (whole.dim() - len(spec))
        want = tuple(_block(n, e, mesh) for n, e in zip(whole.shape,
                                                        entries))
        got = [tuple(t.shape) for t in (p, mu, nu)]
        found["checked"] += 1
        if any(g != want for g in got):
            found["bad"].append(("/".join(path), want, got))
    shd._map_paths(one, _whole(c), pspecs, params, state["mu"],
                   state["nu"])
    return found


def train(c: dict, mesh: RankMesh) -> dict:
    """``c["steps"]`` AdamW steps: every rank's losses, norms and held
    shapes, and the whole final parameters from the mesh's first rank;
    with ``c["dir"]`` a checkpoint of the parameters and moments, whose
    parameters are the ones returned."""
    cfg, par, params, state, losses, norms = W._train(c, mesh,
                                                      range(c["steps"]))
    specs = {"params": shd.param_specs(cfg, params),
             "opt": shd.opt_state_specs(cfg, params, None, par.data.size)}
    out = {"loss": np.asarray(losses), "grad_norm": np.asarray(norms),
           "held": held(c, mesh, params, state), "fsdp": par.fsdp.size}
    if c.get("dir"):
        tree = {"params": params, "opt": state}
        ckpt.save_sharded(c["dir"], c["steps"], tree, specs, par)
        whole = (ckpt.restore(c["dir"], tree)[0]["params"]
                 if W._first(mesh) else None)
    else:
        whole = tpl.gather_tree(params, specs["params"], par)
    if W._first(mesh):
        out["params"] = flat_numpy(numpy_from_params(cfg, whole), "params")
    return out


def _same_as_saved(c: dict, whole) -> bool:
    """Whether whole leaves (gathered after a restore) are the saved
    checkpoint's, bit for bit."""
    saved, _ = ckpt.restore(c["dir"], whole)
    from repro_torch.optim.tree import tree_leaves
    return all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(whole), tree_leaves(saved)))


def resume(c: dict, mesh: RankMesh) -> dict:
    """The checkpoint restored on another mesh (FSDP or tp only): its
    parameters and moments gathered back `==` the saved leaves, then
    ``c["more"]`` steps' losses."""
    cfg, _, par, like = W._setup(c, mesh)
    like_state, ospecs = tpl.init_opt_state(W.opt_config(), like, par)
    specs = {"params": shd.param_specs(cfg, like), "opt": ospecs}
    tree, step = ckpt.restore_sharded(
        c["dir"], {"params": like, "opt": like_state}, specs, par)
    same = _same_as_saved(c, tpl.gather_tree(tree, specs, par))
    *_, losses, _ = W._train(c, mesh, range(step, step + c["more"]),
                             tree["params"], tree["opt"])
    return {"loss": np.asarray(losses), "from": step, "same": same,
            "fsdp": par.fsdp.size}


def resume_one(c: dict, mesh: RankMesh) -> dict:
    """The checkpoint restored on one device (no mesh) and ``c["more"]``
    steps of the one-device train step."""
    cfg, dims = W.case_config(c), W.case_dims(c)
    like = _whole(c)
    tree, step = ckpt.restore(c["dir"], {
        "params": like, "opt": adamw.init_state(W.opt_config(), like)})
    same = _same_as_saved(c, tree)
    fn = make_train_step(cfg, dims, W.opt_config(), accum_steps=c["accum"],
                         device="cpu")
    params, state, losses = tree["params"], tree["opt"], []
    for i in range(step, step + c["more"]):
        params, state, m = fn(params, state, W.train_batch(c, i))
        losses.append(float(m["loss"]))
    return {"loss": np.asarray(losses), "from": step, "same": same}


def drivers(c: dict) -> dict:
    """``launch.serve`` and ``launch.train`` with ``--mesh test`` on every
    rank of the world (a 2 x 4 ``(data, model)`` mesh of 8) for
    reduced qwen2.5-32b under its published name (``--smoke`` renames the
    config, which makes it ``tp``-style in both packages, so the drivers'
    ``reduced`` keeps the name here), with the FSDP gathers they made."""
    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver

    def keep_name(cfg):
        return dataclasses.replace(reduced(cfg), name=cfg.name)
    serve_driver.reduced = train_driver.reduced = keep_name
    try:
        coll.reset_stats()
        served = serve_driver.main([
            "--arch", "qwen2.5-32b", "--smoke", "--mesh", "test",
            "--device", "cpu", "--batch", "4", "--prompt-len", "8",
            "--gen", "2"])
        serve_gathers = coll.stats().get("fsdp_all_gather", {})
        coll.reset_stats()
        trained = train_driver.main([
            "--arch", "qwen2.5-32b", "--smoke", "--mesh", "test",
            "--device", "cpu", "--steps", "1", "--batch", "4", "--seq",
            "8", "--log-every", "100"])
        train_gathers = coll.stats().get("fsdp_all_gather", {})
    finally:
        serve_driver.reduced = train_driver.reduced = reduced
    return {"tokens": served["tokens"].numpy(),
            "losses": np.asarray(trained["losses"]),
            "gathers": (serve_gathers.get("calls", 0),
                        train_gathers.get("calls", 0))}


KINDS = {"serve": W.serve, "train": train, "resume": resume,
         "resume_one": resume_one}
WORLD_KINDS = {"drivers": drivers}


def run(rank: int, cases: list) -> dict:
    built: dict = {}     # one RankMesh (its process groups) a mesh

    def mesh_of(c):
        key = (tuple(c["shape"]), c.get("axes", ("data", "model")),
               tuple(c["ranks"]))
        if key not in built:
            built[key] = RankMesh(make_mesh(*key))
        return built[key]
    meshes = [mesh_of(c) if c["kind"] not in WORLD_KINDS else None
              for c in cases]
    out = {}
    for c, mesh in zip(cases, meshes):
        if c["kind"] in WORLD_KINDS:
            out[c["name"]] = WORLD_KINDS[c["kind"]](c)
        elif mesh.member:
            out[c["name"]] = KINDS[c["kind"]](c, mesh)
    return out

