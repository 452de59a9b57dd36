"""The ranks' side of ``tests/test_torch_seq_parallel.py``: Megatron
sequence parallelism and the model-major expert layout on gloo CPU ranks
(``launch.mesh.spawn``).  Imports neither JAX nor the reference.

``run(rank, cases)`` builds every case's ``(data, model)`` mesh on every
rank, then runs, in list order, the cases whose mesh holds the rank.  A
case's ``seq_parallel`` and ``expert_axes`` go to ``make_parallel``
(``torch_tp_worker._setup``); weights and batches come from
``torch_tp_worker``'s seeds, so the test process rebuilds them for the
reference.  Each result carries the collectives the case made, by label.
"""
from __future__ import annotations

import torch

import torch_tp_worker as W
from repro_torch.distributed import collectives as coll
from repro_torch.launch.mesh import RankMesh, make_mesh
from repro_torch.models.steps import make_prefill_step


def _counted(fn):
    def run(c: dict, mesh: RankMesh) -> dict:
        coll.reset_stats()
        out = fn(c, mesh)
        out["counts"] = coll.stats()
        return out
    return run


def prefill_counts(c: dict, mesh: RankMesh) -> dict:
    """One prefill with sequence parallelism and one without: each one's
    collectives by label, and both logits."""
    out = {}
    for sp in (True, False):
        cfg, dims, par, params = W._setup({**c, "seq_parallel": sp}, mesh)
        coll.reset_stats()
        with torch.inference_mode():
            logits, _ = make_prefill_step(cfg, dims, c["seq"],
                                          par=par)(params, W.serve_batch(c))
        out["sp" if sp else "plain"] = {"counts": coll.stats(),
                                        "logits": logits.numpy(),
                                        "par_sp": par.sp}
    return out


KINDS = {"serve": _counted(W.serve), "train": _counted(W.train),
         "counts": prefill_counts}


def run(rank: int, cases: list) -> dict:
    built: dict = {}

    def mesh_of(c):
        key = (tuple(c["shape"]), tuple(c["ranks"]))
        if key not in built:
            built[key] = RankMesh(make_mesh(key[0], ("data", "model"),
                                            key[1]))
        return built[key]
    meshes = [mesh_of(c) for c in cases]
    out = {}
    for c, mesh in zip(cases, meshes):
        if mesh.member:
            out[c["name"]] = KINDS[c["kind"]](c, mesh)
    return out
