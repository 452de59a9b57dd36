"""FSDP at a ``data`` axis above 1 against the JAX reference, on gloo CPU
ranks.

The four FSDP archs (``sharding.FSDP_ARCHS``) hold their layer weights as
``(data, model)`` blocks; each super-block gathers its weights over
``data`` before it runs and reduce-scatters their gradients after, as
GSPMD does for the reference, so that a sharded run computes the
reference's one-device function of the padded model
(``ModelDims.create(cfg, tp)``).  One spawn of 8 ranks
(``launch.mesh.spawn``, its own wall limit) runs every case in
``tests/torch_fsdp_worker.py``, reduced configs under their published
names so that they stay FSDP, while this process runs the reference on
one CPU device with the same numpy weights and batches:

* serving reduced qwen2.5-32b (qkv biases, GQA), arctic-480b (MoE experts
  over ``data``, their ``d_ff`` over ``model``, the dense residual) and
  llama-3.2-vision-90b (cross-attention) on 2x2 and 4x2 meshes, and
  qwen2.5-32b on 3x2 (d_model 64 in blocks of 22, 22, 20; a batch of 4
  that 3 does not divide, so ``data`` is not a batch axis): float32
  prefill logits within 5e-5 of the largest logit, greedy tokens equal;
* training, three AdamW steps within ``models.testing.TRAIN_TOL``:
  qwen2.5-32b on 4x2 with ``accum_steps=2``, arctic-480b on 2x2, and
  qwen2.5-32b on a 2x2x2 ``(pod, data, model)`` mesh (an FSDP gradient
  still needs the sum over ``pod``; in one pass, held to the 4x2 case's
  reference, since with every label valid two microbatches' mean loss is
  the batch's), every rank's losses and norms equal;
* each rank's held layer leaves and moments `==` its block of the spec;
* a checkpoint saved on 4x2 restored on 2x2, on a tp-only 1x2 mesh and
  on one device: parameters and moments gathered back `==` the saved
  leaves, and the next two losses (the second after an update that reads
  the moments) within ``TRAIN_TOL`` of the reference's;
* ``launch.serve`` and ``launch.train`` with ``--mesh test`` on the 8 ranks
  (``data`` 2, ``model`` 4, the reference's test mesh).
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models as RM
from repro.optim import AdamWConfig as RConfig, adamw as radamw

from repro_torch.launch.mesh import spawn
from repro_torch.models.testing import TRAIN_TOL, flat_numpy, numpy_tree

sys.path.insert(0, os.path.dirname(__file__))
import torch_fsdp_worker as F  # noqa: E402
import torch_tp_worker as W  # noqa: E402
from test_torch_tensor_parallel import (_jtree, _rcfg, _rdims,  # noqa: E402
                                        _train_errors, ref_serve)

WORLD = 8
ARCHS = ("qwen2.5-32b", "arctic-480b", "llama-3.2-vision-90b")
QWEN = "qwen2.5-32b"


def _serve(arch, shape, ranks):
    return {"name": f"serve {arch} {shape[0]}x{shape[1]}", "kind": "serve",
            "arch": arch, "tp": shape[1], "shape": shape, "ranks": ranks,
            "seed": 1, "batch": 4, "seq": 16, "gen": 2, "full_name": True,
            "ref": f"serve {arch}"}


def _train(name, arch, shape, ranks, **kw):
    return {"name": name, "kind": "train", "arch": arch, "tp": shape[-1],
            "shape": shape, "ranks": ranks, "seed": 2, "batch": 4,
            "seq": 32, "accum": 1, "steps": 3, "full_name": True,
            "ref": name, **kw}


def cases(tmp: str) -> list:
    q8 = dict(batch=8, accum=2)
    resume = {"arch": QWEN, "tp": 2, "seed": 2, "batch": 8, "seq": 32,
              "accum": 2, "more": 2, "full_name": True, "dir": tmp,
              "ref": "train qwen 4x2"}
    # list order is each rank's order: arctic trains on ranks 4-7 while
    # ranks 0-3 serve on 2x2 and resume the 4x2 checkpoint
    lo, hi, world = (0, 1, 2, 3), (4, 5, 6, 7), tuple(range(8))
    return [
        *[_serve(a, (4, 2), world) for a in ARCHS],
        _serve(QWEN, (3, 2), (2, 3, 4, 5, 6, 7)),
        _train("train qwen 4x2", QWEN, (4, 2), world, dir=tmp, **q8),
        _train("train qwen 2x2x2", QWEN, (2, 2, 2), world,
               axes=("pod", "data", "model"), batch=8,
               ref="train qwen 4x2"),
        _train("train arctic 2x2", "arctic-480b", (2, 2), hi),
        *[_serve(a, (2, 2), lo) for a in ARCHS],
        {**resume, "name": "resume 2x2", "kind": "resume", "shape": (2, 2),
         "ranks": lo},
        {**resume, "name": "resume 1x2", "kind": "resume", "shape": (1, 2),
         "ranks": (0, 1)},
        {**resume, "name": "resume one device", "kind": "resume_one",
         "shape": (1,), "axes": ("data",), "ranks": (2,)},
        {"name": "drivers", "kind": "drivers"},
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (started first, run in a thread) and the
    reference's, computed meanwhile."""
    torch.set_num_threads(1)
    cs = cases(str(tmp_path_factory.mktemp("ckpt")))
    got = {}

    def ranks():
        try:
            got["out"] = spawn(F.run, WORLD, cs, timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            got["err"] = e

    t = threading.Thread(target=ranks)
    t.start()
    ref = {f"serve {a}": ref_serve(_serve(a, (2, 2), ())) for a in ARCHS}
    by_name = {c["name"]: c for c in cs}
    ref["train arctic 2x2"] = ref_train(by_name["train arctic 2x2"], 3)
    ref["train qwen 4x2"] = ref_train(by_name["train qwen 4x2"], 5)
    t.join()
    if "err" in got:
        raise got["err"]
    return {"cases": by_name, "ranks": got["out"], "ref": ref}


def ref_train(c, steps):
    """``steps`` reference steps: every loss and norm, and the parameters
    after ``c["steps"]``."""
    cfg, dims = _rcfg(c["arch"]), _rdims(c["arch"], c["tp"])
    params = _jtree(c)
    opt = RConfig(lr=W.LR, warmup_steps=1, total_steps=50)
    state = radamw.init_state(opt, params)
    step = jax.jit(RM.make_train_step(cfg, dims, opt,
                                      accum_steps=c["accum"]))
    losses, norms = [], []
    for i in range(steps):
        params, state, m = step(params, state, jax.tree.map(
            jnp.asarray, W.train_batch(c, i)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i + 1 == c["steps"]:
            kept = flat_numpy(jax.tree.map(np.asarray, params), "params")
    return {"loss": np.asarray(losses), "grad_norm": np.asarray(norms),
            "params": kept}


def _on(runs, name):
    """Every member rank's result of a case."""
    return [r[name] for r in runs["ranks"] if name in r]


@pytest.mark.parametrize("arch,shape", [
    *[(a, s) for s in ("2x2", "4x2") for a in ARCHS], (QWEN, "3x2")])
def test_fsdp_serving_matches_padded_reference(runs, arch, shape):
    name = f"serve {arch} {shape}"
    c = runs["cases"][name]
    ref = runs["ref"][c["ref"]]
    outs = _on(runs, name)
    assert len(outs) == len(c["ranks"])
    scale = float(np.abs(ref["logits"]).max())
    for out in outs:
        assert out["logits"].shape == ref["logits"].shape
        err = float(np.abs(out["logits"] - ref["logits"]).max())
        assert err <= 5e-5 * scale, (err, scale)
        np.testing.assert_array_equal(out["tokens"], ref["tokens"])


@pytest.mark.parametrize("name", ["train qwen 4x2", "train arctic 2x2",
                                  "train qwen 2x2x2"])
def test_fsdp_training_matches_padded_reference(runs, name):
    c = runs["cases"][name]
    ref = runs["ref"][c["ref"]]
    outs = _on(runs, name)
    assert len(outs) == len(c["ranks"])
    assert all(o["fsdp"] == c["shape"][-2] for o in outs)
    for out in outs[1:]:        # loss and norm the same on every rank
        np.testing.assert_array_equal(out["loss"], outs[0]["loss"])
        np.testing.assert_array_equal(out["grad_norm"], outs[0]["grad_norm"])
    first = next(o for o in outs if "params" in o)
    start = flat_numpy(numpy_tree(W.config(c["arch"]), c["seed"],
                                  dims=W.case_dims(c)), "params")
    n = c["steps"]
    err = _train_errors(first, {**ref, "loss": ref["loss"][:n],
                                "grad_norm": ref["grad_norm"][:n]}, start)
    assert all(err[k] <= TRAIN_TOL[k] for k in TRAIN_TOL), err
    assert ref["loss"][n - 1] < ref["loss"][0]


@pytest.mark.parametrize("name", ["train qwen 4x2", "train arctic 2x2",
                                  "train qwen 2x2x2"])
def test_ranks_hold_only_their_blocks(runs, name):
    outs = _on(runs, name)
    for out in outs:
        assert out["held"]["checked"] > 0
        assert out["held"]["bad"] == []
    # every layer's weights are sharded over 'data': 7 dense leaves a
    # layer (wq, wk, wv, wo, wi, wg, wo), 10 with arctic's experts, and a
    # reduced config has 2 layers
    want = 20 if "arctic" in name else 14
    assert outs[0]["held"]["checked"] == want


@pytest.mark.parametrize("name", ["resume 2x2", "resume 1x2",
                                  "resume one device"])
def test_checkpoint_moves_between_meshes(runs, name):
    c = runs["cases"][name]
    ref = runs["ref"][c["ref"]]
    outs = _on(runs, name)
    assert len(outs) == len(c["ranks"])
    for out in outs:
        assert out["from"] == 3 and out["same"]
        if "fsdp" in out:
            assert out["fsdp"] == c["shape"][0]
        rel = np.abs(out["loss"] - ref["loss"][3:5]) / np.abs(
            ref["loss"][3:5])
        assert rel.max() <= TRAIN_TOL["loss"], (out["loss"], ref["loss"])


def test_drivers_run_an_fsdp_arch_on_the_test_mesh(runs):
    outs = [r["drivers"] for r in runs["ranks"]]
    assert len(outs) == WORLD
    for o in outs:
        assert o["tokens"].shape == (4, 2)
        np.testing.assert_array_equal(o["tokens"], outs[0]["tokens"])
        assert np.isfinite(o["losses"]).all() and len(o["losses"]) == 1
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        # serving: 14 layer leaves gathered in the prefill and in the
        # decode step; training: 14 in the forward, 14 recomputed
        assert o["gathers"] == (2 * 14, 28)
