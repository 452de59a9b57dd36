"""Tensor and data parallel execution of the port against the JAX
reference, on gloo CPU ranks.

One spawn of 8 ranks (``launch.mesh.spawn``, its own wall limit; every
process group has a 60 s timeout, so a failing rank fails the run) runs
every case in ``tests/torch_tp_worker.py``, while this process runs the
reference on one CPU device at ``ModelDims.create(cfg, tp)`` with the same
numpy weights and batches.  GSPMD makes a sharded reference step the
one-device function of the padded model, so that run is the yardstick:

* serving, reduced minitron-8b (GQA: 4 heads over 1 KV head, which tp =
  2 pads to 2) and qwen2-moe-a2.7b (MoE with a shared expert and qkv
  biases) at tp = 2 and tp = 3 (heads 4 -> 6, vocab 512 -> 513, experts 8
  -> 9, d_ff 128 split 43 / 43 / 42): float32 prefill logits within 5e-5
  of the largest logit, greedy decode tokens equal;
* serving two FSDP archs at a data axis of 1, reduced under their
  published names (the rules read the name): arctic-480b (experts whole
  on every rank, their ``d_ff`` over the model axis, the dense residual)
  and llama-3.2-vision-90b (cross-attention over a float32 context);
* training, three AdamW steps within ``models.testing.TRAIN_TOL``: reduced
  minitron-8b on a 4 x 2 mesh at tp = 2 with ``accum_steps=2`` (the
  reference's ``test_sharded_train_step_on_4x2_mesh`` setup), xlstm-350m
  at dp = 2 with ZeRO-1, qwen2-moe-a2.7b on a 2 x 2 mesh (ZeRO-1 on the
  layer axis for its biases, ``sharding.LayerP``);
* a crash at one mesh and a resume at another: reduced xlstm-350m under
  its published name (so ``dp``-style, as the published config; the
  reduced names are all ``tp``-style) saved on a 2 x 1 mesh (moments
  split over data) and resumed on a 1 x 2 one (batch over the model axis,
  moments whole) gives the clean 2 x 1 run's losses,
  ``==`` (both split the batch in two and sum over two ranks; the three
  runs share two processes, since a CPU GEMM's last bits may move with
  the alignment of its operands, which differs between processes);
* ``multimodel.realize(mesh=)`` of a 2 x 4 pod plan of the reduced
  requests on the 8 ranks: each placement's prefill against the
  reference's at its placement's tp and batch;
* the drivers with ``--mesh test`` on the 8 ranks (a 2 x 4 mesh): the
  same tokens and losses on every rank, a checkpoint of whole leaves; and
  without a card or ``--device cpu`` they raise, as the one-device
  drivers do.
"""
import dataclasses
import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models as RM
from repro.models.testing import reduced as rreduced
from repro.optim import AdamWConfig as RConfig, adamw as radamw

from repro_torch.core.scheduler import SearchConfig
from repro_torch.launch.mesh import spawn
from repro_torch.models.testing import TRAIN_TOL, flat_numpy, numpy_tree
from repro_torch.multimodel import ServeRequest, plan
from repro_torch.multimodel.orchestrator import placement_tp

sys.path.insert(0, os.path.dirname(__file__))
import torch_tp_worker as W  # noqa: E402

WORLD = 8
REQUESTS = (("minitron-8b", 4, 16), ("qwen2-moe-a2.7b", 4, 16),
            ("xlstm-350m", 4, 16))


def _serve(arch, tp, ranks, **kw):
    return {"name": f"serve {arch} tp{tp}", "kind": "serve", "arch": arch,
            "tp": tp, "shape": (1, tp), "ranks": ranks, "seed": 1,
            "batch": 4, "seq": 16, "gen": 4, **kw}


def _train(name, arch, shape, ranks, accum=1, batch=4, **kw):
    tp = shape[1] if arch != "xlstm-350m" else 1
    return {"name": name, "kind": "train", "arch": arch, "tp": tp,
            "shape": shape, "ranks": ranks, "seed": 2, "batch": batch,
            "seq": 32, "accum": accum, "steps": 3, **kw}


def cases(tmp: str, pod) -> list:
    xl = {"arch": "xlstm-350m", "tp": 1, "seed": 3, "batch": 4, "seq": 16,
          "accum": 1, "steps": 4, "crash_at": 2, "dir": tmp,
          "full_name": True}
    return [
        _serve("minitron-8b", 2, (0, 1)),
        _serve("qwen2-moe-a2.7b", 2, (2, 3)),
        _serve("minitron-8b", 3, (4, 5, 6)),
        _serve("qwen2-moe-a2.7b", 3, (7, 0, 1)),
        _serve("arctic-480b", 2, (3, 2), full_name=True),
        _serve("llama-3.2-vision-90b", 2, (6, 7), full_name=True),
        _train("train xlstm dp2", "xlstm-350m", (2, 1), (4, 5)),
        _train("train qwen2-moe 2x2", "qwen2-moe-a2.7b", (2, 2),
               (5, 6, 7, 0)),
        {**xl, "name": "clean", "kind": "train", "shape": (2, 1),
         "ranks": (2, 3), "ref": False},
        {**xl, "name": "crash", "kind": "crash", "shape": (2, 1),
         "ranks": (2, 3)},
        {**xl, "name": "resume", "kind": "resume", "shape": (1, 2),
         "ranks": (2, 3)},
        _train("train minitron 4x2", "minitron-8b", (4, 2),
               tuple(range(8)), accum=2, batch=8),
        {"name": "realize", "kind": "realize", "shape": (2, 4),
         "plan": pod, "requests": REQUESTS},
        {"name": "drivers", "kind": "drivers", "dir": tmp + "-driver"},
    ]


def _pod():
    reqs = [ServeRequest(a, b, s) for a, b, s in REQUESTS]
    pod = plan(reqs, rows=2, cols=4, pattern="het_sides",
               cfg=SearchConfig(metric="edp", n_splits=0,
                                max_nodes_per_model=4), device="cpu")
    return dataclasses.replace(pod, outcome=None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (started first, run in a thread) and the
    reference's, computed meanwhile."""
    torch.set_num_threads(1)
    pod = _pod()
    cs = cases(str(tmp_path_factory.mktemp("ckpt")), pod)
    got = {}

    def ranks():
        try:
            got["out"] = spawn(W.run, WORLD, cs, timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            got["err"] = e

    t = threading.Thread(target=ranks)
    t.start()
    ref = {c["name"]: REF[c["kind"]](c) for c in cs
           if c["kind"] in REF and c.get("ref", True)}
    t.join()
    if "err" in got:
        raise got["err"]
    return {"cases": {c["name"]: c for c in cs}, "ranks": got["out"],
            "ref": ref, "pod": pod}


# ---------------------------------------------------------------------------
# the reference, one CPU device
# ---------------------------------------------------------------------------

def _rcfg(arch):
    return dataclasses.replace(rreduced(RM.get_arch(arch)), dtype="float32")


def _jtree(c, dims=None):
    cfg = W.config(c["arch"])
    return jax.tree.map(jnp.asarray, numpy_tree(cfg, c["seed"],
                                                dims=dims or W.case_dims(c)))


def _rdims(arch, tp):
    return RM.ModelDims.create(_rcfg(arch), tp=tp)


def ref_serve(c):
    cfg, dims = _rcfg(c["arch"]), _rdims(c["arch"], c["tp"])
    params = _jtree(c)
    batch = {k: jnp.asarray(v.numpy()) for k, v in W.serve_batch(c).items()}
    logits, cache = jax.jit(lambda p, b: RM.prefill(
        cfg, dims, p, b, c["seq"] + c["gen"]))(params, batch)
    step = jax.jit(lambda p, t, ca, i: RM.decode_step(cfg, dims, p, t, ca, i))
    tokens = [jnp.argmax(logits, -1)[:, None]]
    for i in range(c["gen"] - 1):
        lg, cache = step(params, tokens[-1], cache, jnp.int32(c["seq"] + i))
        tokens.append(jnp.argmax(lg, -1)[:, None])
    return {"logits": np.asarray(logits),
            "tokens": np.asarray(jnp.concatenate(tokens, 1))}


def ref_train(c):
    cfg, dims = _rcfg(c["arch"]), _rdims(c["arch"], c["tp"])
    params = _jtree(c)
    opt = RConfig(lr=W.LR, warmup_steps=1, total_steps=50)
    state = radamw.init_state(opt, params)
    step = jax.jit(RM.make_train_step(cfg, dims, opt,
                                      accum_steps=c["accum"]))
    losses, norms = [], []
    for i in range(c["steps"]):
        params, state, m = step(params, state, jax.tree.map(
            jnp.asarray, W.train_batch(c, i)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": np.asarray(losses), "grad_norm": np.asarray(norms),
            "params": flat_numpy(jax.tree.map(np.asarray, params), "params")}


REF = {"serve": ref_serve, "train": ref_train}


def ref_realize(pod, arch, n):
    cfg = W.config(arch)
    tp = placement_tp(cfg, n)
    req = next(r for r in REQUESTS if r[0] == arch)
    batch = max(req[1], n) if tp == 1 else req[1]
    from repro_torch.models.testing import synth_batch
    b = synth_batch(cfg, batch=batch, seq=req[2], seed=0)
    b.pop("labels")
    rcfg, dims = _rcfg(arch), _rdims(arch, tp)
    params = jax.tree.map(jnp.asarray, numpy_tree(
        cfg, 0, dims=W.ModelDims.create(cfg, tp)))
    logits, _ = jax.jit(lambda p, bb: RM.prefill(rcfg, dims, p, bb, req[2]))(
        params, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    return np.asarray(logits), tp, batch


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _on(runs, name):
    """Every member rank's result of a case."""
    return [r[name] for r in runs["ranks"] if name in r]


@pytest.mark.parametrize("arch,tp", [
    ("minitron-8b", 2), ("minitron-8b", 3), ("qwen2-moe-a2.7b", 2),
    ("qwen2-moe-a2.7b", 3), ("arctic-480b", 2),
    ("llama-3.2-vision-90b", 2)])
def test_sharded_serving_matches_padded_reference(runs, arch, tp):
    name = f"serve {arch} tp{tp}"
    ref = runs["ref"][name]
    outs = _on(runs, name)
    assert len(outs) == tp
    scale = float(np.abs(ref["logits"]).max())
    for out in outs:
        assert out["logits"].shape == ref["logits"].shape
        err = float(np.abs(out["logits"] - ref["logits"]).max())
        assert err <= 5e-5 * scale, (err, scale)
        np.testing.assert_array_equal(out["tokens"], ref["tokens"])


def _train_errors(out, ref, start):
    keys = sorted(ref["params"])
    assert sorted(out["params"]) == keys
    diff = sum(float(((out["params"][k] - ref["params"][k]) ** 2).sum())
               for k in keys)
    moved = sum(float(((ref["params"][k] - start[k]) ** 2).sum())
                for k in keys)
    return {k: float(np.max(np.abs(out[k] - ref[k]) / np.abs(ref[k])))
            for k in ("loss", "grad_norm")} | {
        "params": math.sqrt(diff / moved)}


@pytest.mark.parametrize("name", ["train minitron 4x2", "train xlstm dp2",
                                  "train qwen2-moe 2x2"])
def test_sharded_training_matches_padded_reference(runs, name):
    c, ref = runs["cases"][name], runs["ref"][name]
    outs = _on(runs, name)
    assert len(outs) == len(c["ranks"])
    for out in outs[1:]:        # loss and norm the same on every rank
        np.testing.assert_array_equal(out["loss"], outs[0]["loss"])
        np.testing.assert_array_equal(out["grad_norm"], outs[0]["grad_norm"])
    first = next(o for o in outs if "params" in o)
    start = flat_numpy(numpy_tree(W.config(c["arch"]), c["seed"],
                                  dims=W.case_dims(c)), "params")
    err = _train_errors(first, ref, start)
    assert all(err[k] <= TRAIN_TOL[k] for k in TRAIN_TOL), err
    assert ref["loss"][-1] < ref["loss"][0]


def test_resume_at_another_mesh_gives_the_same_losses(runs):
    clean = _on(runs, "clean")[0]["loss"]
    crashed = _on(runs, "crash")
    resumed = _on(runs, "resume")
    assert len(crashed) == len(resumed) == 2
    for c in crashed:
        assert c["loss"].tolist() == clean[:2].tolist()
    for r in resumed:
        assert r["from"] == 2
        assert r["loss"].tolist() == clean[2:].tolist()


def test_realize_gives_each_placement_a_sub_mesh(runs):
    pod = runs["pod"]
    placed = [p for p in pod.placements if p.window == 0]
    assert placed
    seen = {}
    for rank, out in enumerate(runs["ranks"]):
        for arch, r in out["realize"].items():
            pl = next(p for p in placed if p.arch == arch)
            grid = np.arange(WORLD).reshape(2, 4)
            want = tuple(int(grid[divmod(c, 4)]) for c in pl.chips)
            assert r["ranks"] == want and rank in want
            seen.setdefault(arch, []).append(r)
    assert sorted(seen) == sorted(p.arch for p in placed)
    for pl in placed:
        n = len(pl.chips)
        ref, tp, batch = ref_realize(pod, pl.arch, n)
        outs = seen[pl.arch]
        assert len(outs) == n
        for r in outs:
            assert r["mesh"] == ((1, n) if tp > 1 else (n, 1))
            assert r["logits"].shape == (batch, ref.shape[-1])
            err = float(np.abs(r["logits"] - ref).max())
            assert err <= 5e-5 * float(np.abs(ref).max()), (pl.arch, err)


def test_drivers_on_a_mesh_of_ranks(runs):
    outs = [r["drivers"] for r in runs["ranks"]]
    assert len(outs) == WORLD
    for o in outs:
        assert o["mesh"] == (2, 4) and tuple(o["names"]) == ("data",
                                                             "model")
        assert o["tokens"].shape == (4, 3)
        np.testing.assert_array_equal(o["tokens"], outs[0]["tokens"])
        assert np.isfinite(o["losses"]).all() and len(o["losses"]) == 2
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
    from repro_torch.distributed import checkpoint as ckpt
    assert ckpt.list_steps(runs["cases"]["drivers"]["dir"]) == [1, 2]


def test_sharded_drivers_need_a_card_unless_given_the_cpu():
    from repro_torch.launch import serve as serve_driver
    from repro_torch.launch import train as train_driver
    if torch.cuda.is_available():
        pytest.skip("a card is present: the drivers would use it")
    for main in (serve_driver.main, train_driver.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--arch", "minitron-8b", "--smoke", "--mesh", "test"])

