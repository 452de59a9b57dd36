"""Megatron sequence parallelism and the model-major expert layout against
the JAX reference, on gloo CPU ranks.

The reference reaches both through ``make_specs`` (``seq_parallel``: the
activations' sequence split over ``model`` between blocks;
``expert_axes="model_major"``: arctic-480b's expert buffers split over
``model``).  Neither changes the function GSPMD computes, so, as in
``test_torch_tensor_parallel.py``, the yardstick is the reference's
one-device function of the padded model (``ModelDims.create(cfg, tp)``)
on the same numpy weights and batches.  One spawn of 4 ranks runs every
case in ``tests/torch_sp_worker.py`` while this process runs the
reference:

* sequence parallelism for reduced qwen2.5-32b under its published name
  (FSDP, qkv biases, GQA) served at model = 2 (a prompt of 15: blocks of 8
  and 7), model = 4 (13: 4, 4, 4, 1) and on a 2 x 2 (data x model) mesh
  (FSDP gathers over data): float32 prefill logits within 5e-5 of the
  largest logit, greedy decode tokens equal (each decode step's one
  position on rank 0, the other ranks' blocks empty); trained three AdamW
  steps at model = 2, model = 4 (a sequence of 30 in blocks of 8, 8, 8, 6)
  and on 2 x 2 within ``models.testing.TRAIN_TOL``, every rank's losses and
  norms equal;
* the collectives of an SP prefill against the same prefill without it:
  per block, an all-gather and a reduce-scatter in place of each
  all-reduce, and the logits' gather of the last position;
* reduced arctic-480b under its published name in the model-major layout
  (each model rank running 4 of the 8 experts whole, the weights brought
  there by one all-to-all a leaf) served on 1 x 2 and 2 x 2 and trained on
  1 x 2 and 2 x 2 (with and without SP, the hill-climb's ``ep_mm`` and
  ``ep_mm+sp``), held the same way, and its 2 x 2 logits within 5e-5 of the
  default layout's.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from repro_torch.models.testing import TRAIN_TOL, flat_numpy, numpy_tree

sys.path.insert(0, os.path.dirname(__file__))
import torch_sp_worker as S  # noqa: E402
import torch_tp_worker as W  # noqa: E402
from test_torch_fsdp import ref_train  # noqa: E402
from test_torch_tensor_parallel import _train_errors, ref_serve  # noqa: E402

WORLD = 4
QWEN, ARCTIC = "qwen2.5-32b", "arctic-480b"
ALL = (0, 1, 2, 3)


def _serve(name, arch, shape, ranks, seq, **kw):
    return {"name": name, "kind": "serve", "arch": arch, "tp": shape[1],
            "shape": shape, "ranks": ranks, "seed": 1, "batch": 4,
            "seq": seq, "gen": 3, "full_name": True, **kw}


def _train(name, arch, shape, ranks, seq, **kw):
    return {"name": name, "kind": "train", "arch": arch, "tp": shape[1],
            "shape": shape, "ranks": ranks, "seed": 2, "batch": 4,
            "seq": seq, "accum": 1, "steps": 3, "full_name": True, **kw}


SP = {"seq_parallel": True}
MM = {"expert_axes": "model_major"}
CASES = [
    _serve("sp qwen 1x2", QWEN, (1, 2), (0, 1), 15, **SP),
    _train("train sp qwen 1x2", QWEN, (1, 2), (2, 3), 32, **SP),
    _serve("sp qwen 1x4", QWEN, (1, 4), ALL, 13, **SP),
    _serve("sp qwen 2x2", QWEN, (2, 2), ALL, 16, **SP),
    _train("train sp qwen 2x2", QWEN, (2, 2), ALL, 32, **SP),
    _train("train sp qwen 1x4", QWEN, (1, 4), ALL, 30, **SP),
    {**_serve("counts qwen 1x2", QWEN, (1, 2), (0, 1), 16), "kind": "counts"},
    _serve("mm arctic 1x2", ARCTIC, (1, 2), (3, 2), 16, **MM),
    _serve("mm arctic 2x2", ARCTIC, (2, 2), ALL, 16, **MM),
    _serve("default arctic 2x2", ARCTIC, (2, 2), ALL, 16),
    _train("train mm arctic 2x2", ARCTIC, (2, 2), ALL, 32, **MM),
    _train("train mm+sp arctic 2x2", ARCTIC, (2, 2), ALL, 32, **MM, **SP),
    _train("train mm arctic 1x2", ARCTIC, (1, 2), (0, 1), 32, **MM),
]
BY_NAME = {c["name"]: c for c in CASES}


def _ref_key(c):
    return (c["kind"], c["arch"], c["tp"], c["seq"])


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    got = {}

    def ranks():
        try:
            got["out"] = spawn(S.run, WORLD, CASES, timeout_s=240)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            got["err"] = e

    t = threading.Thread(target=ranks)
    t.start()
    ref = {}
    for c in CASES:
        key = _ref_key(c)
        if c["kind"] == "serve" and key not in ref:
            ref[key] = ref_serve(c)
        elif c["kind"] == "train" and key not in ref:
            ref[key] = ref_train(c, c["steps"])
    t.join()
    if "err" in got:
        raise got["err"]
    return {"ranks": got["out"], "ref": ref}


def _on(runs, name):
    return [r[name] for r in runs["ranks"] if name in r]


def _hold_serving(out, ref):
    scale = float(np.abs(ref["logits"]).max())
    assert out["logits"].shape == ref["logits"].shape
    err = float(np.abs(out["logits"] - ref["logits"]).max())
    assert err <= 5e-5 * scale, (err, scale)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])


SERVED = ["sp qwen 1x2", "sp qwen 1x4", "sp qwen 2x2", "mm arctic 1x2",
          "mm arctic 2x2", "default arctic 2x2"]


@pytest.mark.parametrize("name", SERVED)
def test_serving_matches_padded_reference(runs, name):
    c = BY_NAME[name]
    outs = _on(runs, name)
    assert len(outs) == len(c["ranks"])
    for out in outs:
        _hold_serving(out, runs["ref"][_ref_key(c)])
        counts = out["counts"]
        if c.get("seq_parallel"):       # the blocks' all-reduces are gone
            assert counts["sp_reduce_scatter"]["calls"] > 0
            assert "all_reduce" not in counts
        if c.get("expert_axes"):
            # 3 expert leaves a MoE layer, 2 layers, in the prefill and in
            # each of the 2 decode steps
            assert counts["expert_all_to_all"]["calls"] == 3 * 2 * 3
        else:
            assert "expert_all_to_all" not in counts


TRAINED = ["train sp qwen 1x2", "train sp qwen 2x2", "train sp qwen 1x4",
           "train mm arctic 2x2", "train mm+sp arctic 2x2",
           "train mm arctic 1x2"]


@pytest.mark.parametrize("name", TRAINED)
def test_training_matches_padded_reference(runs, name):
    c = BY_NAME[name]
    ref = runs["ref"][_ref_key(c)]
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


def test_sp_prefill_swaps_each_all_reduce_for_a_gather_and_a_scatter(runs):
    """Reduced qwen2.5-32b (2 layers, untied embedding), one prefill on 1 x
    2 with and without SP: the 4 block all-reduces (attention and MLP a
    layer) become 4 reduce-scatters and 4 all-gathers, and the head
    gathers the last position once more; the embedding's and the logits'
    vocab gathers are the same.  The logits agree to float32 rounding."""
    for out in _on(runs, "counts qwen 1x2"):
        sp, plain = out["sp"]["counts"], out["plain"]["counts"]
        assert out["sp"]["par_sp"] and not out["plain"]["par_sp"]
        assert plain["all_reduce"]["calls"] == 4
        assert "all_reduce" not in sp
        assert sp["sp_reduce_scatter"]["calls"] == 4
        assert sp["sp_all_gather"]["calls"] == 4 + 1
        assert sp["all_gather"] == plain["all_gather"]
        # a reduce-scatter hands over what the all-reduce did
        assert sp["sp_reduce_scatter"]["bytes"] == plain["all_reduce"][
            "bytes"]
        ref = out["plain"]["logits"]
        err = np.abs(out["sp"]["logits"] - ref).max()
        assert err <= 5e-5 * np.abs(ref).max()


def test_model_major_logits_meet_the_default_layouts(runs):
    mm = _on(runs, "mm arctic 2x2")
    default = _on(runs, "default arctic 2x2")
    assert len(mm) == len(default) == WORLD
    for a, b in zip(mm, default):
        err = np.abs(a["logits"] - b["logits"]).max()
        assert err <= 5e-5 * np.abs(b["logits"]).max()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
