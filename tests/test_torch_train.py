"""The port's training path against the JAX reference, on the CPU.

Reduced configs (``models.testing.reduced``) in float32 with the same numpy
weights (``numpy_tree``) and batches on both sides:

* ``loss_fn`` and its gradient for every reduced config against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, with masked
  labels and two loss chunks: zamba2 (Mamba-2 and the shared attention:
  both kernels' Functions), gemma-7b (attention, GeGLU, tied embeddings),
  hubert-xlarge (frames, not causal), qwen2-moe-a2.7b (routed and shared
  experts), arctic-480b (the dense residual), xlstm-350m (mLSTM with its
  normaliser, sLSTM), minitron-8b (GQA) and llama-3.2-vision-90b (the
  cross blocks, ``xgate`` nonzero, over a float32 context: training takes
  attention through ``FlashAttentionFn``, whose forward keeps the
  probabilities float32 where the reference's ``_sdpa`` rounds them to a
  bf16 context's type, so a bf16 context would depart from the reference
  by bf16 rounding, not float32's).  Tolerances: the loss to 1e-6
  relative; each gradient leaf to ``5e-5 * max |reference gradient|`` (the
  whole-model rule of ``tests/test_torch_models.py``; zamba2 reads
  8.5e-6);
* the four remat settings give the same gradients, bit for bit (the same
  operations recomputed);
* ``make_train_step`` from parameters and AdamW state carried over from
  the reference after one of its steps, three more steps each side (lr
  1e-3): losses to 1e-5 relative, grad norms to 1e-4 relative, parameters
  and moments to 1e-3 of their reference's L2 norm of change (Adam's
  first steps divide by each gradient's own size, so an entry whose
  gradient is near zero moves on a last-bit difference: 3.2e-4 at most
  here, in a few entries; ``models.testing.TRAIN_TOL`` says more); and
  ``accum_steps=2`` against the reference's ``accum_steps=2`` and the
  port's ``accum_steps=1``;
* ``SyntheticLM`` bit for bit the reference's, resumable by step;
  ``StepWatchdog``; the reference's checkpoint tests ported, with a bf16
  round trip and ``save_async``; the train driver's crash and resume
  ``==`` a clean run (``tests/test_distributed.py::
  test_train_driver_failure_recovery``'s port);
* the entry points raise without a card unless given the CPU.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models as RM
from repro.data.pipeline import StepWatchdog as RWatchdog, \
    SyntheticLM as RSynthetic
from repro.models.testing import reduced as ref_reduced
from repro.optim import AdamWConfig as RConfig, adamw as radamw

import repro_torch.models as TM
from repro_torch.data.pipeline import StepWatchdog, SyntheticLM
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.models.convert import (numpy_from_params,
                                        opt_state_from_numpy,
                                        params_from_numpy)
from repro_torch.models.steps import (batch_to_device, loss_and_grads,
                                      make_eval_step, make_train_step)
from repro_torch.models.testing import flat_numpy, numpy_tree, reduced
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.tree import tree_leaves

CPU = torch.device("cpu")
B, S, LOSS_CHUNK = 2, 32, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite's test
    workers share the cores, and torch's default pool (a thread per core
    in each worker) oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """One reduced architecture in both packages, float32, same weights."""

    def __init__(self, arch):
        self.cfg = dataclasses.replace(reduced(TM.get_arch(arch)),
                                       dtype="float32")
        self.jcfg = dataclasses.replace(ref_reduced(RM.get_arch(arch)),
                                        dtype="float32")
        self.dims = TM.ModelDims.create(self.cfg)
        self.jdims = RM.ModelDims.create(self.jcfg, tp=1)
        self.tree = numpy_tree(self.cfg, 0)

    def params(self):
        return params_from_numpy(self.cfg, self.tree, device=CPU,
                                 dtype=torch.float32)

    def batch(self, seed=3):
        rng = np.random.default_rng(seed)
        out = {}
        if self.cfg.frontend_stub:
            out["frames"] = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
        else:
            out["tokens"] = rng.integers(0, self.cfg.vocab, (B, S)).astype(
                np.int32)
        labels = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        labels[0, :3] = -1                               # masked
        out["labels"] = labels
        if self.cfg.cross_ctx_len:
            out["cross_ctx"] = rng.standard_normal(
                (B, self.cfg.cross_ctx_len, self.cfg.d_model)).astype(
                    np.float32)
        return out


def ref_value_and_grad(pair, batch, **kw):
    jp = jax.tree.map(jnp.asarray, pair.tree)
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: RM.loss_fn(
        pair.jcfg, pair.jdims, p, jb, **kw)))(jp)
    return float(loss), flat_numpy(jax.tree.map(np.asarray, grads), "g")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma-7b",
                                  "hubert-xlarge", "qwen2-moe-a2.7b",
                                  "arctic-480b", "xlstm-350m", "minitron-8b",
                                  "llama-3.2-vision-90b"])
def test_loss_and_grads_match_reference(arch):
    pair = Pair(arch)
    batch = pair.batch()
    want_loss, want = ref_value_and_grad(pair, batch, loss_chunk=LOSS_CHUNK)
    loss, grads = loss_and_grads(pair.cfg, pair.dims, pair.params(),
                                 batch_to_device(batch, CPU))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    # loss_and_grads uses the default chunk (512 > S: one chunk); the
    # chunked form is held below
    got = flat_numpy(numpy_from_params(pair.cfg, grads), "g")
    assert sorted(got) == sorted(want)
    scale = max(np.abs(g).max() for g in want.values())
    for key, w in want.items():
        err = np.abs(got[key] - w).max()
        assert err <= 5e-5 * scale, (key, err, scale)


def test_chunked_loss_and_masking_match_reference():
    pair = Pair("gemma-7b")
    batch = pair.batch(seed=4)
    batch["labels"][1, 10:20] = -1
    want_loss, _ = ref_value_and_grad(pair, batch, loss_chunk=LOSS_CHUNK)
    loss = TM.loss_fn(pair.cfg, pair.dims, pair.params(),
                      batch_to_device(batch, CPU), loss_chunk=LOSS_CHUNK)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)


def test_remat_settings_give_the_same_gradients():
    pair = Pair("zamba2-2.7b")
    batch = batch_to_device(pair.batch(), CPU)
    params = pair.params()
    _, base = loss_and_grads(pair.cfg, pair.dims, params, batch,
                             remat=False)
    for policy in ("nothing", "dots", "checkpoint_dots"):
        _, grads = loss_and_grads(pair.cfg, pair.dims, params, batch,
                                  remat=True, remat_policy=policy)
        for a, b in zip(tree_leaves(grads), tree_leaves(base)):
            assert torch.equal(a, b), policy


def rel_change_error(got, want, start):
    """L2 of (port - reference) over L2 of (reference - start)."""
    diff = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    moved = sum(float(((want[k] - start[k]) ** 2).sum()) for k in want)
    return np.sqrt(diff / moved)


def test_train_steps_from_carried_state_match_reference():
    pair = Pair("zamba2-2.7b")
    data = RSynthetic(pair.jcfg, B, S, seed=0)
    ropt = RConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jstep = jax.jit(RM.make_train_step(pair.jcfg, pair.jdims, ropt))
    jp = jax.tree.map(jnp.asarray, pair.tree)
    jst = radamw.init_state(ropt, jp)
    jp, jst, _ = jstep(jp, jst, jax.tree.map(jnp.asarray, data.batch_at(0)))
    # carried over: the reference's parameters and moments after step 0
    host = jax.tree.map(np.asarray, {"p": jp, "s": jst})
    params = params_from_numpy(pair.cfg, host["p"], device=CPU,
                               dtype=torch.float32)
    state = opt_state_from_numpy(pair.cfg, host["s"], device=CPU)
    assert int(state["step"]) == 1
    start = flat_numpy(host["p"], "p")
    step = make_train_step(pair.cfg, pair.dims, AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=20), device="cpu")
    for s in (1, 2, 3):
        batch = data.batch_at(s)
        jp, jst, jm = jstep(jp, jst, jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert int(m["step"]) == int(jm["step"]) == s + 1
    ref = jax.tree.map(np.asarray, {"p": jp, "mu": jst["mu"],
                                    "nu": jst["nu"]})
    assert rel_change_error(flat_numpy(numpy_from_params(pair.cfg, params),
                                       "p"),
                            flat_numpy(ref["p"], "p"), start) <= 1e-3
    for key in ("mu", "nu"):
        got = flat_numpy(numpy_from_params(pair.cfg, state[key]), key)
        want = flat_numpy(ref[key], key)
        zero = {k: np.zeros_like(v) for k, v in want.items()}
        assert rel_change_error(got, want, zero) <= 1e-3, key


def test_accumulated_steps_match_reference_and_one_pass():
    pair = Pair("gemma-7b")
    data = SyntheticLM(pair.cfg, 4, 16, seed=5)
    batch = data.batch_at(0)
    ropt = RConfig(lr=1e-3, warmup_steps=1)
    jp = jax.tree.map(jnp.asarray, pair.tree)
    _, _, jm = jax.jit(RM.make_train_step(pair.jcfg, pair.jdims, ropt,
                                          accum_steps=2))(
        jp, radamw.init_state(ropt, jp), jax.tree.map(jnp.asarray, batch))
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    out = {}
    for accum in (1, 2):
        params = pair.params()
        step = make_train_step(pair.cfg, pair.dims, opt, accum_steps=accum,
                               device="cpu")
        out[accum] = step(params, adamw.init_state(opt, params), batch)
    m2 = out[2][2]
    np.testing.assert_allclose(float(m2["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    # every label is valid, so two half-batch means average to the mean
    np.testing.assert_allclose(float(m2["loss"]), float(out[1][2]["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(out[1][2]["grad_norm"]), rtol=1e-5)


def test_eval_step_is_the_loss_without_a_graph():
    pair = Pair("gemma-7b")
    batch = pair.batch()
    loss = make_eval_step(pair.cfg, pair.dims, device="cpu")(pair.params(),
                                                             batch)
    assert loss.grad_fn is None
    want, _ = ref_value_and_grad(pair, batch)
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)


@pytest.mark.parametrize("arch", ["minitron-8b", "hubert-xlarge"])
def test_synthetic_batches_are_the_reference_bits(arch):
    cfg = reduced(TM.get_arch(arch))
    jcfg = ref_reduced(RM.get_arch(arch))
    ours, ref = SyntheticLM(cfg, 4, 32, seed=1), RSynthetic(jcfg, 4, 32,
                                                             seed=1)
    for step in (0, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_data_pipeline_deterministic_resumable_and_sharded():
    cfg = reduced(TM.get_arch("minitron-8b"))
    d1, d2 = SyntheticLM(cfg, 4, 32, seed=1), SyntheticLM(cfg, 4, 32, seed=1)
    a = d1.batch_at(17)
    np.testing.assert_array_equal(a["tokens"], d2.batch_at(17)["tokens"])
    assert not np.array_equal(d1.batch_at(18)["tokens"], a["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    it = d1.iterate(start_step=17)
    for step in (17, 18, 19):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      d1.batch_at(step)["tokens"])
    it.close()
    h0 = SyntheticLM(cfg, 8, 16, seed=1, host_index=0, host_count=2)
    h1 = SyntheticLM(cfg, 8, 16, seed=1, host_index=1, host_count=2)
    assert h0.batch == 4
    assert not np.array_equal(h0.batch_at(0)["tokens"],
                              h1.batch_at(0)["tokens"])


def test_watchdog_flags_stragglers_as_the_reference():
    ours, ref = StepWatchdog(threshold=3.0), RWatchdog(threshold=3.0)
    times = [0.1] * 10 + [1.0, 0.1, 0.35, 0.29]
    for i, t in enumerate(times):
        assert ours.record(i, t) == ref.record(i, t)
    assert ours.slow_steps == ref.slow_steps == [(10, 1.0), (12, 0.35)]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5)},
            "l": [torch.randn((3,), generator=g).to(torch.bfloat16)]}


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    restored, step = ckpt.restore(str(tmp_path), t)
    assert step == 5
    _equal(t, restored)


def test_checkpoint_keeps_latest_and_gcs(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep=3)
    assert ckpt.list_steps(str(tmp_path)) == [3, 4, 5]
    _, step = ckpt.restore(str(tmp_path), t)
    assert step == 5


def test_corrupt_checkpoint_falls_back(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 2, _tree(seed=7))
    path = os.path.join(str(tmp_path), "step_00000002", "data.npz")
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 64)
    restored, step = ckpt.restore(str(tmp_path), t)
    assert step == 1
    _equal(t, restored)


def test_checkpoint_restores_onto_the_asked_device(tmp_path):
    """The reference's elastic test places leaves on a new sharding; the
    port on one device takes ``device=``."""
    t = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    ckpt.save(str(tmp_path), 1, t)
    restored, _ = ckpt.restore(str(tmp_path), t, device="cpu")
    assert restored["w"].device == CPU
    _equal(t, restored)
    assert ckpt.restore(str(tmp_path), t, step=1)[1] == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), t, step=9)


def test_checkpoint_bf16_round_trip_and_async(tmp_path):
    """bf16 is stored as its uint16 bits with the dtype in the JSON
    manifest (no ml_dtypes or msgpack needed): bit for bit back."""
    g = torch.Generator().manual_seed(1)
    t = {"w": torch.randn((64, 3), generator=g).to(torch.bfloat16),
         "m": torch.randn((5,), generator=g)}
    ckpt.save_async(str(tmp_path), 3, t).join()
    restored, step = ckpt.restore(str(tmp_path), t)
    assert step == 3 and restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16),
                       t["w"].view(torch.int16))
    _equal(t, restored)
    files = sorted(os.listdir(tmp_path / "step_00000003"))
    assert files == ["data.npz", "manifest.json"]


def test_train_driver_failure_recovery(tmp_path):
    """Crash at step 12, restart, resume from the step-10 checkpoint: the
    resumed steps' losses == an uninterrupted run's."""
    common = ["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
              "--batch", "2", "--seq", "16", "--steps", "20",
              "--ckpt-every", "10", "--log-every", "100"]
    with pytest.raises(RuntimeError, match="simulated failure"):
        train.main(common + ["--ckpt-dir", str(tmp_path / "a"),
                             "--fail-at-step", "12"])
    resumed = train.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    clean = train.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert np.isfinite(resumed["final_loss"])
    assert len(resumed["losses"]) == 10 and len(clean["losses"]) == 20
    assert resumed["losses"] == clean["losses"][10:]
    assert ckpt.list_steps(str(tmp_path / "a")) == [10, 20]


def test_entry_points_need_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pair = Pair("gemma-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(pair.cfg, pair.dims, AdamWConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gemma-7b", "--smoke", "--steps", "1"])
    make_train_step(pair.cfg, pair.dims, AdamWConfig(), device="cpu")


def test_training_modules_import_neither_jax_nor_repro():
    """What the card runs for training (phase 14 of ``chip_smoke.py``)
    imports neither ``jax`` nor ``repro``."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.optim.adamw\n"
            "import repro_torch.distributed.checkpoint\n"
            "import repro_torch.data.pipeline, repro_torch.models.steps\n"
            "import repro_torch.kernels.flash_attention.grad\n"
            "import repro_torch.kernels.ssd_scan.grad\n"
            "from repro_torch.models.testing import train_steps\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
