"""Write the reference training run the port's training path is held against.

Runs the JAX reference package (``repro``) on the CPU, in float32, on reduced
``zamba2-2.7b`` (``repro.models.testing.reduced``: two super-blocks of five
Mamba-2 blocks and the shared attention block, d_model 64, SSD chunk 16) or,
with ``--arch xlstm-350m``, reduced xLSTM (two super-blocks of an mLSTM and
an sLSTM block, d_model 64, 4 heads of 16, SSD chunk 16), with weights drawn by ``repro_torch.models.testing.numpy_tree`` from a
numpy seed (``weight_seed``: the initial parameters, rebuilt bit for bit
by the same function) and the batches of ``SyntheticLM(seed=0)``
(``repro.data.pipeline``), and records:

* ``tokens`` / ``labels``: the batches of steps 0, 1 and 2, ``[3, B, S]``;
* ``loss`` / ``grad_norm``: the metrics of three ``make_train_step`` steps
  (AdamW ``lr=1e-2, warmup_steps=1``, float32 moments, remat ``nothing``);
* ``params/<path>``: every parameter after the three steps, in the
  reference's layout (paths as ``models.convert.numpy_from_params`` and
  ``jax.tree_util`` name them: ``layers/p0/in_proj/w`` ...);
* ``loss_fn`` and ``grads/<path>``: one ``loss_fn`` call (remat on) and its
  gradient at the initial parameters on step 0's batch.

``chip_smoke.py`` (phase 14) rebuilds the weights, runs the port's three
steps on the card with the CUDA kernels forward and backward, and holds
them against the file without importing JAX;
``tests/test_torch_train_golden.py`` regenerates the arrays and compares,
and holds the port's CPU run to them.  Each arch has its own file
(``GOLDEN``).

Usage: python scripts/make_torch_train_golden.py [--arch ARCH] [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "tests", "fixtures")
GOLDEN = {"zamba2-2.7b": os.path.join(FIXTURES, "torch_train_golden.npz"),
          "xlstm-350m": os.path.join(FIXTURES,
                                     "torch_train_golden_xlstm.npz")}
ARCH = "zamba2-2.7b"
WEIGHT_SEED = 0
DATA_SEED = 0
BATCH, SEQ, STEPS = 2, 32, 3
LR, WARMUP = 1e-2, 1


def port_config(arch: str = ARCH):
    """The port's reduced float32 config (what ``numpy_tree`` draws for)."""
    import repro_torch.models as TM
    from repro_torch.models.testing import reduced
    return dataclasses.replace(reduced(TM.get_arch(arch)), dtype="float32")


def flat(tree: dict, prefix: str) -> dict:
    """``{prefix/path: array}`` over a nested dictionary of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def reference_arrays(arch: str = ARCH) -> dict:
    """The JAX package's three steps and one loss_fn call."""
    import jax
    import jax.numpy as jnp
    import repro.models as RM
    from repro.data.pipeline import SyntheticLM
    from repro.models.testing import reduced
    from repro.optim import AdamWConfig, adamw
    from repro_torch.models.testing import numpy_tree
    cfg = dataclasses.replace(reduced(RM.get_arch(arch)), dtype="float32")
    dims = RM.ModelDims.create(cfg, tp=1)
    params = jax.tree.map(jnp.asarray, numpy_tree(port_config(arch),
                                                  WEIGHT_SEED))
    data = SyntheticLM(cfg, BATCH, SEQ, seed=DATA_SEED)
    batches = [data.batch_at(s) for s in range(STEPS)]
    b0 = jax.tree.map(jnp.asarray, batches[0])
    loss0, grads0 = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(cfg, dims, p, b0)))(params)
    opt = AdamWConfig(lr=LR, warmup_steps=WARMUP)
    step = jax.jit(RM.make_train_step(cfg, dims, opt))
    state = adamw.init_state(opt, params)
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"arch": np.array(arch), "weight_seed": np.int64(WEIGHT_SEED),
           "data_seed": np.int64(DATA_SEED), "lr": np.float64(LR),
           "warmup_steps": np.int64(WARMUP),
           "tokens": np.stack([b["tokens"] for b in batches]),
           "labels": np.stack([b["labels"] for b in batches]),
           "loss": np.asarray(losses, np.float32),
           "grad_norm": np.asarray(norms, np.float32),
           "loss_fn": np.float32(loss0)}
    out.update(flat(jax.tree.map(np.asarray, params), "params"))
    out.update(flat(jax.tree.map(np.asarray, grads0), "grads"))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH, choices=sorted(GOLDEN))
    ap.add_argument("--out", default=None,
                    help="default: the arch's file in tests/fixtures")
    args = ap.parse_args(argv)
    args.out = args.out or GOLDEN[args.arch]
    arrays = reference_arrays(args.arch)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {len(arrays)} arrays, "
          f"{os.path.getsize(args.out)} bytes; loss {arrays['loss']}, "
          f"grad_norm {arrays['grad_norm']}")


if __name__ == "__main__":
    main()
