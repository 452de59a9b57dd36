"""Write the reference logits the port's LM stack is held against on the card.

Runs the JAX reference package (``repro``) on the CPU, in float32, on reduced
``zamba2-2.7b`` (``repro.models.testing.reduced``: two super-blocks of five
Mamba-2 blocks and the shared attention block), with weights drawn by
``repro_torch.models.testing.numpy_tree`` from a numpy seed and tokens from
another, and records (beside ``arch``, ``weight_seed``, ``prompt_len`` and
``max_len``, which say how to rebuild the run):

* ``tokens``: the ``[2, 64]`` input tokens;
* ``forward``: the full forward's logits, ``[2, 64, vocab]``;
* ``prefill_last``: the last logits of a prefill of the first 48 tokens into
  a cache of 72 positions, ``[2, vocab]``;
* ``decode``: the logits of teacher-forced decode steps at positions 48 to
  63 after that prefill, ``[16, 2, vocab]``.

``reference_arrays(arch)`` makes the same record for another config; a
VLM's also holds ``cross_ctx``, its float32 context ``[2, cross_ctx_len,
d_model]`` from a third seed (``scripts/make_torch_vlm_golden.py``).

``chip_smoke.py`` rebuilds the weights with the same function, runs the
port's ``models.testing.teacher_forced`` on the card (where prefill runs
the ``flash_attention`` and ``ssd_scan`` kernels) and holds it against the
file without importing JAX;
``tests/test_torch_lm_golden.py`` regenerates the arrays and compares.

Usage: python scripts/make_torch_lm_golden.py [--out PATH]
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

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "tests", "fixtures", "torch_lm_golden.npz")
ARCH = "zamba2-2.7b"
WEIGHT_SEED = 0
TOKEN_SEED = 1
CROSS_SEED = 2
BATCH, S_FULL, S_PROMPT, MAX_LEN = 2, 64, 48, 72


def port_config(arch: str = ARCH):
    """The port's reduced float32 config (what ``numpy_tree`` draws for)."""
    import repro_torch.models as TM
    from repro_torch.models.testing import reduced
    return dataclasses.replace(reduced(TM.get_arch(arch)), dtype="float32")


def tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(TOKEN_SEED).integers(
        0, vocab, (BATCH, S_FULL)).astype(np.int32)


def reference_arrays(arch: str = ARCH) -> dict:
    """The JAX package's logits for the fixture's weights and tokens (and
    a VLM's context)."""
    import jax
    import jax.numpy as jnp
    import repro.models as RM
    from repro.models.testing import reduced
    from repro_torch.models.testing import numpy_tree
    cfg = dataclasses.replace(reduced(RM.get_arch(arch)), dtype="float32")
    dims = RM.ModelDims.create(cfg, tp=1)
    params = jax.tree.map(jnp.asarray, numpy_tree(port_config(arch),
                                                  WEIGHT_SEED))
    toks = tokens(cfg.vocab)
    extra, cross = {}, None
    if cfg.cross_ctx_len:
        extra["cross_ctx"] = np.random.default_rng(CROSS_SEED).standard_normal(
            (BATCH, cfg.cross_ctx_len, cfg.d_model)).astype(np.float32)
        cross = jnp.asarray(extra["cross_ctx"])
    full, _ = jax.jit(lambda p, t: RM.forward(
        cfg, dims, p, {"tokens": t, "cross_ctx": cross}))(
            params, jnp.asarray(toks))
    prefill = jax.jit(RM.make_prefill_step(cfg, dims, max_cache_len=MAX_LEN))
    decode = jax.jit(RM.make_decode_step(cfg, dims))
    last, cache = prefill(params, {"tokens": jnp.asarray(toks[:, :S_PROMPT]),
                                   "cross_ctx": cross})
    steps = []
    for i in range(S_PROMPT, S_FULL):
        logits, cache = decode(params, jnp.asarray(toks[:, i:i + 1]), cache,
                               jnp.int32(i), cross)
        steps.append(np.asarray(logits))
    return {"arch": np.array(arch), "weight_seed": np.int64(WEIGHT_SEED),
            "prompt_len": np.int64(S_PROMPT), "max_len": np.int64(MAX_LEN),
            "tokens": toks, "forward": np.asarray(full),
            "prefill_last": np.asarray(last), "decode": np.stack(steps),
            **extra}


def main(argv=None, arch: str = ARCH, out: str = GOLDEN) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=out)
    args = ap.parse_args(argv)
    arrays = reference_arrays(arch)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k} {v.shape}" for k, v in arrays.items()))


if __name__ == "__main__":
    main()
