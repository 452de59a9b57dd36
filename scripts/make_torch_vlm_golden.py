"""Write the reference logits the port's cross-attention VLM is held
against on the card.

``scripts/make_torch_lm_golden.py``'s record, for reduced
``llama-3.2-vision-90b`` (``repro.models.testing.reduced``: two
super-blocks of four attention blocks and one cross-attention block,
d_model 64, a context of 16 rows) in float32: the JAX reference on the CPU,
weights from ``repro_torch.models.testing.numpy_tree`` (each cross block's
gate drawn away from 0), ``[2, 64]`` tokens, and ``cross_ctx``, a float32
context ``[2, 16, 64]`` from its own seed, recorded in the file.  Arrays:
``forward``, ``prefill_last`` (a prefill of 48 tokens into a cache of 72
positions), ``decode`` (teacher-forced steps at positions 48 to 63).

``chip_smoke.py`` (phase 15) runs the port's
``models.testing.teacher_forced`` on the card against the file without
importing JAX; ``tests/test_torch_vlm_golden.py`` regenerates the arrays
and compares.

Usage: python scripts/make_torch_vlm_golden.py [--out PATH]
"""
from __future__ import annotations

import os

import make_torch_lm_golden as lm

ARCH = "llama-3.2-vision-90b"
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "tests", "fixtures", "torch_vlm_golden.npz")


def port_config():
    return lm.port_config(ARCH)


def reference_arrays() -> dict:
    return lm.reference_arrays(ARCH)


if __name__ == "__main__":
    lm.main(arch=ARCH, out=GOLDEN)
