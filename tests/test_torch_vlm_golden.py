"""The committed VLM reference logits: fresh from the reference, met by the
port.

``tests/fixtures/torch_vlm_golden.npz`` (written by
``scripts/make_torch_vlm_golden.py``) is what ``chip_smoke.py`` phase 15
holds the port's reduced llama-3.2-vision-90b on the card against, without
importing the JAX package.  As ``tests/test_torch_lm_golden.py`` does for
zamba2: the arrays are regenerated here from the reference, and the port's
CPU run, on the file's tokens and float32 context, meets them within
``max |port - reference| <= 5e-5 * max |reference|``.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_vlm_golden as golden  # noqa: E402

from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.testing import numpy_tree, teacher_forced  # noqa: E402

MODEL_REL = 5e-5
KEYS = ("forward", "prefill_last", "decode")


@pytest.fixture(scope="module")
def committed():
    with np.load(golden.GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_fixture_is_current(committed):
    """Regenerated by the reference; the float32 logits to 1e-6 relative
    (XLA's CPU code may differ between hosts in the last bits)."""
    fresh = golden.reference_arrays()
    assert sorted(fresh) == sorted(committed)
    for k in ("arch", "weight_seed", "prompt_len", "max_len", "tokens",
              "cross_ctx"):
        np.testing.assert_array_equal(fresh[k], committed[k])
    for k in KEYS:
        scale = np.abs(committed[k]).max()
        np.testing.assert_allclose(fresh[k], committed[k], rtol=1e-6,
                                   atol=1e-6 * scale)


def test_port_cpu_run_meets_fixture(committed):
    cfg = golden.port_config()
    assert str(committed["arch"]) == golden.ARCH
    assert committed["cross_ctx"].dtype == np.float32
    params = params_from_numpy(
        cfg, numpy_tree(cfg, int(committed["weight_seed"])), device="cpu",
        dtype=torch.float32)
    out = teacher_forced(cfg, params, torch.tensor(committed["tokens"]),
                         int(committed["prompt_len"]),
                         int(committed["max_len"]),
                         torch.tensor(committed["cross_ctx"]))
    for k in KEYS:
        ref = committed[k]
        err = np.abs(out[k].numpy() - ref).max()
        assert err <= MODEL_REL * np.abs(ref).max(), (k, err)
