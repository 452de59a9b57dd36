"""The committed reference training run: fresh from the reference, met by
the port.

``tests/fixtures/torch_train_golden.npz`` and
``tests/fixtures/torch_train_golden_xlstm.npz`` (written by
``scripts/make_torch_train_golden.py [--arch xlstm-350m]``: reduced zamba2
and reduced xLSTM in float32, three AdamW steps and one ``loss_fn``
gradient each) are what ``chip_smoke.py`` phase 14 holds the port's
training on the card against, without importing the JAX package.  The
``xlstm`` tests repeat the three for the second file.  The arrays are regenerated here from the reference, so the
file cannot go stale (the float32 values to 1e-5 of each array's largest
entry: XLA's CPU code may differ between hosts in the last bits, and
Adam's steps carry them), and the port's CPU run must meet them with
``models.testing.TRAIN_TOL``, the limits phase 14 applies on the card.
"""
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import make_torch_train_golden as golden  # noqa: E402

from repro_torch.models.convert import (numpy_from_params,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.steps import loss_and_grads  # noqa: E402
from repro_torch.models import ModelDims  # noqa: E402
from repro_torch.models.testing import (TRAIN_TOL, flat_numpy,  # noqa: E402
                                        numpy_tree, train_fixture_errors,
                                        train_steps)

EXACT = ("arch", "weight_seed", "data_seed", "lr", "warmup_steps", "tokens",
         "labels")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite's test
    workers share the cores, and torch's default pool (a thread per core
    in each worker) oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(arch):
    with np.load(golden.GOLDEN[arch]) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def committed():
    return _load("zamba2-2.7b")


@pytest.fixture(scope="module")
def committed_xlstm():
    return _load("xlstm-350m")


def test_fixture_is_current(committed, arch="zamba2-2.7b"):
    fresh = golden.reference_arrays(arch)
    assert sorted(fresh) == sorted(committed)
    for k in EXACT:
        np.testing.assert_array_equal(fresh[k], committed[k])
    for k in sorted(set(fresh) - set(EXACT)):
        scale = np.abs(committed[k]).max()
        np.testing.assert_allclose(fresh[k], committed[k], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


def test_port_cpu_training_meets_fixture(committed, arch="zamba2-2.7b"):
    cfg = golden.port_config(arch)
    run = train_steps(cfg, committed, "cpu")
    errs = train_fixture_errors(committed, run)
    for key, tol in TRAIN_TOL.items():
        assert errs[key] <= tol, (key, errs)


def test_port_cpu_loss_fn_gradient_meets_fixture(committed,
                                                 arch="zamba2-2.7b"):
    """One ``loss_fn`` call at the initial weights on step 0's batch:
    the loss to 1e-6 relative, each gradient leaf to 5e-5 of the largest
    reference gradient (``tests/test_torch_train.py``'s rule)."""
    cfg = golden.port_config(arch)
    params = params_from_numpy(cfg, numpy_tree(cfg, int(
        committed["weight_seed"])), device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.tensor(committed["tokens"][0]).long(),
             "labels": torch.tensor(committed["labels"][0]).long()}
    loss, grads = loss_and_grads(cfg, ModelDims.create(cfg), params, batch)
    np.testing.assert_allclose(float(loss), float(committed["loss_fn"]),
                               rtol=1e-6)
    got = flat_numpy(numpy_from_params(cfg, grads), "grads")
    want = {k: v for k, v in committed.items() if k.startswith("grads/")}
    assert sorted(got) == sorted(want)
    scale = max(np.abs(v).max() for v in want.values())
    for key, w in want.items():
        assert np.abs(got[key] - w).max() <= 5e-5 * scale, key


def test_xlstm_fixture_is_current(committed_xlstm):
    test_fixture_is_current(committed_xlstm, "xlstm-350m")


def test_xlstm_port_cpu_training_meets_fixture(committed_xlstm):
    """Reduced xLSTM: the mLSTM's normalised scan through
    ``SSDScanNormFn`` and the sLSTM through ``SLSTMScanFn``, both with
    their plain backward versions on the CPU."""
    test_port_cpu_training_meets_fixture(committed_xlstm, "xlstm-350m")


def test_xlstm_port_cpu_loss_fn_gradient_meets_fixture(committed_xlstm):
    test_port_cpu_loss_fn_gradient_meets_fixture(committed_xlstm,
                                                 "xlstm-350m")
