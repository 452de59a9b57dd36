"""The port's int8 ring all-reduce (``repro_torch.distributed.compress``)
against the JAX reference's.

One spawn of 8 gloo CPU ranks (``launch.mesh.spawn``) runs
``compressed_psum`` over ``pod`` axes of 8, 3 (a vector the ring pads) and
2 ranks and 1 (the identity), on a seeded vector every rank holds (the
reference's case: its input is replicated) and on vectors that differ by
rank; meanwhile a subprocess with 8 emulated host devices runs the
reference's ``compressed_psum`` on the same replicated vector over meshes
of the first 8, 3 and 2 devices, as ``tests/test_multidevice_subprocess.py``
does.  Each output is within 0.02 of the exact sum (relative to its largest
entry, the reference's bound) and each element within one quantisation
step of the reference's (the final hop's scale, the largest entry of the
element's chunk over 127: the two quantisers may round one element
differently, where XLA multiplies by a reciprocal).  The ranks' sums are
not all the same bits, in either package: the rank that reduced a chunk
keeps it unquantised, the others get it through the all-gather's int8
hops (the reference's output is its first device's copy).
"""
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

N_ELEM = 4099                      # not a multiple of 2, 3 or 8: padded
SIZES = (8, 3, 2, 1)

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.compress import compressed_psum
from repro.launch.mesh import mesh_context
x = jnp.asarray(np.load(sys.argv[1]))
out = {}
for n in (8, 3, 2):
    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
    with mesh_context(mesh):
        out[f"n{n}"] = np.asarray(compressed_psum(x, mesh, axis="pod"))
np.savez(sys.argv[2], **out)
"""


def vector(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(N_ELEM).astype(
        np.float32)


def ranks(rank: int) -> dict:
    """Every mesh on every rank (group creation is collective); each
    member's sums."""
    from repro_torch.distributed.compress import compressed_psum
    from repro_torch.launch.mesh import RankMesh, make_mesh
    meshes = {}
    first = 0
    for n in SIZES:
        meshes[n] = RankMesh(make_mesh((n,), ("pod",),
                                       tuple(range(first, first + n))))
        first = (first + n) % 8
    out = {}
    for n, mesh in meshes.items():
        if not mesh.member:
            continue
        same = torch.from_numpy(vector(0))
        mine = torch.from_numpy(vector(10 + mesh.coords["pod"]))
        out[n] = {"same": compressed_psum(same, mesh).numpy(),
                  "mine": compressed_psum(mine, mesh).numpy()}
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import spawn
    got = {}

    def go():
        try:
            got["out"] = spawn(ranks, 8, timeout_s=180)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            got["err"] = e

    t = threading.Thread(target=go)
    t.start()
    with tempfile.TemporaryDirectory() as tmp:
        x = os.path.join(tmp, "x.npy")
        np.save(x, vector(0))
        res = subprocess.run(
            [sys.executable, "-c", _REF, x, os.path.join(tmp, "ref.npz")],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.dirname(__file__)))
        assert res.returncode == 0, res.stderr[-3000:]
        ref = dict(np.load(os.path.join(tmp, "ref.npz")))
    t.join()
    if "err" in got:
        raise got["err"]
    return got["out"], ref


def _steps(ref: np.ndarray, n: int) -> np.ndarray:
    """Each element's quantisation step: its chunk's largest entry over
    127 (the ring cuts the padded vector into n chunks)."""
    pad = (-len(ref)) % n
    chunks = np.pad(ref, (0, pad)).reshape(n, -1)
    step = np.abs(chunks).max(axis=1, keepdims=True) / 127.0
    return np.broadcast_to(step, chunks.shape).reshape(-1)[:len(ref)]


@pytest.mark.parametrize("n", SIZES)
def test_compressed_psum_matches_reference_and_exact(runs, n):
    out, ref = runs
    members = [o[n] for o in out if n in o]
    assert len(members) == n
    exact_same = vector(0).astype(np.float64) * n
    exact_mine = sum(vector(10 + i).astype(np.float64) for i in range(n))
    for m in members:
        if n == 1:
            np.testing.assert_array_equal(m["same"], vector(0))
            continue
        for got, exact in ((m["same"], exact_same), (m["mine"], exact_mine)):
            rel = np.abs(got - exact).max() / np.abs(exact).max()
            assert rel < 0.02, rel
        r = ref[f"n{n}"]
        assert np.all(np.abs(m["same"] - r) <= _steps(r, n) * (1 + 1e-6))


def test_quantiser_and_error_feedback_match_reference():
    import jax.numpy as jnp
    from repro.distributed import compress as rc
    from repro_torch.distributed import compress as tc
    x = vector(3)
    q, s = tc._quant(torch.from_numpy(x))
    rq, rs = rc._quant(jnp.asarray(x))
    assert np.isclose(float(s), float(rs), rtol=1e-6, atol=0)
    assert np.abs(q.numpy().astype(int) - np.asarray(rq).astype(int)).max() \
        <= 1
    np.testing.assert_allclose(tc._dequant(q, s).numpy(),
                               np.asarray(rc._dequant(rq, rs)),
                               atol=float(s) * 1.0001)
    g = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    r = {"a": torch.full((3,), 0.5), "b": [torch.ones(2)]}
    g2, r2 = tc.error_feedback_update(g, r)
    assert torch.equal(g2["a"], torch.full((3,), 1.5)) and r2 is r
    assert torch.equal(g2["b"][0], torch.ones(2))
    assert tc.error_feedback_update(g, None) == (g, None)
