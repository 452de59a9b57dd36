"""The port's dry-run cell matrix (``repro_torch.launch.cells``), its
analytic memory and accumulation depth (``launch.dryrun``), and its
roofline terms (``analysis.roofline``, ``launch.hillclimb.term``) against
the JAX reference's, in one process.

The specs are ``meta`` tensors (no allocation) held in shape and type to
the reference's ``jax.eval_shape`` trees at full width; a stacked
reference leaf (``layers["p{i}"]``, the cache's ``p{i}``) is the port's
leaf of every super-block with the super-block axis in front.  The
reference's ``analytic_memory`` and ``accum_steps_for`` read only
``axis_names`` and ``devices``, so the port's ``MeshSpec`` serves both.
The reference's ``launch.dryrun`` and ``launch.hillclimb`` set
``XLA_FLAGS`` to 512 host devices when imported: the fixture starts JAX's
backend first and puts the variable back.
"""
import functools
import os
import types

import jax
import pytest
import torch

from repro.configs import ASSIGNED
from repro.launch import cells as rcells
from repro.models import ModelDims as RDims
from repro.models import get_arch as rget

from repro_torch.analysis import roofline
from repro_torch.launch import cells, dryrun, hillclimb
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ModelDims, get_arch
from repro_torch.optim.tree import tree_leaves

MESHES = {"single_pod_16x16": make_production_mesh(),
          "multi_pod_2x16x16": make_production_mesh(multi_pod=True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    jax.devices()       # the device count is fixed from here on
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.analysis import roofline as rroof
        from repro.launch import dryrun as rdry
        from repro.launch import hillclimb as rhill
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return types.SimpleNamespace(dryrun=rdry, hillclimb=rhill,
                                 roofline=rroof)


def _pairs(cs):
    return [(c.arch, c.shape) for c in cs]


def test_cell_matrix_matches_reference():
    got, want = (cells.all_cells(include_skipped=True),
                 rcells.all_cells(include_skipped=True))
    assert _pairs(got) == _pairs(want)
    assert (len(got), len(cells.all_cells())) == (40, 31)
    assert _pairs(cells.all_cells()) == _pairs(rcells.all_cells())
    reasons = [cells.cell_valid(c) for c in got]
    assert reasons == [rcells.cell_valid(c) for c in want]
    assert sum(not ok for ok, _ in reasons) == 9
    for c, w in zip(got, want):
        assert (c.kind, c.seq, c.batch, c.seq_shard) == (
            w.kind, w.seq, w.batch, w.seq_shard)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return jax.numpy.dtype(x.dtype).name


def _same_leaf(port, ref, where):
    assert isinstance(port, torch.Tensor) and port.device.type == "meta", \
        where
    assert tuple(port.shape) == tuple(ref.shape), (where, port.shape,
                                                   ref.shape)
    assert _dtype_name(port) == _dtype_name(ref), where


def _stacked(trees: list):
    """Per-layer port trees as one tree of ``meta`` leaves with the
    super-block axis in front: the reference's stacked layout."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stacked([t[k] for t in trees]) for k in first}
    for t in trees:
        assert t.shape == first.shape and t.dtype == first.dtype
    return torch.empty((len(trees),) + tuple(first.shape),
                       dtype=first.dtype, device="meta")


def _ref_layout(cfg, layers: list) -> dict:
    return {f"p{pi}": _stacked([layer[pi] for layer in layers])
            for pi in range(len(cfg.block_pattern))}


def _assert_tree(port, ref, where=""):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), (where, sorted(port),
                                             sorted(ref))
        for k in ref:
            _assert_tree(port[k], ref[k], f"{where}/{k}")
    else:
        _same_leaf(port, ref, where)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_match_reference(arch):
    for c in cells.all_cells():
        if c.arch != arch:
            continue
        got, want = cells.input_specs(c), rcells.input_specs(
            rcells.Cell(c.arch, c.shape))
        assert list(got) == list(want)
        for k, w in want.items():
            if k == "index":
                assert isinstance(got[k], int) and got[k] == c.seq - 1
                assert w.shape == () and _dtype_name(w) == "int32"
            else:
                _same_leaf(got[k], w, f"{c.shape}/{k}")


@functools.lru_cache(maxsize=None)
def _ref_cache(arch: str, shape: str, dtype_name: str):
    cfg = rget(arch)
    return rcells.cache_specs(rcells.Cell(arch, shape), RDims.create(cfg),
                              getattr(jax.numpy, dtype_name))


@pytest.mark.parametrize("arch", [a for a in ASSIGNED
                                  if not get_arch(a).encoder_only])
def test_cache_specs_match_reference(arch):
    cfg = get_arch(arch)
    shapes = ["decode_32k"] + (["long_500k"] if cfg.sub_quadratic else [])
    for shape, dt in [(s, "bfloat16") for s in shapes] + [
            ("decode_32k", "float8_e4m3fn")]:
        got = cells.cache_specs(cells.Cell(arch, shape), ModelDims.create(
            cfg), getattr(torch, dt))
        _assert_tree(_ref_layout(cfg, got), _ref_cache(arch, shape, dt),
                     f"{shape}/{dt}")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_shapes_match_reference_without_allocation(arch):
    cfg = get_arch(arch)
    got = cells.param_shapes(cfg, ModelDims.create(cfg))
    want = rcells.param_shapes(rget(arch), RDims.create(rget(arch)))
    port = {k: v for k, v in got.items() if k != "layers"}
    port["layers"] = _ref_layout(cfg, got["layers"])
    _assert_tree(port, want)
    # the count (``ArchConfig.param_count`` is an estimate: it leaves out
    # norms and biases and counts xLSTM's blocks as 8 d^2)
    n = sum(t.numel() for t in tree_leaves(got))
    assert n == sum(x.size for x in jax.tree.leaves(want))
    assert all(t.device.type == "meta" for t in tree_leaves(got))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_analytic_memory_and_accum_match_reference(ref, mesh_name):
    mesh = MESHES[mesh_name]
    for c in cells.all_cells():
        rc = rcells.Cell(c.arch, c.shape)
        assert dryrun.accum_steps_for(c, mesh) == \
            ref.dryrun.accum_steps_for(rc, mesh)
        got = dryrun.analytic_memory(c, mesh)
        want = ref.dryrun.analytic_memory(rc, mesh)
        fits = got.pop(dryrun.FIT_KEY)
        want.pop("fits_v5e_16g")
        assert got == want, (c, mesh_name)
        assert fits == (got["total"] < dryrun.CARD_MEMORY_BYTES)


RECORDS = [
    {"cost": {"flops": 3.2e15, "bytes_accessed": 2.1e12},
     "collectives": {"total_link_bytes": 4.0e10}},
    {"cost": {"flops": 1.0e12, "bytes_accessed": 6.7e12},
     "collectives": {"total_link_bytes": 1.0e9}},
    {"cost": {"flops": 1.0e12, "bytes_accessed": 1.0e9},
     "collectives": {"total_link_bytes": 7.3e11}},
]


def test_roofline_terms_match_reference_at_the_cards_figures(ref,
                                                             monkeypatch):
    """The reference's formula and keys, with its constants set to the
    H100's (the port holds no TPU figure)."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref.roofline, name, getattr(roofline, name))
    monkeypatch.setattr(ref.hillclimb, "PEAK", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref.hillclimb, "HBM", roofline.HBM_BW)
    monkeypatch.setattr(ref.hillclimb, "LINK", roofline.LINK_BW)
    seen = set()
    for rec in RECORDS:
        got = roofline.terms(rec)
        assert got == ref.roofline.terms(rec)
        assert hillclimb.term(rec) == ref.hillclimb.term(rec)
        seen.add(got["bottleneck"])
    assert seen == {"compute", "memory", "collective"}
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 50e9)


def test_hillclimb_plan_is_the_reference_plan(ref):
    assert hillclimb.PLAN == ref.hillclimb.PLAN
    assert len(hillclimb.PLAN) == 14
