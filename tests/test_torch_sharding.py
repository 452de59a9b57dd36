"""The port's sharding rules (``repro_torch.distributed.sharding``) and
padded dims (``ModelDims.create(cfg, tp)``) against the JAX reference's,
for every assigned config at full width, in one process (no ranks).

The reference's parameter shapes come from ``jax.eval_shape`` of its
``init_params``; the port's layout of them (one dictionary per layer) is
built from the same shapes.  The port's ``MeshSpec`` has ``axis_names`` and
``devices`` (the rank grid) and so serves both packages' ``make_specs`` and
``batch_specs``, which read only those.  A reference spec of a leaf stacked
under ``layers`` is compared without its leading entry where that entry is
None; where ZeRO-1 puts 'data' there (the layer axis), the port's spec is a
``LayerP`` that keeps it.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import ASSIGNED
from repro.distributed import sharding as rshd
from repro.models import ModelDims as RDims
from repro.models import get_arch as rget
from repro.models import init_params as rinit

from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh, make_production_mesh, \
    make_test_mesh
from repro_torch.models import ModelDims, get_arch

MESHES = {
    "1x2": make_mesh((1, 2), ("data", "model")),
    "4x2": make_mesh((4, 2), ("data", "model")),
    "16x16": make_production_mesh(),
    "2x16x16": make_production_mesh(multi_pod=True),
}


class _Shape:
    """A leaf that is only a shape (indexing drops the leading axis)."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __getitem__(self, i):
        return _Shape(self.shape[1:])


def _tp(cfg, mesh) -> int:
    return mesh.axis_size("model") if rshd.style_for(cfg) == "tp" else 1


@functools.lru_cache(maxsize=None)
def _ref_shapes(name: str, tp: int):
    cfg = rget(name)
    return jax.eval_shape(lambda: rinit(cfg, jax.random.PRNGKey(0),
                                        RDims.create(cfg, tp)))


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    return fn(tree)


def _port_layout(cfg, tree, pick):
    """A reference tree (stacked layers) in the port's layout: ``pick(leaf,
    si)`` gives layer si's leaf (si None outside ``layers``)."""
    out = {k: _walk(v, lambda x: pick(x, None))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [[_walk(tree["layers"].get(f"p{pi}", {}),
                            lambda x, si=si: pick(x, si))
                      for pi in range(len(cfg.block_pattern))]
                     for si in range(cfg.n_super_blocks)]
    return out


def _shape_leaf(x, si):
    return _Shape(x.shape if si is None else x.shape[1:])


def _spec_leaf(x, si):
    """The reference's spec as the port states it: a stacked leaf's leading
    None dropped, a leading axis kept (``LayerP``)."""
    t = tuple(x)
    if si is None or (t and t[0] is not None):
        return t
    return t[1:]


def _ref_spec_tree(cfg, specs):
    return _port_layout(cfg, _as_dict(specs), _spec_leaf)


def _as_dict(tree):
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    return tree


def _assert_specs_equal(port, ref, where):
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), where
        for k in port:
            _assert_specs_equal(port[k], ref[k], f"{where}/{k}")
    elif isinstance(port, list):
        assert len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_specs_equal(a, b, f"{where}/{i}")
    else:
        assert tuple(port) == tuple(ref), (where, port, ref)
        if isinstance(port, shd.LayerP):
            assert ref and ref[0] is not None, where


@pytest.mark.parametrize("name", ASSIGNED)
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_model_dims_match_reference(name, tp):
    ref = RDims.create(rget(name), tp=tp)
    got = ModelDims.create(get_arch(name), tp=tp)
    assert (got.tp, got.n_q_pad, got.n_kv_pad, got.vocab_pad,
            got.expert_pad) == (ref.tp, ref.n_q_pad, ref.n_kv_pad,
                                ref.vocab_pad, ref.expert_pad)


def test_model_dims_padding_examples():
    from repro_torch.models.testing import reduced
    mini = reduced(get_arch("minitron-8b"))
    assert (mini.n_heads, mini.n_kv_heads) == (4, 1)
    assert ModelDims.create(mini, 2).n_kv_pad == 2
    for name in ASSIGNED:
        d = ModelDims.create(reduced(get_arch(name)), 3)
        assert (d.n_q_pad, d.vocab_pad) == (6, 513)
    moe = ModelDims.create(reduced(get_arch("qwen2-moe-a2.7b")), 3)
    assert moe.expert_pad == 9
    assert ModelDims.create(get_arch("minitron-8b")) == ModelDims(
        32, 8, 256000, 1, 1)


@pytest.mark.parametrize("name", ASSIGNED)
def test_param_and_zero1_specs_match_reference(name):
    """Parameter specs, and ZeRO-1 / optimizer-state specs at every
    mesh's data axis, leaf by leaf (every layer of the full-depth model)."""
    cfg, rcfg = get_arch(name), rget(name)
    seen = set()
    for mesh_name, mesh in MESHES.items():
        tp = _tp(cfg, mesh)
        data = mesh.axis_size("data")
        if (tp, data) in seen:
            continue
        seen.add((tp, data))
        rshapes = _ref_shapes(name, tp)
        shapes = _port_layout(cfg, _as_dict(rshapes), _shape_leaf)
        rp = rshd.param_specs(rcfg, rshapes)
        pspec = shd.param_specs(cfg, shapes)
        _assert_specs_equal(pspec, _ref_spec_tree(cfg, rp),
                            f"{name} {mesh_name} params")
        rz = rshd.opt_state_specs(rcfg, rshapes, None, data)
        z = shd.opt_state_specs(cfg, shapes, None, data)
        assert tuple(z["step"]) == tuple(rz["step"]) == ()
        for k in ("mu", "nu"):
            _assert_specs_equal(z[k], _ref_spec_tree(cfg, rz[k]),
                                f"{name} {mesh_name} {k}")
        _assert_specs_equal(shd.zero1_specs(pspec, shapes, data),
                            _ref_spec_tree(cfg, rshd.zero1_specs(
                                rp, rshapes, data)),
                            f"{name} {mesh_name} zero1")


def _fields(specs):
    return {f: (None if getattr(specs, f) is None
                else tuple(getattr(specs, f)))
            for f in ("act", "ffn", "expert", "kv_cache", "kv_cache_stacked",
                      "logits", "heads", "ssm_heads")}


@pytest.mark.parametrize("name", ASSIGNED)
def test_activation_and_batch_specs_match_reference(name):
    cfg, rcfg = get_arch(name), rget(name)
    batch = {"tokens": np.zeros((1, 8), np.int32),
             "labels": np.zeros((1, 8), np.int32),
             "frames": np.zeros((1, 8, 4), np.float32)}
    for mesh_name, mesh in MESHES.items():
        for b in (1, 4, 8, 32, 256, 512):
            for kw in ({}, {"seq_shard": True}, {"seq_parallel": True},
                       {"expert_axes": "model_major"}):
                got = _fields(shd.make_specs(cfg, mesh, b, **kw))
                want = _fields(rshd.make_specs(rcfg, mesh, b, **kw))
                assert got == want, (name, mesh_name, b, kw)
            got = shd.batch_specs(cfg, mesh, batch, b)
            want = rshd.batch_specs(rcfg, mesh, batch, b)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (name, mesh_name, b)


def test_port_init_tree_has_the_specs_layout():
    """The port's own ``init_params`` tree (reduced, padded at tp = 2)
    takes the specs the reference's shapes give, leaf for leaf."""
    import torch
    from repro.models.testing import reduced as rreduced
    from repro_torch.models import init_params
    from repro_torch.models.testing import reduced
    for name in ("minitron-8b", "qwen2-moe-a2.7b", "zamba2-2.7b",
                 "llama-3.2-vision-90b", "gemma-7b"):
        cfg, rcfg = reduced(get_arch(name)), rreduced(rget(name))
        params = init_params(cfg, ModelDims.create(cfg, 2),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.float32)
        rshapes = jax.eval_shape(lambda: rinit(rcfg, jax.random.PRNGKey(0),
                                               RDims.create(rcfg, 2)))
        want = _port_layout(cfg, _as_dict(rshapes), _shape_leaf)
        got = shd.tree_map_specs(lambda t: _Shape(t.shape), params)
        _assert_shapes(got, want, name)
        _assert_specs_equal(shd.param_specs(cfg, params),
                            _ref_spec_tree(cfg, rshd.param_specs(
                                rcfg, rshapes)), name)


def _assert_shapes(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_shapes(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_shapes(x, y, f"{where}/{i}")
    else:
        assert a.shape == b.shape, (where, a.shape, b.shape)


def test_meshes():
    assert make_test_mesh(8).shape == (2, 4)
    assert make_test_mesh(6).shape == (3, 2)
    assert make_test_mesh(3).shape == (3, 1)
    spec = make_mesh((2, 4), ("data", "model"))
    assert spec.coords(6) == {"data": 1, "model": 2}
    assert spec.groups(("model",)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert spec.groups(("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    sub = make_mesh((1, 2), ("data", "model"), ranks=(5, 3))
    assert sub.coords(3) == {"data": 0, "model": 1} and sub.coords(0) is None
    assert make_production_mesh(multi_pod=True).devices.shape == (2, 16, 16)
