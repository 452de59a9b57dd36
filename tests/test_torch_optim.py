"""The port's AdamW against the reference's (``repro.optim.adamw``).

The same trees (numpy draws, handed to both packages) go through several
``apply_updates`` steps on each side: float32 parameters and moments with
the global-norm clip active, then bf16 parameters with bf16 moments.
Tolerances: float32 ``rtol = atol = 1e-6`` (both sides write the same
formula in float32; XLA may fuse it into other roundings); bf16 one bf16
rounding (``rtol = 1e-2``, ``atol = 1e-5``), since one last-bit difference
of the float32 value can round the other way.  ``schedule`` and
``global_norm`` to 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import AdamWConfig as RConfig, adamw as radamw

from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.tree import (tree_flatten_with_paths, tree_leaves,
                                    tree_map, tree_unflatten)

STEPS = [0, 1, 5, 19, 20, 21, 99, 100, 101, 2500, 9999, 10_000, 20_000]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite's test
    workers share the cores, and torch's default pool (a thread per core
    in each worker) oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_tree(rng, scale=1.0):
    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": n(12, 8), "final": {"scale": n(8)},
            "layers": {"p0": {"w": n(2, 8, 16), "b": n(2, 16)},
                       "p1": {"w": n(2, 16, 8)}}}


def port_tree(tree, dtype):
    """The numpy tree as the port holds parameters: the reference's
    ``layers`` dictionary becomes a list of per-layer dictionaries."""
    def t(a):
        return torch.tensor(a).to(dtype)
    return {"embed": t(tree["embed"]), "final": {"scale": t(
        tree["final"]["scale"])},
        "layers": [{"p0": {"w": t(tree["layers"]["p0"]["w"][i]),
                           "b": t(tree["layers"]["p0"]["b"][i])},
                    "p1": {"w": t(tree["layers"]["p1"]["w"][i])}}
                   for i in range(2)]}


def as_reference(tree):
    """A port tree stacked back into the reference's layout, float32."""
    def f(x):
        return x.float().numpy()
    layers = tree["layers"]
    return {"embed": f(tree["embed"]), "final": {"scale": f(
        tree["final"]["scale"])},
        "layers": {"p0": {"w": np.stack([f(l["p0"]["w"]) for l in layers]),
                          "b": np.stack([f(l["p0"]["b"]) for l in layers])},
                   "p1": {"w": np.stack([f(l["p1"]["w"]) for l in layers])}}}


def assert_trees_close(ours, ref, **tol):
    ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, r in ref_flat:
        keys = [getattr(p, "key", None) for p in path]
        x = ours
        for key in keys:
            x = x[key]
        np.testing.assert_allclose(x, np.asarray(r, np.float32), **tol,
                                   err_msg="/".join(keys))


@pytest.mark.parametrize("warmup,total", [(20, 100), (100, 10_000), (1, 3)])
def test_schedule_matches_reference(warmup, total):
    ours = AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    ref = RConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for s in STEPS:
        got = adamw.schedule(ours, torch.tensor(s, dtype=torch.int32))
        want = radamw.schedule(ref, jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_state_and_global_norm():
    tree = random_tree(np.random.default_rng(0))
    ours = port_tree(tree, torch.float32)
    state = adamw.init_state(AdamWConfig(moment_dtype=torch.bfloat16), ours)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for p, m in zip(tree_leaves(ours), tree_leaves(state["mu"])):
        assert m.shape == p.shape and m.dtype == torch.bfloat16
        assert not m.any()
    np.testing.assert_allclose(
        float(adamw.global_norm(ours)),
        float(radamw.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6)


def run_both(cfg_kw, dtype, n_steps, seed):
    rng = np.random.default_rng(seed)
    tree = random_tree(rng)
    grads = [random_tree(rng, scale=3.0) for _ in range(n_steps)]
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    mdt = cfg_kw.pop("moment_dtype", torch.float32)
    ours_cfg = AdamWConfig(**cfg_kw, moment_dtype=mdt)
    ref_cfg = RConfig(**cfg_kw, moment_dtype=(
        jnp.bfloat16 if mdt == torch.bfloat16 else jnp.float32))
    p = port_tree(tree, dtype)
    st = adamw.init_state(ours_cfg, p)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdtype), tree)
    jst = radamw.init_state(ref_cfg, jp)
    jupd = jax.jit(lambda a, b, c: radamw.apply_updates(ref_cfg, a, b, c))
    norms = []
    for g in grads:
        tg = port_tree(g, dtype)
        norms.append((float(adamw.global_norm(tg)),
                      float(radamw.global_norm(
                          jax.tree.map(lambda a: jnp.asarray(a, jdtype), g)))))
        p, st = adamw.apply_updates(ours_cfg, p, tg, st)
        jp, jst = jupd(jp, jax.tree.map(lambda a: jnp.asarray(a, jdtype), g),
                       jst)
    return p, st, jp, jst, norms


def test_float32_steps_with_clipping_match_reference():
    p, st, jp, jst, norms = run_both(
        dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5),
        torch.float32, 5, seed=1)
    assert all(ours > 0.5 for ours, _ in norms)      # the clip is active
    for ours, ref in norms:
        np.testing.assert_allclose(ours, ref, rtol=1e-6)
    tol = dict(rtol=1e-6, atol=1e-6)
    assert_trees_close(as_reference(p), jp, **tol)
    assert_trees_close(as_reference(st["mu"]), jst["mu"], **tol)
    assert_trees_close(as_reference(st["nu"]), jst["nu"], **tol)
    assert int(st["step"]) == int(jst["step"]) == 5


def test_bf16_params_and_moments_match_reference():
    p, st, jp, jst, _ = run_both(
        dict(lr=1e-3, warmup_steps=1, total_steps=100,
             moment_dtype=torch.bfloat16), torch.bfloat16, 4, seed=2)
    for leaf in tree_leaves(p):
        assert leaf.dtype == torch.bfloat16
    for leaf in tree_leaves(st["mu"]) + tree_leaves(st["nu"]):
        assert leaf.dtype == torch.bfloat16
    tol = dict(rtol=1e-2, atol=1e-5)
    assert_trees_close(as_reference(p), jp, **tol)
    assert_trees_close(as_reference(st["mu"]), jst["mu"], **tol)
    assert_trees_close(as_reference(st["nu"]), jst["nu"], **tol)


def test_apply_updates_leaves_its_inputs_alone():
    tree = port_tree(random_tree(np.random.default_rng(3)), torch.float32)
    before = tree_map(torch.clone, tree)
    cfg = AdamWConfig()
    state = adamw.init_state(cfg, tree)
    new, new_state = adamw.apply_updates(cfg, tree, tree, state)
    for a, b in zip(tree_leaves(tree), tree_leaves(before)):
        assert torch.equal(a, b)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert not torch.equal(tree_leaves(new)[0], tree_leaves(tree)[0])


def test_tree_helpers_round_trip():
    tree = port_tree(random_tree(np.random.default_rng(4)), torch.float32)
    paths = [p for p, _ in tree_flatten_with_paths(tree)]
    assert paths[:3] == ["embed", "final/scale", "layers/0/p0/w"]
    again = tree_unflatten(tree, tree_leaves(tree))
    assert [p for p, _ in tree_flatten_with_paths(again)] == paths
    with pytest.raises(ValueError):
        tree_unflatten(tree, tree_leaves(tree) + [torch.zeros(1)])
