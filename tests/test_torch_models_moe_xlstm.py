"""The port's MoE and xLSTM blocks against the JAX reference.

Reduced ``qwen2-moe-a2.7b`` (routed top-2 of 8 experts plus one shared
expert), ``arctic-480b`` (top-2 of 8 plus the parallel dense residual) and
``xlstm-350m`` (alternating mLSTM and sLSTM blocks, SSD chunk 16), float32,
with the same seeded numpy weights in both packages
(``models.testing.numpy_tree``, carried by
``models.convert.params_from_numpy``).  Layer by layer: ``moe_apply``
(also with ``capacity_factor`` 1.25 and groups of 32 tokens, where tokens
are dropped, and with tied router logits, where the lower expert must win
as under ``jax.lax.top_k``), ``mlstm_apply`` and ``slstm_apply`` with and
without a cache and in decode; then the whole model: forward logits,
prefill into a longer cache, teacher-forced decode, greedy serving.  And
the SSD scan at xLSTM's widths: ``ssd_scan_plain`` at N = P = 256 and at
P = 1 (the normaliser) against the reference's ``gla_chunked``.

Tolerances as in ``tests/test_torch_models.py``: layers 1e-5 (rtol and
atol), whole models ``max |port - reference| <= 5e-5 * max |reference|``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models as RM
from repro.models import blocks as RB
from repro.models import layers as RL
from repro.models.testing import reduced as ref_reduced

import repro_torch.models as TM
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.launch import serve
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.testing import numpy_tree, reduced, synth_batch

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_REL = 5e-5
S_FULL, S_PROMPT = 64, 48            # multiples of the SSD chunk (16)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(ours, ref, tol=LAYER_TOL):
    np.testing.assert_allclose(as_np(ours), as_np(ref), **tol)


def close_model(ours, ref):
    ref = as_np(ref)
    err = np.abs(as_np(ours) - ref).max()
    assert err <= MODEL_REL * np.abs(ref).max(), (err, np.abs(ref).max())


def activations(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class Model:
    """One reduced architecture in both packages, float32, the same numpy
    weights."""

    def __init__(self, arch, seed=3, **tree_kw):
        self.jcfg = dataclasses.replace(ref_reduced(RM.get_arch(arch)),
                                        dtype="float32")
        self.cfg = dataclasses.replace(reduced(TM.get_arch(arch)),
                                       dtype="float32")
        self.tree = numpy_tree(self.cfg, seed, **tree_kw)
        self.jdims = RM.ModelDims.create(self.jcfg, tp=1)
        self.dims = TM.ModelDims.create(self.cfg)
        self.jparams = jax.tree.map(jnp.asarray, self.tree)
        self.params = params_from_numpy(self.cfg, self.tree, device="cpu",
                                        dtype=torch.float32)
        self.tokens = np.random.default_rng(1).integers(
            0, self.cfg.vocab, (2, S_FULL))

    def jctx(self, mode, S, **kw):
        return RB.BlockCtx(cfg=self.jcfg, mode=mode,
                           positions=jnp.arange(S)[None, :],
                           n_q_pad=self.jdims.n_q_pad,
                           n_kv_pad=self.jdims.n_kv_pad,
                           expert_pad=self.jdims.expert_pad, **kw)

    def ctx(self, mode, S, **kw):
        return TB.BlockCtx(cfg=self.cfg, mode=mode,
                           positions=torch.arange(S)[None, :],
                           n_q_pad=self.dims.n_q_pad,
                           n_kv_pad=self.dims.n_kv_pad,
                           expert_pad=self.dims.expert_pad, **kw)

    def layer(self, pi, si=0):
        """Pattern position ``pi`` of super-block ``si`` in both
        packages."""
        return (jax.tree.map(lambda a: a[si], self.jparams["layers"][
            f"p{pi}"]), self.params["layers"][si][pi])


MODELS = {"qwen2-moe": "qwen2-moe-a2.7b", "arctic": "arctic-480b",
          "xlstm": "xlstm-350m"}


@pytest.fixture(scope="module")
def models():
    return {k: Model(a) for k, a in MODELS.items()}


# ------------------------------- MoE ---------------------------------------

def _moe_dims(m, **change):
    j = RB._moe_dims(m.jcfg, m.jctx("full", 1))
    t = TB._moe_dims(m.cfg, m.ctx("full", 1))
    return dataclasses.replace(j, **change), dataclasses.replace(t, **change)


def _drops(dims, x, router):
    """(token, choice) pairs over capacity in some dispatch group."""
    T = x.shape[0] * x.shape[1]
    g = min(dims.group_size, T)
    logits = torch.tensor(x).reshape(T, -1) @ torch.tensor(router)
    _, sel = TL.router_top_k(logits, dims.top_k)
    counts = torch.nn.functional.one_hot(
        sel.reshape(T // g, g * dims.top_k), dims.n_experts).sum(1)
    return int((counts - TL.moe_capacity(dims, g)).clamp_min(0).sum())


@pytest.mark.parametrize("case", ["qwen2-moe", "arctic", "drop", "tie",
                                  "tie_drop"])
def test_moe_apply_matches_reference(models, case):
    """``moe_apply`` (and the whole MoE block): the default capacity
    factor 4 drops nothing; ``drop`` takes the reference's default 1.25
    and groups of 32 tokens, where tokens fall through to the residual;
    ``tie`` copies router column 0 into column 1, so experts 0 and 1 tie on
    every token and the lower index must come first."""
    name = "arctic" if case == "arctic" else "qwen2-moe"
    m = models[name] if not case.startswith("tie") else \
        Model(MODELS[name], tie_router=True)
    change = {}
    if case in ("drop", "tie_drop"):
        change = dict(capacity_factor=1.25, group_size=32)
    jd, td = _moe_dims(m, **change)
    jp, tp = m.layer(0)
    x = activations(7, 4, 64, m.cfg.d_model)
    router = m.tree["layers"]["p0"]["moe"]["router"][0]
    if change:
        assert _drops(td, x, router) > 0
    if case.startswith("tie"):
        logits = x.reshape(256, -1) @ router
        assert np.array_equal(logits[:, 0], logits[:, 1])
        # the tie decides membership: expert 1 must be left out where 0
        # is the second choice
        _, sel = TL.router_top_k(torch.tensor(logits), td.top_k)
        assert bool(((sel == 0).any(-1) & ~(sel == 1).any(-1)).any())
    ours = TL.moe_apply(tp["moe"], torch.tensor(x), td)
    ref = RL.moe_apply(jp["moe"], jnp.asarray(x), jd)
    close(ours, ref)
    if not change:
        j_out, _ = RB.attn_block_apply(jp, jnp.asarray(x),
                                       m.jctx("full", 64), None,
                                       RB.BlockKind.MOE)
        t_out, _ = TB.attn_block_apply(tp, torch.tensor(x),
                                       m.ctx("full", 64), None,
                                       TB.BlockKind.MOE)
        close(t_out, j_out)


def test_router_ties_keep_the_lower_expert():
    logits = torch.zeros((3, 10))
    logits[1, 7] = 1.0
    vals, idx = TL.router_top_k(logits, 3)
    assert idx.tolist() == [[0, 1, 2], [7, 0, 1], [0, 1, 2]]
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist()


# ------------------------------- xLSTM -------------------------------------

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_cache", [False, True])
def test_xlstm_block_prefill_and_decode(models, kind, with_cache):
    """``mlstm_apply`` / ``slstm_apply`` over 32 positions, without a cache
    and with one (the states it leaves), then three decode steps from
    those states."""
    m = models["xlstm"]
    pi = 0 if kind == "mlstm" else 1
    jp, tp = m.layer(pi, si=1)
    japply = RB.mlstm_apply if kind == "mlstm" else RB.slstm_apply
    tapply = TB.mlstm_apply if kind == "mlstm" else TB.slstm_apply
    x = activations(11, 2, 32, m.cfg.d_model)
    jcache = tcache = None
    if with_cache:
        jcache = RB.block_cache(m.jcfg, m.jctx("full", 32), 2, jnp.float32,
                                m.jcfg.block_pattern[pi])
        tcache = TB.block_cache(m.cfg, m.ctx("full", 32), 2, torch.float32,
                                m.cfg.block_pattern[pi], "cpu")
    j_out, j_new = japply(jp, jnp.asarray(x), m.jctx("full", 32), jcache)
    t_out, t_new = tapply(tp, torch.tensor(x), m.ctx("full", 32), tcache)
    close(t_out, j_out)
    assert (t_new is None) == (not with_cache)
    if not with_cache:
        return
    assert sorted(t_new) == sorted(j_new)
    for key in j_new:
        close(t_new[key], j_new[key])
    for i in range(3):
        xd = activations(20 + i, 2, 1, m.cfg.d_model)
        j_out, j_new = japply(jp, jnp.asarray(xd), m.jctx(
            "decode", 1, cache_index=32 + i), j_new)
        t_out, t_new = tapply(tp, torch.tensor(xd), m.ctx(
            "decode", 1, cache_index=32 + i), t_new)
        close(t_out, j_out)
        for key in j_new:
            close(t_new[key], j_new[key])


# ---------------------------- whole model ----------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_prefill_and_teacher_forced_decode(models, name):
    m = models[name]
    toks = m.tokens
    cfg, dims = m.jcfg, m.jdims
    full = jax.jit(lambda p, t: RM.forward(cfg, dims, p, {"tokens": t})[0])(
        m.jparams, jnp.asarray(toks))
    ours, _ = TM.forward(m.cfg, m.dims, m.params,
                         {"tokens": torch.tensor(toks)})
    close_model(ours, full)

    jlast, jcache = jax.jit(RM.make_prefill_step(
        cfg, dims, max_cache_len=S_FULL + 8))(
        m.jparams, {"tokens": jnp.asarray(toks[:, :S_PROMPT])})
    last, cache = TM.prefill(m.cfg, m.dims, m.params,
                             {"tokens": torch.tensor(toks[:, :S_PROMPT])},
                             max_cache_len=S_FULL + 8)
    close_model(last, jlast)
    for si in range(m.cfg.n_super_blocks):
        for pi in range(len(m.cfg.block_pattern)):
            ref = jax.tree.map(lambda a: a[si], jcache[f"p{pi}"])
            assert jax.tree.structure(ref) == jax.tree.structure(
                jax.tree.map(lambda t: 0, cache[si][pi]))
            for r, o in zip(jax.tree.leaves(ref),
                            jax.tree.leaves(cache[si][pi])):
                assert tuple(o.shape) == r.shape
                close_model(o, r)

    j_decode = jax.jit(RM.make_decode_step(cfg, dims))
    for i in range(S_PROMPT, S_PROMPT + 4):
        tok = toks[:, i:i + 1]
        jl, jcache = j_decode(m.jparams, jnp.asarray(tok), jcache,
                              jnp.int32(i))
        tl, cache = TM.decode_step(m.cfg, m.dims, m.params,
                                   torch.tensor(tok), cache, i)
        close_model(tl, jl)
        close_model(tl, full[:, i])


@pytest.mark.parametrize("name", ["qwen2-moe", "xlstm"])
def test_serve_greedy_tokens_match_reference_loop(models, name,
                                                  monkeypatch):
    """``serve.main`` on the CPU with the numpy weights (float32) against a
    greedy prefill + decode loop of the JAX package."""
    m = models[name]
    B, P, G = 2, 32, 8
    monkeypatch.setattr(serve, "reduced", lambda cfg: m.cfg)
    monkeypatch.setattr(serve, "init_params",
                        lambda cfg, dims, generator: m.params)
    out = serve.main(["--arch", MODELS[name], "--smoke", "--batch", str(B),
                      "--prompt-len", str(P), "--gen", str(G),
                      "--device", "cpu"])
    assert tuple(out["tokens"].shape) == (B, G)
    prompt = synth_batch(m.cfg, batch=B, seq=P, seed=0)["tokens"]
    logits, cache = jax.jit(RM.make_prefill_step(
        m.jcfg, m.jdims, max_cache_len=P + G))(
        m.jparams, {"tokens": jnp.asarray(prompt.numpy())})
    j_decode = jax.jit(RM.make_decode_step(m.jcfg, m.jdims))
    toks = [jnp.argmax(logits, axis=-1)[:, None]]
    for i in range(G - 1):
        logits, cache = j_decode(m.jparams, toks[-1], cache,
                                 jnp.int32(P + i))
        toks.append(jnp.argmax(logits, axis=-1)[:, None])
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(toks, axis=1)))


def test_port_init_has_the_numpy_tree_layout():
    """The port's own random weights have the carried weights' shapes and
    types (the router float32), at reduced widths, for all three."""
    for arch in MODELS.values():
        cfg = reduced(TM.get_arch(arch))
        ours = TM.init_params(cfg, TM.ModelDims.create(cfg),
                              generator=torch.Generator().manual_seed(0))
        carried = params_from_numpy(cfg, numpy_tree(cfg), device="cpu")

        def shapes(t):
            return jax.tree.map(lambda a: (tuple(a.shape), a.dtype), t)
        assert shapes(ours) == shapes(carried), arch
        if cfg.moe is not None:
            assert ours["layers"][0][0]["moe"]["router"].dtype == \
                torch.float32


# ------------------------- ssd_scan at xLSTM's widths ----------------------

@pytest.mark.parametrize("P", [256, 1])
def test_ssd_scan_plain_at_xlstm_widths(P):
    """N = 256 with P = 256 (mLSTM's numerator at full width) and P = 1
    (its normaliser, ``v = ones[..., :1]``), chunk 32 over 3 chunks,
    against the reference's ``gla_chunked``; ``norm=True`` returns both
    scans of the two reference calls."""
    rng = np.random.default_rng(P)
    B, L, H, N, c = 1, 96, 2, 256, 32
    q, k = (rng.standard_normal((B, L, H, N)).astype(np.float32) / 16
            for _ in range(2))
    v = rng.standard_normal((B, L, H, P)).astype(np.float32) if P > 1 \
        else np.ones((B, L, H, 1), np.float32)
    a = -np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(np.float32)
    ref = RL.gla_chunked(*(jnp.asarray(t) for t in (q, k, v, a)), c)
    tq, tk, tv, ta = (torch.tensor(t) for t in (q, k, v, a))
    close(ssd_scan_plain(tq, tk, tv, ta, chunk=c), ref)
    if P > 1:
        num, den = ssd_scan(tq, tk, tv, ta, chunk=c, norm=True)
        close(num, ref)
        ones = jnp.ones((B, L, H, 1), jnp.float32)
        close(den, RL.gla_chunked(*(jnp.asarray(t) for t in (q, k)), ones,
                                  jnp.asarray(a), c)[..., 0])
