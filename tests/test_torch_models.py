"""The port's LM stack against the JAX reference on reduced zamba2.

Reduced ``zamba2-2.7b`` (``models.testing.reduced``: two super-blocks of
five Mamba-2 blocks and the shared attention block, d_model 64, SSD chunk
16) in float32, with the reference's own ``init_params`` weights carried
over by ``models.convert.params_from_numpy``.  Layer by layer, then the
whole model: forward logits, prefill into a longer cache (last logits and
every cache entry), teacher-forced decode, and greedy serving.  A reduced
ATTN-only config (gemma-7b: GeGLU, tied embeddings, head_dim 16 at 4 heads)
runs through the same whole-model checks, and so do reduced arctic-480b
(MoE with the dense residual) and xlstm-350m (mLSTM and sLSTM) with the
reference's own initial weights (their layers:
``tests/test_torch_models_moe_xlstm.py``).

Tolerances (float32 throughout): single layers 1e-5 (rtol and atol), the
reference's own summation orders against torch's (matmul blocking); whole
models ``max |port - reference| <= 5e-5 * max |reference|``: twelve layers
of such differences, and the port carries the SSD state chunk by chunk
where the reference combines chunk states with an associative scan.  The
reference's own prefill + decode and its full forward differ on these
inputs by the same order, which ``close_model(tl, full[:, i])`` below
also holds the port to.
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
from repro_torch.launch import serve
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.testing import reduced, synth_batch

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_REL = 5e-5
S_FULL, S_PROMPT = 64, 48            # both multiples of the SSD chunk (16)


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


class Model:
    """One reduced architecture in both packages, float32, same weights."""

    def __init__(self, arch):
        self.jcfg = dataclasses.replace(ref_reduced(RM.get_arch(arch)),
                                        dtype="float32")
        self.cfg = dataclasses.replace(reduced(TM.get_arch(arch)),
                                       dtype="float32")
        self.jdims = RM.ModelDims.create(self.jcfg, tp=1)
        self.dims = TM.ModelDims.create(self.cfg)
        self.jparams = RM.init_params(self.jcfg, jax.random.PRNGKey(0),
                                      self.jdims, dtype=jnp.float32)
        self.params = params_from_numpy(
            self.cfg, jax.tree.map(np.asarray, self.jparams), device="cpu",
            dtype=torch.float32)
        self.tokens = np.random.default_rng(1).integers(
            0, self.cfg.vocab, (2, S_FULL))
        cfg, dims = self.jcfg, self.jdims
        self.j_forward = jax.jit(lambda p, t: RM.forward(
            cfg, dims, p, {"tokens": t})[0])
        self.j_prefill = jax.jit(RM.make_prefill_step(
            cfg, dims, max_cache_len=S_FULL + 8))
        self.j_decode = jax.jit(RM.make_decode_step(cfg, dims))

    def jctx(self, mode, S, **kw):
        return RB.BlockCtx(cfg=self.jcfg, mode=mode,
                           positions=jnp.arange(S)[None, :],
                           n_q_pad=self.jdims.n_q_pad,
                           n_kv_pad=self.jdims.n_kv_pad, **kw)

    def ctx(self, mode, S, **kw):
        return TB.BlockCtx(cfg=self.cfg, mode=mode,
                           positions=torch.arange(S)[None, :],
                           n_q_pad=self.dims.n_q_pad,
                           n_kv_pad=self.dims.n_kv_pad, **kw)


@pytest.fixture(scope="module")
def zamba():
    return Model("zamba2-2.7b")


@pytest.fixture(scope="module")
def gemma():
    return Model("gemma-7b")


@pytest.fixture(scope="module")
def arctic():
    return Model("arctic-480b")


@pytest.fixture(scope="module")
def xlstm():
    return Model("xlstm-350m")


def activations(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------- layers ------------------------------------

def test_rmsnorm_rope_and_mlps(zamba):
    x = activations(0, 2, 10, 64)
    p = zamba.jparams["shared_attn"]["ln1"]
    close(TL.rmsnorm(zamba.params["shared_attn"]["ln1"], torch.tensor(x)),
          RL.rmsnorm(p, jnp.asarray(x)))
    h = activations(1, 2, 10, 4, 16)
    for pos in (np.arange(10)[None, :], np.arange(30, 40)[None, :]):
        close(TL.rope(torch.tensor(h), torch.tensor(pos), 10000.0),
              RL.rope(jnp.asarray(h), jnp.asarray(pos), 10000.0))
    mlp = zamba.jparams["shared_attn"]["mlp"]
    close(TL.mlp_apply(zamba.params["shared_attn"]["mlp"], torch.tensor(x),
                       "gelu"), RL.mlp_apply(mlp, jnp.asarray(x), "gelu"))
    w = {"wi": mlp["wi"], "wg": mlp["wi"], "wo": mlp["wo"]}
    tw = {k: {"w": torch.tensor(np.asarray(v["w"]))} for k, v in w.items()}
    for kind in ("swiglu", "geglu"):
        close(TL.mlp_apply(tw, torch.tensor(x), kind),
              RL.mlp_apply(w, jnp.asarray(x), kind))


def test_attn_apply_with_and_without_cache(zamba):
    S, max_len = 16, 24
    dims = RL.AttnDims(64, 4, 4, 16)
    tdims = TL.AttnDims(64, 4, 4, 16)
    p = zamba.jparams["shared_attn"]["attn"]
    tp = zamba.params["shared_attn"]["attn"]
    x = activations(2, 2, S, 64)
    pos = np.arange(S)[None, :]
    kw = dict(causal=True, theta=10000.0, q_chunk=8)
    ref, _ = RL.attn_apply(p, jnp.asarray(x), dims,
                           positions=jnp.asarray(pos), **kw)
    ours, none = TL.attn_apply(tp, torch.tensor(x), tdims,
                               positions=torch.tensor(pos), **kw)
    assert none is None
    close(ours, ref)
    # prefill into a longer cache, then one decode row at index S
    jc = {"k": jnp.zeros((2, max_len, 4, 16)), "v": jnp.zeros((2, max_len, 4,
                                                               16))}
    tc = {"k": torch.zeros((2, max_len, 4, 16)),
          "v": torch.zeros((2, max_len, 4, 16))}
    ref, jc = RL.attn_apply(p, jnp.asarray(x), dims,
                            positions=jnp.asarray(pos), cache=jc,
                            cache_index=jnp.int32(0), **kw)
    ours, tc2 = TL.attn_apply(tp, torch.tensor(x), tdims,
                              positions=torch.tensor(pos), cache=tc,
                              cache_index=0, **kw)
    assert tc2 is tc                                   # updated in place
    close(ours, ref)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])
    x1 = activations(3, 2, 1, 64)
    ref, jc = RL.attn_apply(p, jnp.asarray(x1), dims,
                            positions=jnp.full((2, 1), S), cache=jc,
                            cache_index=jnp.int32(S), **kw)
    ours, tc = TL.attn_apply(tp, torch.tensor(x1), tdims,
                             positions=torch.full((2, 1), S), cache=tc,
                             cache_index=S, **kw)
    close(ours, ref)
    close(tc["k"], jc["k"])


def test_mamba2_full_prefill_and_decode(zamba):
    L = 32
    jp = jax.tree.map(lambda a: a[0], zamba.jparams["layers"]["p0"])
    tp = zamba.params["layers"][0][0]
    x = activations(4, 2, L, 64)
    ref, _ = RB.mamba2_apply(jp, jnp.asarray(x), zamba.jctx("full", L), None)
    ours, none = TB.mamba2_apply(tp, torch.tensor(x), zamba.ctx("full", L),
                                 None)
    assert none is None
    close(ours, ref)
    # with a cache: the state and conv window handed to decode
    jcache = RB.mamba2_cache(zamba.jcfg, 2, jnp.float32)
    tcache = TB.mamba2_cache(zamba.cfg, 2, torch.float32, "cpu")
    ref, jcache = RB.mamba2_apply(jp, jnp.asarray(x), zamba.jctx("full", L),
                                  jcache)
    ours, tcache = TB.mamba2_apply(tp, torch.tensor(x), zamba.ctx("full", L),
                                   tcache)
    close(ours, ref)
    close(tcache["state"], jcache["state"])
    close(tcache["conv"], jcache["conv"])
    for step in range(3):
        x1 = activations(5 + step, 2, 1, 64)
        ref, jcache = RB.mamba2_apply(jp, jnp.asarray(x1),
                                      zamba.jctx("decode", 1), jcache)
        ours, tcache = TB.mamba2_apply(tp, torch.tensor(x1),
                                       zamba.ctx("decode", 1), tcache)
        close(ours, ref)
        close(tcache["state"], jcache["state"])
        close(tcache["conv"], jcache["conv"])


def test_causal_conv_is_shifted_products(zamba):
    x = activations(9, 2, 7, 12)
    w = activations(10, 4, 12)
    close(TB._causal_conv(torch.tensor(x), torch.tensor(w)),
          RB._causal_conv(jnp.asarray(x), jnp.asarray(w)))


# ---------------------------- whole model ----------------------------------

@pytest.mark.parametrize("which", ["zamba", "gemma", "arctic", "xlstm"])
def test_forward_prefill_and_teacher_forced_decode(which, request):
    m = request.getfixturevalue(which)
    toks = m.tokens
    full = m.j_forward(m.jparams, jnp.asarray(toks))
    ours, none = TM.forward(m.cfg, m.dims, m.params,
                            {"tokens": torch.tensor(toks)})
    assert none is None and tuple(ours.shape) == (2, S_FULL, m.cfg.vocab)
    close_model(ours, full)
    assert torch.equal(TM.make_forward(m.cfg, m.dims)(
        m.params, {"tokens": torch.tensor(toks)}), ours)

    prompt = {"tokens": jnp.asarray(toks[:, :S_PROMPT])}
    jlast, jcache = m.j_prefill(m.jparams, prompt)
    last, cache = TM.prefill(m.cfg, m.dims, m.params,
                             {"tokens": torch.tensor(toks[:, :S_PROMPT])},
                             max_cache_len=S_FULL + 8)
    close_model(last, jlast)
    for si in range(m.cfg.n_super_blocks):
        for pi in range(len(m.cfg.block_pattern)):
            ref = jax.tree.map(lambda a: a[si], jcache[f"p{pi}"])
            ours = cache[si][pi]
            assert jax.tree.structure(ref) == jax.tree.structure(
                jax.tree.map(lambda t: 0, ours))
            for r, o in zip(jax.tree.leaves(ref), jax.tree.leaves(ours)):
                assert tuple(o.shape) == r.shape
                close_model(o, r)

    for i in range(S_PROMPT, S_PROMPT + 4):
        tok = toks[:, i:i + 1]
        jl, jcache = m.j_decode(m.jparams, jnp.asarray(tok), jcache,
                                jnp.int32(i))
        tl, cache = TM.decode_step(m.cfg, m.dims, m.params,
                                   torch.tensor(tok), cache, i)
        close_model(tl, jl)
        close_model(tl, full[:, i])


def test_serve_greedy_tokens_match_reference_loop(zamba, monkeypatch):
    """``serve.main`` on the CPU with the reference's weights (float32)
    against a greedy prefill + decode loop of the JAX package."""
    B, P, G = 2, 32, 8
    monkeypatch.setattr(serve, "reduced", lambda cfg: zamba.cfg)
    monkeypatch.setattr(serve, "init_params",
                        lambda cfg, dims, generator: zamba.params)
    out = serve.main(["--arch", "zamba2-2.7b", "--smoke", "--batch", str(B),
                      "--prompt-len", str(P), "--gen", str(G),
                      "--device", "cpu"])
    assert tuple(out["tokens"].shape) == (B, G)
    prompt = synth_batch(zamba.cfg, batch=B, seq=P, seed=0)["tokens"]
    prefill = jax.jit(RM.make_prefill_step(zamba.jcfg, zamba.jdims,
                                           max_cache_len=P + G))
    logits, cache = prefill(zamba.jparams,
                            {"tokens": jnp.asarray(prompt.numpy())})
    toks = [jnp.argmax(logits, axis=-1)[:, None]]
    for i in range(G - 1):
        logits, cache = zamba.j_decode(zamba.jparams, toks[-1], cache,
                                       jnp.int32(P + i))
        toks.append(jnp.argmax(logits, axis=-1)[:, None])
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(toks, axis=1)))


# ----------------------------- the contract --------------------------------

def test_port_init_matches_reference_layout():
    """The port's own random weights have the carried weights' shapes."""
    cfg = reduced(TM.get_arch("zamba2-2.7b"))
    dims = TM.ModelDims.create(cfg)
    ours = TM.init_params(cfg, dims,
                          generator=torch.Generator().manual_seed(0))
    jcfg = ref_reduced(RM.get_arch("zamba2-2.7b"))
    tree = jax.tree.map(np.asarray, RM.init_params(
        jcfg, jax.random.PRNGKey(0), RM.ModelDims.create(jcfg, tp=1)))
    carried = params_from_numpy(cfg, tree, device="cpu")

    def shapes(t):
        return jax.tree.map(lambda a: (tuple(a.shape), a.dtype), t)
    assert shapes(ours) == shapes(carried)
    assert ours["embed"].dtype == torch.bfloat16
    assert ours["layers"][0][0]["A_log"].dtype == torch.float32
    assert 0.5 * cfg.param_count() < sum(
        a.numel() for a in jax.tree.leaves(ours)) < 2.0 * cfg.param_count()


def test_configs_are_the_reference_configs():
    from repro.configs import ASSIGNED
    from repro_torch.configs import ASSIGNED as PORT_ASSIGNED
    assert PORT_ASSIGNED == ASSIGNED
    assert TM.list_archs() == RM.list_archs()
    for name in ASSIGNED:
        ref, ours = RM.get_arch(name), TM.get_arch(name)
        assert repr(ours) == repr(ref).replace("repro.models.config",
                                               "repro_torch.models.config")
        assert ours.param_count() == ref.param_count()


def test_serve_needs_a_device_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-2.7b", "--smoke", "--gen", "2"])
