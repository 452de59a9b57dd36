"""The port's cross-attention VLM against the JAX reference.

Reduced ``llama-3.2-vision-90b`` (``models.testing.reduced``: two
super-blocks of four ``ATTN`` blocks and one ``CROSS_ATTN`` block, d_model
64, 4 query heads over 1 kv head, a context of 16 rows), float32, with the
same seeded numpy weights in both packages (``models.testing.numpy_tree``,
carried by ``models.convert.params_from_numpy``).  ``numpy_tree`` draws
each cross block's gate ``xgate`` from U[0.5, 1): at the reference's own
initial gate, 0, the cross branch adds nothing and no check here would
see it (``test_cross_gate_moves_the_logits``).

Layer by layer: ``attn_apply`` with ``kv=`` (the context's projected keys
and values), the cross block in full mode with a cache and in decode.  The
whole model: forward logits, prefill into a longer cache (last logits and
every cache entry), teacher-forced decode, greedy serving through
``serve.main``.  Two type rules of the reference: a bf16 context in a
float32 model gives a bf16 cross cache and bf16 cross-attention
(``dense`` casts the weights to the context's type, ``_sdpa`` the
probabilities to v's), and a bf16 model given a float32 context is
refused with ``TypeError`` (its scan over super-blocks cannot carry the
promoted residual stream).

Tolerances as in ``tests/test_torch_models.py``: layers 1e-5 (rtol and
atol), whole models ``max |port - reference| <= 5e-5 * max |reference|``,
with a float32 context.  With the bf16 context the cross branch rounds its
keys, values, probabilities and output to bf16 in both packages, in their
own summation orders, so a last-bit difference there moves the logits by
up to a bf16 step: held to ``BF16_MODEL_REL = 2e-3`` of the largest logit,
half of bf16's relative step 2^-8 (the forward reads 4.4e-5, prefill and
decode about 1e-6).
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
from repro_torch.models.config import BlockKind
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.testing import (numpy_tree, reduced, synth_batch,
                                        teacher_forced)

ARCH = "llama-3.2-vision-90b"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_REL = 5e-5
BF16_MODEL_REL = 2e-3
S_FULL, S_PROMPT = 64, 48
CROSS = 4                       # the cross block's pattern position


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(ours, ref, tol=LAYER_TOL):
    np.testing.assert_allclose(as_np(ours), as_np(ref), **tol)


def rel_err(ours, ref) -> float:
    ref = as_np(ref)
    return float(np.abs(as_np(ours) - ref).max() / np.abs(ref).max())


def activations(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class VLM:
    """Reduced llama-3.2-vision-90b in both packages, float32, the same
    numpy weights (``xgate`` nonzero) and a float32 context."""

    def __init__(self, seed=0):
        self.jcfg = dataclasses.replace(ref_reduced(RM.get_arch(ARCH)),
                                        dtype="float32")
        self.cfg = dataclasses.replace(reduced(TM.get_arch(ARCH)),
                                       dtype="float32")
        self.tree = numpy_tree(self.cfg, seed)
        self.jdims = RM.ModelDims.create(self.jcfg, tp=1)
        self.dims = TM.ModelDims.create(self.cfg)
        self.jparams = jax.tree.map(jnp.asarray, self.tree)
        self.params = params_from_numpy(self.cfg, self.tree, device="cpu",
                                        dtype=torch.float32)
        self.tokens = np.random.default_rng(1).integers(
            0, self.cfg.vocab, (2, S_FULL))
        self.cross = activations(2, 2, self.cfg.cross_ctx_len,
                                 self.cfg.d_model)
        cfg, dims = self.jcfg, self.jdims
        self.j_forward = jax.jit(lambda p, b: RM.forward(cfg, dims, p, b)[0])
        self.j_prefill = jax.jit(RM.make_prefill_step(
            cfg, dims, max_cache_len=S_FULL + 8))
        self.j_decode = jax.jit(RM.make_decode_step(cfg, dims))

    def jctx(self, mode, positions, **kw):
        return RB.BlockCtx(cfg=self.jcfg, mode=mode,
                           positions=jnp.asarray(positions),
                           n_q_pad=self.jdims.n_q_pad,
                           n_kv_pad=self.jdims.n_kv_pad, **kw)

    def ctx(self, mode, positions, **kw):
        return TB.BlockCtx(cfg=self.cfg, mode=mode,
                           positions=torch.tensor(positions),
                           n_q_pad=self.dims.n_q_pad,
                           n_kv_pad=self.dims.n_kv_pad, **kw)

    def cross_block(self, si=0):
        """Super-block ``si``'s cross block: reference and port weights."""
        return (jax.tree.map(lambda a: a[si],
                             self.jparams["layers"][f"p{CROSS}"]),
                self.params["layers"][si][CROSS])

    def teacher_forced_ref(self, toks, cross):
        """The reference's forward, prefill and teacher-forced decode."""
        full = self.j_forward(self.jparams, {"tokens": jnp.asarray(toks),
                                             "cross_ctx": cross})
        last, cache = self.j_prefill(self.jparams, {
            "tokens": jnp.asarray(toks[:, :S_PROMPT]), "cross_ctx": cross})
        steps = [last]
        for i in range(S_PROMPT, S_FULL):
            logits, cache = self.j_decode(self.jparams,
                                          jnp.asarray(toks[:, i:i + 1]),
                                          cache, jnp.int32(i), cross)
            steps.append(logits)
        return full, cache, steps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite's test
    workers share the cores, and torch's default pool (a thread per core
    in each worker) oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vlm():
    return VLM()


# ------------------------------- layers ------------------------------------

@pytest.mark.parametrize("S,q_chunk", [(20, 0), (32, 8), (1, 64)])
def test_attn_apply_over_context_keys_and_values(vlm, S, q_chunk):
    """``kv=`` attends non-causally over the given keys and values, with
    no RoPE at theta 0 (the cross block's call) and with it at theta > 0;
    query chunks past ``q_chunk``; one decode row."""
    jp, tp = vlm.cross_block()
    dims = RL.AttnDims(64, 4, 1, 16)
    tdims = TL.AttnDims(64, 4, 1, 16)
    x = activations(3, 2, S, 64)
    ck, cv = activations(4, 2, 16, 1, 16), activations(5, 2, 16, 1, 16)
    pos = np.arange(7, 7 + S)[None, :]
    for theta in (0.0, 10000.0):
        kw = dict(causal=True, theta=theta, q_chunk=q_chunk)
        ref, none_j = RL.attn_apply(jp["xattn"], jnp.asarray(x), dims,
                                    positions=jnp.asarray(pos),
                                    kv=(jnp.asarray(ck), jnp.asarray(cv)),
                                    **kw)
        ours, none = TL.attn_apply(tp["xattn"], torch.tensor(x), tdims,
                                   positions=torch.tensor(pos),
                                   kv=(torch.tensor(ck), torch.tensor(cv)),
                                   **kw)
        assert none is None and none_j is None
        close(ours, ref)


def test_cross_block_full_with_cache_then_decode(vlm):
    """The cross block in full mode with a cache (prefill: the context is
    projected and stored in ``cache["cross"]``), then three decode steps
    that read it and leave it as it was."""
    jp, tp = vlm.cross_block(1)
    S, max_len, T = 12, 16, vlm.cfg.cross_ctx_len
    x = activations(6, 2, S, 64)
    cross = activations(7, 2, T, 64)
    pos = np.arange(S)[None, :]
    jctx = vlm.jctx("full", pos, cache_index=jnp.int32(0),
                    cross_ctx=jnp.asarray(cross), max_cache_len=max_len)
    tctx = vlm.ctx("full", pos, cache_index=0,
                   cross_ctx=torch.tensor(cross), max_cache_len=max_len)
    jcache = RB.attn_block_cache(vlm.jcfg, jctx, 2, jnp.float32,
                                 RB.BlockKind.CROSS_ATTN)
    tcache = TB.attn_block_cache(vlm.cfg, tctx, 2, torch.float32, "cpu",
                                 BlockKind.CROSS_ATTN)
    assert tuple(tcache["cross"]["k"].shape) == (2, T, 1, 16)
    ref, jcache = RB.attn_block_apply(jp, jnp.asarray(x), jctx, jcache,
                                      RB.BlockKind.CROSS_ATTN)
    ours, tcache = TB.attn_block_apply(tp, torch.tensor(x), tctx, tcache,
                                       BlockKind.CROSS_ATTN)
    close(ours, ref)
    for entry in ("self", "cross"):
        for kv in ("k", "v"):
            close(tcache[entry][kv], jcache[entry][kv])
    stored = tcache["cross"]["k"]
    for step in range(3):
        i = S + step
        x1 = activations(8 + step, 2, 1, 64)
        # decode reads the cache: no context is given
        ref, jcache = RB.attn_block_apply(
            jp, jnp.asarray(x1), vlm.jctx("decode", [[i]] * 2,
                                          cache_index=jnp.int32(i)),
            jcache, RB.BlockKind.CROSS_ATTN)
        ours, tcache = TB.attn_block_apply(
            tp, torch.tensor(x1), vlm.ctx("decode", [[i]] * 2,
                                          cache_index=i),
            tcache, BlockKind.CROSS_ATTN)
        close(ours, ref)
        close(tcache["self"]["k"], jcache["self"]["k"])
        assert tcache["cross"]["k"] is stored


def test_cross_block_without_context_raises(vlm):
    _, tp = vlm.cross_block()
    with pytest.raises(ValueError, match="cross_ctx"):
        TB.attn_block_apply(tp, torch.zeros(1, 4, 64),
                            vlm.ctx("full", np.arange(4)[None, :]), None,
                            BlockKind.CROSS_ATTN)


# ---------------------------- whole model ----------------------------------

def test_forward_prefill_and_teacher_forced_decode(vlm):
    """Float32 context: forward, the prefill's last logits and every cache
    entry, teacher-forced decode, each against the reference, and the
    decode steps against the reference's full forward."""
    toks, cross = vlm.tokens, vlm.cross
    full, jcache, jsteps = vlm.teacher_forced_ref(toks, jnp.asarray(cross))
    tcross = torch.tensor(cross)
    ours = teacher_forced(vlm.cfg, vlm.params, torch.tensor(toks),
                          S_PROMPT, S_FULL + 8, tcross)
    assert rel_err(ours["forward"], full) <= MODEL_REL
    assert rel_err(ours["prefill_last"], jsteps[0]) <= MODEL_REL
    for i, (tl, jl) in enumerate(zip(ours["decode"], jsteps[1:])):
        assert rel_err(tl, jl) <= MODEL_REL
        assert rel_err(tl, full[:, S_PROMPT + i]) <= MODEL_REL
    assert torch.equal(TM.make_forward(vlm.cfg, vlm.dims)(
        vlm.params, {"tokens": torch.tensor(toks), "cross_ctx": tcross}),
        ours["forward"])
    # the cache after the teacher-forced steps, entry by entry
    _, cache = TM.prefill(vlm.cfg, vlm.dims, vlm.params,
                          {"tokens": torch.tensor(toks[:, :S_PROMPT]),
                           "cross_ctx": tcross}, S_FULL + 8)
    for i in range(S_PROMPT, S_FULL):
        _, cache = TM.decode_step(vlm.cfg, vlm.dims, vlm.params,
                                  torch.tensor(toks[:, i:i + 1]), cache, i)
    for si in range(vlm.cfg.n_super_blocks):
        for pi in range(len(vlm.cfg.block_pattern)):
            ref = jax.tree.map(lambda a: a[si], jcache[f"p{pi}"])
            assert jax.tree.structure(ref) == jax.tree.structure(
                jax.tree.map(lambda t: 0, cache[si][pi]))
            for r, o in zip(jax.tree.leaves(ref),
                            jax.tree.leaves(cache[si][pi])):
                assert tuple(o.shape) == r.shape and o.dtype == torch.float32
                assert rel_err(o, r) <= MODEL_REL


def test_serve_greedy_tokens_match_reference_loop(vlm, monkeypatch):
    """``serve.main`` on the CPU (its bf16 ``synth_batch`` context handed
    to every decode step) against a greedy prefill + decode loop of the
    JAX package on the same weights, prompt and context."""
    B, P, G = 2, 32, 8
    monkeypatch.setattr(serve, "reduced", lambda cfg: vlm.cfg)
    monkeypatch.setattr(serve, "init_params",
                        lambda cfg, dims, generator: vlm.params)
    out = serve.main(["--arch", ARCH, "--smoke", "--batch", str(B),
                      "--prompt-len", str(P), "--gen", str(G),
                      "--device", "cpu"])
    assert tuple(out["tokens"].shape) == (B, G)
    batch = synth_batch(vlm.cfg, batch=B, seq=P, seed=0)
    cross = jnp.asarray(batch["cross_ctx"].float().numpy(), jnp.bfloat16)
    prefill = jax.jit(RM.make_prefill_step(vlm.jcfg, vlm.jdims,
                                           max_cache_len=P + G))
    logits, cache = prefill(vlm.jparams, {
        "tokens": jnp.asarray(batch["tokens"].numpy()), "cross_ctx": cross})
    toks = [jnp.argmax(logits, axis=-1)[:, None]]
    for i in range(G - 1):
        logits, cache = vlm.j_decode(vlm.jparams, toks[-1], cache,
                                     jnp.int32(P + i), cross)
        toks.append(jnp.argmax(logits, axis=-1)[:, None])
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(toks, axis=1)))


def test_bf16_context_in_a_float32_model(vlm):
    """A bf16 context (``synth_batch``'s) in the float32 model: the cross
    cache is bf16 in both packages while the self cache is float32, and
    the logits agree to ``BF16_MODEL_REL``."""
    toks = vlm.tokens
    cross = vlm.cross.astype(jnp.bfloat16)
    full, jcache, jsteps = vlm.teacher_forced_ref(toks, jnp.asarray(cross))
    tcross = torch.tensor(vlm.cross).bfloat16()
    ours = teacher_forced(vlm.cfg, vlm.params, torch.tensor(toks),
                          S_PROMPT, S_FULL + 8, tcross)
    assert rel_err(ours["forward"], full) <= BF16_MODEL_REL
    assert rel_err(ours["prefill_last"], jsteps[0]) <= BF16_MODEL_REL
    for tl, jl in zip(ours["decode"], jsteps[1:]):
        assert rel_err(tl, jl) <= BF16_MODEL_REL
    _, cache = TM.prefill(vlm.cfg, vlm.dims, vlm.params,
                          {"tokens": torch.tensor(toks[:, :S_PROMPT]),
                           "cross_ctx": tcross}, S_FULL + 8)
    jc = jcache[f"p{CROSS}"]
    assert jc["cross"]["k"].dtype == jnp.bfloat16
    assert jc["self"]["k"].dtype == jnp.float32
    for si in range(vlm.cfg.n_super_blocks):
        tc = cache[si][CROSS]
        assert tc["cross"]["k"].dtype == tc["cross"]["v"].dtype \
            == torch.bfloat16
        assert tc["self"]["k"].dtype == torch.float32
        for kv in ("k", "v"):
            np.testing.assert_allclose(as_np(tc["cross"][kv]),
                                       as_np(jc["cross"][kv][si]),
                                       rtol=1e-2, atol=1e-2)


def test_bf16_model_with_a_float32_context_raises(vlm):
    """The reference refuses it (its super-block scan cannot carry the
    float32 residual the cross branch makes); so does the port."""
    jcfg = dataclasses.replace(vlm.jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(vlm.cfg, dtype="bfloat16")
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                           vlm.tree)
    jparams["layers"][f"p{CROSS}"]["xgate"] = vlm.jparams["layers"][
        f"p{CROSS}"]["xgate"]
    batch = {"tokens": jnp.asarray(vlm.tokens[:, :16]),
             "cross_ctx": jnp.asarray(vlm.cross)}
    with pytest.raises(TypeError, match="carry"):
        RM.forward(jcfg, vlm.jdims, jparams, batch)
    params = params_from_numpy(cfg, vlm.tree, device="cpu",
                               dtype=torch.bfloat16)
    assert params["layers"][0][CROSS]["xgate"].dtype == torch.float32
    tbatch = {"tokens": torch.tensor(vlm.tokens[:, :16]),
              "cross_ctx": torch.tensor(vlm.cross)}
    with pytest.raises(TypeError, match="float32"):
        TM.forward(cfg, vlm.dims, params, tbatch)
    # with the context in the model's type it runs
    tbatch["cross_ctx"] = tbatch["cross_ctx"].bfloat16()
    logits, _ = TM.forward(cfg, vlm.dims, params, tbatch)
    assert logits.dtype == torch.bfloat16 and bool(
        torch.isfinite(logits.float()).all())


def test_cross_gate_moves_the_logits(vlm):
    """With every ``xgate`` at 0 (the reference's initial value) the cross
    branch adds nothing: the logits move by far more than the tolerance,
    and no longer depend on the context."""
    toks = {"tokens": torch.tensor(vlm.tokens[:, :S_PROMPT]),
            "cross_ctx": torch.tensor(vlm.cross)}
    gated, _ = TM.forward(vlm.cfg, vlm.dims, vlm.params, toks)
    closed = {**vlm.params, "layers": [
        [dict(p, xgate=torch.zeros(())) if "xgate" in p else p
         for p in layer] for layer in vlm.params["layers"]]}
    shut, _ = TM.forward(vlm.cfg, vlm.dims, closed, toks)
    assert rel_err(shut, gated) > 100 * MODEL_REL
    other = dict(toks, cross_ctx=torch.tensor(activations(
        9, *vlm.cross.shape)))
    assert torch.equal(TM.forward(vlm.cfg, vlm.dims, closed, other)[0],
                       shut)
    assert rel_err(TM.forward(vlm.cfg, vlm.dims, vlm.params, other)[0],
                   gated) > 100 * MODEL_REL


def test_port_init_has_the_numpy_tree_layout(vlm):
    """The port's own random weights have the carried weights' shapes and
    types, ``xgate`` a float32 scalar at 0 in a bf16 model."""
    ours = TM.init_params(vlm.cfg, vlm.dims,
                          generator=torch.Generator().manual_seed(0))
    carried = params_from_numpy(vlm.cfg, vlm.tree, device="cpu")

    def shapes(t):
        return jax.tree.map(lambda a: (tuple(a.shape), a.dtype), t)
    assert shapes(ours) == shapes(carried)
    gate = ours["layers"][0][CROSS]["xgate"]
    assert gate.dtype == torch.float32 and float(gate) == 0.0
    assert TB.NOT_PORTED == ()
