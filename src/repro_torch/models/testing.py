"""Reduced configs, synthetic batches and seeded weights for tests and
smoke runs (counterpart of ``repro.models.testing``).

``reduced`` is the reference's reduction.  ``synth_batch`` and
``numpy_tree`` draw from numpy generators, so a test or a fixture script
can hand the same tokens and weights to the JAX package and to the port.
``teacher_forced`` runs a model the three ways the reference fixture
(``scripts/make_torch_lm_golden.py``) records; ``train_steps`` and
``train_fixture_errors`` run and hold three training steps against the
reference's (``scripts/make_torch_train_golden.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .config import ArchConfig, BlockKind, MLPKind, MoEConfig, SSMConfig
from .transformer import ModelDims, decode_step, forward, prefill


def reduced(cfg: ArchConfig, n_super: int = 2) -> ArchConfig:
    p = len(cfg.block_pattern)
    hd = 16
    n_heads = 4
    n_kv = max(1, min(cfg.n_kv_heads * n_heads // max(cfg.n_heads, 1), n_heads))
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(n_experts=8, top_k=min(cfg.moe.top_k, 2),
                        expert_d_ff=96,
                        n_shared_experts=min(cfg.moe.n_shared_experts, 1),
                        dense_residual=cfg.moe.dense_residual, dense_d_ff=96,
                        capacity_factor=4.0)
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=p * n_super, d_model=64,
        n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd,
        d_ff=0 if cfg.d_ff == 0 else 128, vocab=512, moe=moe, ssm=ssm,
        cross_ctx_len=16 if cfg.cross_ctx_len else 0, attn_q_chunk=64)


def synth_batch(cfg: ArchConfig, batch: int = 2, seq: int = 32,
                seed: int = 0, device=None) -> dict:
    """Seeded ``tokens`` and ``labels`` (int64 ``[batch, seq]``) on
    ``device``; ``frames`` ([batch, seq, d], bf16) for frontend stubs;
    ``cross_ctx`` ([batch, cross_ctx_len, d], bf16, as the reference's
    ``synth_batch`` makes it) for a VLM."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    if cfg.frontend_stub:
        out["frames"] = torch.tensor(
            rng.standard_normal((batch, seq, cfg.d_model), np.float32),
            device=device).to(torch.bfloat16)
    else:
        out["tokens"] = torch.tensor(
            rng.integers(0, cfg.vocab, (batch, seq)), device=device)
    out["labels"] = torch.tensor(rng.integers(0, cfg.vocab, (batch, seq)),
                                 device=device)
    if cfg.cross_ctx_len:
        out["cross_ctx"] = torch.tensor(
            rng.standard_normal((batch, cfg.cross_ctx_len, cfg.d_model),
                                np.float32), device=device).to(torch.bfloat16)
    return out


def numpy_tree(cfg: ArchConfig, seed: int = 0,
               tie_router: bool = False,
               dims: Optional[ModelDims] = None) -> dict:
    """Seeded float32 weights in the JAX package's parameter layout.

    The tree ``repro.models.init_params`` returns (per pattern position the
    parameters stacked over super-blocks), drawn from a numpy generator:
    dense weights at the reference's scale, and norm scales, ``A_log``,
    ``D`` and ``dt_bias`` spread around the reference's constants so that
    every term shows.  ``jax.tree.map(jnp.asarray, tree)`` gives the
    reference its parameters; ``models.convert.params_from_numpy`` gives
    the port its own.  A cross block's gate ``xgate`` is drawn from U[0.5, 1)
    (tanh 0.46 to 0.76): the reference initialises it to 0, where the cross
    branch adds nothing and a parity test would check none of it.
    ``tie_router`` copies router column 0 into column 1, so experts 0 and 1 tie
    on every token's router logits.  ``dims``: the padded counts of
    ``ModelDims.create(cfg, tp)`` (heads, KV heads, experts, vocab; default
    tp = 1, the unpadded model), the padded entries drawn like the rest.
    """
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.hd
    dims = dims or ModelDims.create(cfg)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def dense(d_in, d_out, bias=False):
        p = {"w": normal((d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = normal((d_out,), 0.1)
        return p

    def norm(n):
        return {"scale": (1.0 + normal((n,), 0.1))}

    def swiglu(d_ff):
        return {"wi": dense(d, d_ff), "wg": dense(d, d_ff),
                "wo": dense(d_ff, d)}

    def moe_layer():
        m = cfg.moe
        E, f = dims.expert_pad, m.expert_d_ff
        p = {"router": normal((d, m.n_experts), 1.0 / math.sqrt(d)),
             "wi": normal((E, d, f), 1.0 / math.sqrt(d)),
             "wg": normal((E, d, f), 1.0 / math.sqrt(d)),
             "wo": normal((E, f, d), 1.0 / math.sqrt(f))}
        if tie_router:
            p["router"][:, 1] = p["router"][:, 0]
        if m.n_shared_experts:
            p["shared"] = swiglu(m.n_shared_experts * f)
        return p

    def attn():
        return {"wq": dense(d, dims.n_q_pad * hd, cfg.qkv_bias),
                "wk": dense(d, dims.n_kv_pad * hd, cfg.qkv_bias),
                "wv": dense(d, dims.n_kv_pad * hd, cfg.qkv_bias),
                "wo": dense(dims.n_q_pad * hd, d)}

    def attn_block(kind=BlockKind.ATTN):
        p = {"ln1": norm(d), "ln2": norm(d), "attn": attn()}
        if kind == BlockKind.MOE:
            p["moe"] = moe_layer()
            if cfg.moe.dense_residual:
                p["dense_mlp"] = swiglu(cfg.moe.dense_d_ff)
        elif cfg.mlp in (MLPKind.SWIGLU, MLPKind.GEGLU):
            p["mlp"] = {"wi": dense(d, cfg.d_ff), "wg": dense(d, cfg.d_ff),
                        "wo": dense(cfg.d_ff, d)}
        elif cfg.mlp != MLPKind.NONE:
            p["mlp"] = {"wi": dense(d, cfg.d_ff), "wo": dense(cfg.d_ff, d)}
        if kind == BlockKind.CROSS_ATTN:
            p["ln_x"] = norm(d)
            p["xattn"] = attn()
            p["xgate"] = np.asarray(rng.uniform(0.5, 1.0), np.float32)
        return p

    def mamba_block():
        s = cfg.ssm
        d_inner = s.expand * d
        H = d_inner // s.head_dim
        return {"ln": norm(d),
                "in_proj": dense(d, 2 * d_inner + 2 * s.d_state + H),
                "conv_w": normal((s.d_conv, d_inner + 2 * s.d_state),
                                 1.0 / math.sqrt(s.d_conv)),
                "A_log": rng.uniform(-1.0, 0.5, H).astype(np.float32),
                "D": rng.uniform(0.5, 1.5, H).astype(np.float32),
                "dt_bias": normal((H,), 0.5),
                "out_proj": dense(d_inner, d)}

    def mlstm_block():
        return {"ln": norm(d), "wq": dense(d, d), "wk": dense(d, d),
                "wv": dense(d, d), "wif": dense(d, 2 * cfg.n_heads, True),
                "wo_gate": dense(d, d), "out": dense(d, d)}

    def slstm_block():
        dh = d // cfg.n_heads
        return {"ln": norm(d), "wx": dense(d, 4 * d, True),
                "r": normal((cfg.n_heads, dh, 4 * dh), 1.0 / math.sqrt(dh)),
                "out": dense(d, d)}

    def stacked(make):
        trees = [make() for _ in range(cfg.n_super_blocks)]
        return _stack(trees)

    layers = {}
    for pi, kind in enumerate(cfg.block_pattern):
        if kind in (BlockKind.ATTN, BlockKind.MOE, BlockKind.CROSS_ATTN):
            layers[f"p{pi}"] = stacked(lambda: attn_block(kind))
        elif kind == BlockKind.MAMBA2:
            layers[f"p{pi}"] = stacked(mamba_block)
        elif kind == BlockKind.MLSTM:
            layers[f"p{pi}"] = stacked(mlstm_block)
        elif kind == BlockKind.SLSTM:
            layers[f"p{pi}"] = stacked(slstm_block)
        elif kind == BlockKind.SHARED_ATTN:
            layers[f"p{pi}"] = {}
        else:
            raise KeyError(kind)
    tree = {"embed": normal((dims.vocab_pad, d), 0.02), "layers": layers,
            "final_ln": norm(d)}
    if BlockKind.SHARED_ATTN in cfg.block_pattern:
        tree["shared_attn"] = attn_block()
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense(d, dims.vocab_pad)
    return tree


def _stack(trees: list) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def teacher_forced(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                   prompt_len: int, max_len: int,
                   cross_ctx: Optional[torch.Tensor] = None) -> dict:
    """Logits of one model on ``tokens`` [B, S] (and a VLM's
    ``cross_ctx``), three ways: the full forward (``forward``, [B, S,
    vocab]), a prefill of the first ``prompt_len`` tokens into a cache of
    ``max_len`` positions (``prefill_last``, [B, vocab]) and
    teacher-forced decode steps over the rest (``decode``, [S -
    prompt_len, B, vocab])."""
    dims = ModelDims.create(cfg)
    full, _ = forward(cfg, dims, params, {"tokens": tokens,
                                          "cross_ctx": cross_ctx})
    last, cache = prefill(cfg, dims, params,
                          {"tokens": tokens[:, :prompt_len],
                           "cross_ctx": cross_ctx}, max_len)
    steps = []
    for i in range(prompt_len, tokens.shape[1]):
        logits, cache = decode_step(cfg, dims, params, tokens[:, i:i + 1],
                                    cache, i, cross_ctx=cross_ctx)
        steps.append(logits)
    return {"forward": full, "prefill_last": last,
            "decode": torch.stack(steps)}


# Three AdamW steps (lr 1e-2) of reduced zamba2 against the reference's,
# float32.  Adam's first steps divide each gradient by its own size, so an
# entry whose gradient is near zero moves by a step's size on a last-bit
# difference of that gradient, and the lr = 1e-2 steps carry such moves
# on: the CPU port leaves the reference's parameters by up to 0.026 in a
# few hundred of 377 136 entries after three steps, and its grad_norm by
# 2e-3 relative at step 3.  So the parameters are held by the norm of the
# difference over the norm of the reference's own update (0.006 on the
# CPU), the losses and norms relative to themselves.
TRAIN_TOL = {"loss": 2e-4, "grad_norm": 1e-2, "params": 2e-2}


def flat_numpy(tree: dict, prefix: str) -> dict:
    """``{prefix/path: float32 array}`` over a nested dictionary of arrays
    (the fixture's key names)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_numpy(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def train_steps(cfg: ArchConfig, fix: dict, device) -> dict:
    """The fixture's three training steps run by the port on ``device``
    (float32, from the fixture's weight seed and batches): ``loss`` and
    ``grad_norm`` per step, and ``params``, the final parameters in the
    fixture's flat layout."""
    from repro_torch.launch.platform import device_fetch
    from repro_torch.models.convert import numpy_from_params, \
        params_from_numpy
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw
    dims = ModelDims.create(cfg)
    params = params_from_numpy(cfg, numpy_tree(cfg, int(fix["weight_seed"])),
                               device=device, dtype=torch.float32)
    opt = AdamWConfig(lr=float(fix["lr"]),
                      warmup_steps=int(fix["warmup_steps"]))
    state = adamw.init_state(opt, params)
    step = make_train_step(cfg, dims, opt, device=device)
    metrics = []
    for i in range(len(fix["loss"])):
        params, state, m = step(params, state, {"tokens": fix["tokens"][i],
                                                "labels": fix["labels"][i]})
        metrics.append((m["loss"], m["grad_norm"]))
    host = device_fetch(*(t for pair in metrics for t in pair))
    return {"loss": np.asarray(host[0::2], np.float32),
            "grad_norm": np.asarray(host[1::2], np.float32),
            "params": flat_numpy(numpy_from_params(cfg, params), "params")}


def train_fixture_errors(fix: dict, run: dict) -> dict:
    """The errors ``TRAIN_TOL`` bounds: the largest relative error of the
    losses and of the grad norms, and ``|params - fixture|`` over
    ``|fixture - initial params|`` (L2 over every entry)."""
    init = flat_numpy(numpy_tree(_fixture_config(fix), int(
        fix["weight_seed"])), "params")
    keys = sorted(run["params"])
    if keys != sorted(k for k in fix if k.startswith("params/")):
        raise KeyError("the run's parameters are not the fixture's")
    diff = sum(float(((run["params"][k] - fix[k]) ** 2).sum()) for k in keys)
    moved = sum(float(((fix[k] - init[k]) ** 2).sum()) for k in keys)
    return {k: float(np.max(np.abs(run[k] - fix[k]) / np.abs(fix[k])))
            for k in ("loss", "grad_norm")} | {
        "params": math.sqrt(diff / moved)}


def _fixture_config(fix: dict) -> ArchConfig:
    from .config import get_arch
    return dataclasses.replace(reduced(get_arch(str(fix["arch"]))),
                               dtype="float32")
