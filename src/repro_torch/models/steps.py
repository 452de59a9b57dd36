"""Step functions: prefill / decode / forward, built per architecture
(counterpart of ``repro.models.steps``; the training and eval steps wait
for the port of ``optim/`` and ``loss_fn``, ROADMAP.md open item 13).

The reference returns functions for ``jax.jit``; PyTorch runs eagerly, so
these are the plain closures.
"""
from __future__ import annotations

from .config import ArchConfig
from .transformer import ModelDims, decode_step, forward, prefill


def make_prefill_step(cfg: ArchConfig, dims: ModelDims, max_cache_len: int):
    def prefill_step(params, batch):
        return prefill(cfg, dims, params, batch, max_cache_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig, dims: ModelDims):
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")

    def serve_step(params, tokens, cache, index: int):
        return decode_step(cfg, dims, params, tokens, cache, index)

    return serve_step


def make_forward(cfg: ArchConfig, dims: ModelDims):
    def fwd(params, batch):
        logits, _ = forward(cfg, dims, params, batch)
        return logits
    return fwd
