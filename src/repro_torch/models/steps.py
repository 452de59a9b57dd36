"""Step functions: train / eval / prefill / decode / forward, built per
architecture (counterpart of ``repro.models.steps``).

The reference returns pure functions for ``jax.jit``; PyTorch runs
eagerly, so these are plain closures.  ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)`` stays pure as the reference's is:
it returns new parameter and state trees and leaves its inputs as they
are, so fault recovery is "restore the trees, continue".  Its metrics
(loss, grad_norm, step) are device tensors; reading them is the caller's
one sync.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.platform import device_upload, resolve_device
from repro_torch.optim import adamw
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten
from .config import ArchConfig
from .transformer import ModelDims, decode_step, forward, loss_fn, prefill


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays (``data.pipeline.SyntheticLM``) or tensors
    on ``device``: numpy goes up in one copy per dtype; integer arrays
    become int64 (indices)."""
    host = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    out = dict(batch)
    out.update(device_upload(host, device) if host else {})
    return {k: (v.to(device).long() if not v.is_floating_point()
                else v.to(device)) for k, v in out.items()}


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so two names of one card compare
    equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def loss_and_grads(cfg: ArchConfig, dims: ModelDims, params, batch: dict,
                   remat: bool = True, remat_policy: str = "nothing"):
    """``(loss, grads)`` of ``loss_fn`` at ``params`` (the reference's
    ``jax.value_and_grad``): grads a tree like ``params``, zeros for a
    leaf the loss does not reach.  ``batch`` must be on the parameters'
    device (``batch_to_device``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(cfg, dims, tree_unflatten(params, leaves), batch,
                   remat=remat, remat_policy=remat_policy)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, dims: ModelDims, opt: adamw.AdamWConfig,
                    remat: bool = True, accum_steps: int = 1,
                    remat_policy: str = "nothing", device=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    ``accum_steps`` > 1 splits the batch into microbatches, one backward
    pass each, summing the gradients in float32 (bf16 when the moments are
    bf16), as the reference's ``lax.scan`` does: activation memory is one
    microbatch's, the update one per step.  Runs on ``device`` (default
    the card; raises without one): the parameters and state must be there,
    the batch is moved there.
    """
    device = _indexed(resolve_device(device))
    acc_dtype = (torch.bfloat16 if opt.moment_dtype == torch.bfloat16
                 else torch.float32)

    def grads_of(params, batch):
        return loss_and_grads(cfg, dims, params, batch, remat=remat,
                              remat_policy=remat_policy)

    def train_step(params, opt_state, batch):
        first = tree_leaves(params)[0]
        if _indexed(first.device) != device:
            raise ValueError(f"train_step runs on {device}; the parameters "
                             f"are on {first.device}")
        batch = batch_to_device(batch, device)
        if accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            micro = [{k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                     for i in range(accum_steps)]
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                 device=p.device), params)
            losses = []
            for mb in micro:
                loss_i, g = grads_of(params, mb)
                acc = tree_map(lambda a, gg: a + gg.to(acc_dtype), acc, g)
                losses.append(loss_i)
            grads = tree_map(lambda g, p: (g / accum_steps).to(p.dtype), acc,
                             params)
            loss = torch.stack(losses).mean()
        new_params, new_state = adamw.apply_updates(opt, params, grads,
                                                    opt_state)
        metrics = {"loss": loss, "grad_norm": adamw.global_norm(grads),
                   "step": new_state["step"]}
        return new_params, new_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig, dims: ModelDims, device=None):
    """eval_step(params, batch) -> the loss (a device tensor), no remat,
    no gradient."""
    device = resolve_device(device)

    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(cfg, dims, params, batch_to_device(batch, device),
                           remat=False)
    return eval_step


def make_prefill_step(cfg: ArchConfig, dims: ModelDims, max_cache_len: int):
    def prefill_step(params, batch):
        return prefill(cfg, dims, params, batch, max_cache_len)
    return prefill_step


def make_decode_step(cfg: ArchConfig, dims: ModelDims):
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")

    def serve_step(params, tokens, cache, index: int, cross_ctx=None):
        return decode_step(cfg, dims, params, tokens, cache, index,
                           cross_ctx=cross_ctx)

    return serve_step


def make_forward(cfg: ArchConfig, dims: ModelDims):
    def fwd(params, batch):
        logits, _ = forward(cfg, dims, params, batch)
        return logits
    return fwd
