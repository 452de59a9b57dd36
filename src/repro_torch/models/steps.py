"""Step functions: train / eval / prefill / decode / forward, built per
architecture (counterpart of ``repro.models.steps``).

The reference returns pure functions for ``jax.jit``; PyTorch runs
eagerly, so these are plain closures.  ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)`` stays pure as the reference's is:
it returns new parameter and state trees and leaves its inputs as they
are, so fault recovery is "restore the trees, continue".  Its metrics
(loss, grad_norm, step) are device tensors; reading them is the caller's
one sync.

The train, prefill and decode makers take ``par`` (a rank's
``distributed.tensor_parallel.Parallel``) for a sharded cell: the steps
are then given the global batch and take the rank's rows; the parameters
are the rank's shards.  Prefill and decode return the global batch's
logits over the whole vocab on every rank (the cache stays the rank's);
the train step sums the gradients over the batch axes, clips by the
global norm over the shards, and updates under ZeRO-1: each data rank
updates its block of every parameter (``sharding.zero1_specs``) with the
moments it keeps, and the blocks are gathered.  An FSDP arch's layer
leaves at a ``data`` axis above 1 are already the rank's blocks: their
gradients come reduce-scattered from the backward, and their update is
local (``tensor_parallel.zero_specs``).  Loss, grad norm and step are the
same on every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.launch.platform import device_upload, resolve_device
from repro_torch.optim import adamw
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.trace_hooks import recurrence
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
                   remat: bool = True, remat_policy: str = "nothing",
                   par=None):
    """``(loss, grads)`` of ``loss_fn`` at ``params`` (the reference's
    ``jax.value_and_grad``): grads a tree like ``params``, zeros for a
    leaf the loss does not reach.  ``batch`` must be on the parameters'
    device (``batch_to_device``)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(cfg, dims, tree_unflatten(params, leaves), batch,
                   remat=remat, remat_policy=remat_policy, par=par)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, dims: ModelDims, opt: adamw.AdamWConfig,
                    remat: bool = True, accum_steps: int = 1,
                    remat_policy: str = "nothing", device=None, par=None):
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
                              remat_policy=remat_policy, par=par)

    def train_step(params, opt_state, batch):
        first = tree_leaves(params)[0]
        if _indexed(first.device) != device:
            raise ValueError(f"train_step runs on {device}; the parameters "
                             f"are on {first.device}")
        if par is not None:
            batch = {k: tpl.local_rows(v, par, accum_steps)
                     for k, v in batch.items()}
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
            losses = torch.empty((accum_steps,), device=device)

            def accumulate(n):      # the first n microbatches
                for i in range(n):
                    loss_i, g = grads_of(params, micro[i])
                    tree_map(lambda a, gg: a.add_(gg.to(acc_dtype)), acc, g)
                    del g       # not held while the next microbatch runs
                    losses[i] = loss_i
            recurrence(accumulate, accum_steps, device)
            grads = tree_map(lambda g, p: (g / accum_steps).to(p.dtype), acc,
                             params)
            loss = losses.mean()
        if par is not None:
            return _sharded_update(params, opt_state, grads, loss)
        new_params, new_state = adamw.apply_updates(opt, params, grads,
                                                    opt_state)
        metrics = {"loss": loss, "grad_norm": adamw.global_norm(grads),
                   "step": new_state["step"]}
        return new_params, new_state, metrics

    specs = {}

    def _sharded_update(params, opt_state, grads, loss):
        if not specs:
            specs["p"] = shd.param_specs(cfg, params)
            specs["z"] = tpl.zero_specs(cfg, params, par)
        grads = tpl.reduce_grads(grads, specs["p"], par)
        if par.dp.size > 1:
            loss = coll.all_reduce(loss.clone(), par.dp.group)
        gnorm = tpl.grad_norm(grads, specs["p"], par)
        z = specs["z"]
        new_view, new_state = adamw.apply_updates(
            opt, shd.tree_map_specs(
                lambda t, s: tpl.zero_view(t, s, par), params, z),
            shd.tree_map_specs(lambda t, s: tpl.zero_view(t, s, par), grads,
                               z), opt_state, gnorm=gnorm)
        new_params = shd.tree_map_specs(
            lambda t, s, p: tpl.zero_gather(t, s, par, p), new_view, z,
            params)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm,
                                       "step": new_state["step"]}

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


def _rows(batch: dict, par) -> dict:
    return {k: tpl.local_rows(v, par) if v is not None else None
            for k, v in batch.items()}


def make_prefill_step(cfg: ArchConfig, dims: ModelDims, max_cache_len: int,
                      par=None):
    def prefill_step(params, batch):
        if par is None:
            return prefill(cfg, dims, params, batch, max_cache_len)
        logits, cache = prefill(cfg, dims, params, _rows(batch, par),
                                max_cache_len, par=par)
        return tpl.gather_rows(logits, par), cache
    return prefill_step


def make_decode_step(cfg: ArchConfig, dims: ModelDims, par=None):
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")

    def serve_step(params, tokens, cache, index: int, cross_ctx=None):
        if par is None:
            return decode_step(cfg, dims, params, tokens, cache, index,
                               cross_ctx=cross_ctx)
        rows = _rows({"t": tokens, "c": cross_ctx}, par)
        logits, cache = decode_step(cfg, dims, params, rows["t"], cache,
                                    index, cross_ctx=rows["c"], par=par)
        return tpl.gather_rows(logits, par), cache

    return serve_step


def make_forward(cfg: ArchConfig, dims: ModelDims):
    def fwd(params, batch):
        logits, _ = forward(cfg, dims, params, batch)
        return logits
    return fwd
