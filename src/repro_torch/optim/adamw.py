"""AdamW (counterpart of ``repro.optim.adamw``).

Functional updates over the port's parameter trees, written out as the
reference writes them: decoupled weight decay, float32 or bf16 moments,
global-norm clipping, a linear-warmup cosine schedule.  ``torch.optim.AdamW``
orders the weight decay and the bias corrections otherwise, so it is not
used.  The state mirrors the parameters (``mu``, ``nu``) beside a step
counter; the counter, the learning rate, the norm and the clip scale are
device tensors, so an update reads nothing back to the host.  Every
function returns new tensors and leaves its inputs as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32   # torch.bfloat16: low memory
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), float32."""
    warm = torch.clamp_max((step + 1) / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0,
                       1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_state(cfg: AdamWConfig, params: Any) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: dict, gnorm: torch.Tensor = None
                  ) -> tuple[Any, dict]:
    """One AdamW step: ``(new params, new state)``.  ``gnorm``: the
    clipping norm where ``grads`` are blocks of the gradient (sharded
    runs); default ``global_norm(grads)``."""
    step = state["step"] + 1
    lr = schedule(cfg, state["step"])
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu2 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu2 = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        update = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + cfg.eps)
        update = update + cfg.weight_decay * p.float()
        p2 = p.float() - lr * update
        return (p2.to(p.dtype), mu2.to(cfg.moment_dtype),
                nu2.to(cfg.moment_dtype))

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_params, new_mu, new_nu = (_pick(out, i) for i in range(3))
    return new_params, {"mu": new_mu, "nu": new_nu, "step": step}


def _pick(tree: Any, i: int) -> Any:
    """Entry ``i`` of each ``(param, mu, nu)`` triple that
    ``tree_map(upd, ...)`` left at the leaves."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
