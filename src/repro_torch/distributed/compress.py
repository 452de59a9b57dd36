"""Gradient compression: int8 ring all-reduce with error feedback
(counterpart of ``repro.distributed.compress``).

Cross-pod gradient reduction is bandwidth-bound at scale; quantizing the
exchanged chunks to int8 cuts wire bytes about 4x.  The reference runs a
ring reduce-scatter then all-gather over ``jax.lax.ppermute`` inside
``shard_map``; the port runs the same hops over ``torch.distributed``
point-to-point in the axis's process group (``collectives.send_recv``):
each hop sends an int8-quantized chunk and its float32 scale to the next
rank, sums in float32 (reduce-scatter) or takes the chunk (all-gather),
n - 1 hops each, in the reference's hop order.
"""
from __future__ import annotations

from typing import Any

import torch

from . import collectives as coll

__all__ = ["compressed_psum", "error_feedback_update"]


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _hop(chunk: torch.Tensor, axis) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``chunk``, send it and its scale to the next rank of the
    ring, return what the previous rank sent (int8 chunk, float32
    scale)."""
    q, s = _quant(chunk)
    n, me = axis.size, axis.rank
    nxt, prv = (me + 1) % n, (me - 1) % n
    rq = coll.send_recv(q, torch.empty_like(q), nxt, prv, axis)
    rs = coll.send_recv(s.reshape(1), torch.empty(
        1, dtype=s.dtype, device=s.device), nxt, prv, axis)
    return rq, rs[0]


def _ring_allreduce_int8(x: torch.Tensor, axis) -> torch.Tensor:
    """The int8 ring all-reduce of a flat float32 vector over ``axis``."""
    n, idx = axis.size, axis.rank
    pad = (-x.shape[0]) % n
    acc = torch.nn.functional.pad(x, (0, pad)).reshape(n, -1).clone()
    # reduce-scatter: after n - 1 hops, chunk (idx + 1) holds the full sum
    for i in range(n - 1):
        q, s = _hop(acc[(idx - i) % n], axis)
        recv = (idx - i - 1) % n
        acc[recv] = acc[recv] + _dequant(q, s)
    # all-gather: circulate the reduced chunks
    for i in range(n - 1):
        q, s = _hop(acc[(idx - i + 1) % n], axis)
        acc[(idx - i) % n] = _dequant(q, s)
    out = acc.reshape(-1)
    return out[:x.shape[0]] if pad else out


def compressed_psum(x: torch.Tensor, mesh, axis: str = "pod"
                    ) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axis`` of ``mesh`` (a
    ``launch.mesh.RankMesh``) by the int8 ring exchange; ``x`` itself
    where the axis has one rank."""
    ax = mesh.axis(axis)
    if ax.size == 1:
        return x
    flat = x.reshape(-1).float()
    return _ring_allreduce_int8(flat, ax).reshape(x.shape).to(x.dtype)


def error_feedback_update(grads: Any, residual: Any) -> tuple[Any, Any]:
    """g' = g + residual; returns (g', residual).

    The caller computes the new residual as g' less its dequantized
    exchange, after the compressed reduction; a separate helper so the
    train loop can thread residuals through the optimizer state."""
    if residual is None:
        return grads, None
    from repro_torch.optim.tree import tree_map
    return tree_map(lambda g, r: g + r.to(g.dtype), grads, residual), residual
