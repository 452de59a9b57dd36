"""The port's collectives: ``torch.distributed`` calls in one place, each
counted (calls and bytes by operation), and each routed through a host copy
where the backend cannot take the tensor where it lies.

NCCL takes CUDA tensors for every operation here.  Gloo takes CPU tensors
for all of them, but only some on CUDA tensors; ranks that share one card
(NCCL refuses two ranks on a device) run gloo on CUDA tensors, so an
operation outside ``GLOO_CUDA_OPS`` (the ring's point-to-point) copies its
tensor to the host, runs there and copies the result back.  That copy is
never silent: ``stats()`` counts it (``staged``) beside the calls, and the
callers print it.  The model's work stays on the card either way.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from repro_torch import trace_hooks

__all__ = ["GLOO_CUDA_OPS", "all_gather", "all_reduce", "backend",
           "broadcast", "reset_stats", "send_recv", "stats"]

# The operations gloo takes on CUDA tensors (it copies them through
# pinned host memory itself), float32 and bf16, on the card's torch 2.11:
# ``probe_gloo_cuda``, run by ``chip_smoke.py`` phase 16.
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
_STATS: dict[str, collections.Counter] = collections.defaultdict(
    collections.Counter)


def backend(group=None) -> str:
    return str(dist.get_backend(group))


def _count(label: str, t: torch.Tensor, staged: bool, op: str,
           group_size: int) -> None:
    s = _STATS[label]
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()
    s["staged"] += int(staged)
    trace_hooks.collective(op, t.numel() * t.element_size(), group_size)


def _staged(op: str, t: torch.Tensor, group) -> bool:
    return (t.is_cuda and backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS)


def stats() -> dict:
    """``{op: {"calls", "bytes", "staged"}}`` since the last reset (bytes:
    what this rank hands the operation); a call made with a ``label`` is
    counted under the label instead of its operation's name."""
    return {op: dict(c) for op, c in _STATS.items()}


def reset_stats() -> None:
    _STATS.clear()


def all_reduce(t: torch.Tensor, group, op: str = "sum",
               label: str = "all_reduce") -> torch.Tensor:
    """``t`` reduced over ``group`` in place (and returned)."""
    staged = _staged("all_reduce", t, group)
    _count(label, t, staged, "all_reduce", dist.get_world_size(group))
    if staged:
        host = t.cpu()
        dist.all_reduce(host, op=_OPS[op], group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, axis,
               label: str = "all_gather") -> list[torch.Tensor]:
    """Every rank's ``t`` (all of one shape) over ``axis`` (a
    ``launch.mesh.Axis``), in the axis's index order."""
    group = axis.group
    staged = _staged("all_gather", t, group)
    _count(label, t, staged, "all_gather", axis.size)
    src = t.contiguous().cpu() if staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(out, src, group=group)
    order = sorted(axis.ranks)
    out = [out[order.index(r)] for r in axis.ranks]
    return [o.to(t.device) for o in out] if staged else out


def broadcast(t: torch.Tensor, src: int, axis) -> torch.Tensor:
    """``t`` from the axis's rank ``src`` (its index), in place."""
    group = axis.group
    staged = _staged("broadcast", t, group)
    _count("broadcast", t, staged, "broadcast", axis.size)
    if staged:
        host = t.cpu()
        dist.broadcast(host, group=group, src=axis.ranks[src])
        t.copy_(host)
    else:
        dist.broadcast(t, group=group, src=axis.ranks[src])
    return t


def send_recv(send: torch.Tensor, recv: torch.Tensor, dst: int, src: int,
              axis) -> torch.Tensor:
    """Send ``send`` to the axis's rank ``dst`` while receiving ``recv``
    from ``src`` (indices; one ring hop); returns ``recv``."""
    group = axis.group
    staged = _staged("send_recv", send, group)
    _count("send_recv", send, staged, "send_recv", axis.size)
    s, r = (send.contiguous().cpu(), torch.empty(
        recv.shape, dtype=recv.dtype)) if staged else (send.contiguous(),
                                                        recv)
    ops = [dist.P2POp(dist.isend, s, axis.ranks[dst], group),
           dist.P2POp(dist.irecv, r, axis.ranks[src], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        recv.copy_(r)
    return recv


def probe_gloo_cuda(device: torch.device) -> dict[str, str]:
    """Which collectives gloo runs on CUDA tensors: each tried once, on a
    throwaway group of the world, on small float32 and bf16 tensors
    without a host copy (``"ok"`` or the error's first line).  Gloo's
    point-to-point is not tried: it hands the tensor's pointer to its TCP
    transport as host memory, and a CUDA tensor kills the process (a
    ``gloo::IoException``, "Bad address", on the card's torch 2.11), so
    ``send_recv`` is always staged."""
    group = dist.new_group(list(range(dist.get_world_size())),
                           timeout=_timeout())
    n = dist.get_world_size(group)
    tries = {
        "all_reduce": lambda t: dist.all_reduce(t, group=group),
        "broadcast": lambda t: dist.broadcast(t, src=0, group=group),
        "all_gather": lambda t: dist.all_gather(
            [torch.empty_like(t) for _ in range(n)], t, group=group),
    }
    return {f"{name} {str(dt)[6:]}": _try(lambda: fn(torch.ones(
        8, dtype=dt, device=device)))
        for name, fn in tries.items()
        for dt in (torch.float32, torch.bfloat16)}


def _timeout():
    import datetime
    from repro_torch.launch.mesh import TIMEOUT_S
    return datetime.timedelta(seconds=TIMEOUT_S)


def _try(fn) -> str:
    try:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return "ok"
    except Exception as e:  # noqa: BLE001 - the probe reports any refusal
        return (str(e).splitlines() or [type(e).__name__])[0][:120]

