"""Device selection and host-device sync accounting for the port.

The counterpart of ``repro.launch.platform``'s sync accounting
(``device_fetch`` / ``sync_count`` / ``reset_sync_count``) plus the port's
device rule:

* ``default_device()`` is ``cuda``.  Without a CUDA device it raises: the
  entry points never fall back to the CPU on their own; a caller that wants
  the CPU (the tests) asks for ``device="cpu"``.
* ``device_fetch`` is the one counted device->host copy.  The evaluator
  routes each scored batch through it, so ``sync_count`` counts one fetch
  per scoring batch, as in the reference.  Both read the
  ``launch.platform.sync_count`` registry counter.
* ``device_upload`` copies named host arrays to the device in one copy per
  dtype, however many arrays there are.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.obs import registry as _obs_registry

__all__ = ["default_device", "resolve_device", "device_fetch",
           "device_upload", "sync_count", "reset_sync_count"]

_SYNC = _obs_registry.counter("launch.platform.sync_count")


def default_device() -> torch.device:
    """``cuda:<current>``; raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """The caller's device, or ``default_device()`` when None."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def device_fetch(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Copy tensors to host numpy arrays: one counted synchronisation.

    ``Tensor.cpu()`` blocks until the producing kernels are done, so no
    separate ``torch.cuda.synchronize`` is needed.
    """
    _SYNC.inc()
    return tuple(t.detach().cpu().numpy() for t in tensors)


def device_upload(arrays: Mapping[str, np.ndarray],
                  device: torch.device) -> dict[str, torch.Tensor]:
    """Device copies of named host arrays, one host->device copy per dtype.

    The arrays of a dtype are laid end to end in one host buffer, each
    starting on a 16-byte boundary, which is copied once; each name gets
    a contiguous view of its part, in its own shape.  A copy from pageable
    host memory blocks the host, so the fewer the better.
    """
    groups: dict[np.dtype, list[tuple[str, np.ndarray]]] = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        groups.setdefault(a.dtype, []).append((name, a))
    out = {}
    for dtype, items in groups.items():
        step = max(1, 16 // dtype.itemsize)
        offs, total = [], 0
        for _, a in items:
            offs.append(total)
            total += -(-a.size // step) * step
        buf = np.zeros(total, dtype)
        for (_, a), off in zip(items, offs):
            buf[off:off + a.size] = a.ravel()
        flat = torch.from_numpy(buf).to(device)
        for (name, a), off in zip(items, offs):
            out[name] = flat[off:off + a.size].view(a.shape)
    return out


def sync_count() -> int:
    """Number of ``device_fetch`` calls since the last reset."""
    return _SYNC.value


def reset_sync_count() -> None:
    """Zero the sync counter (tests/benchmarks bracket a measured region)."""
    _SYNC.reset()
