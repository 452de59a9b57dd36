"""The ``scar_eval`` CUDA kernel's wrapper and its plain torch version.

Counterpart of the Pallas kernel ``repro/kernels/scar_eval/kernel.py``.
Both functions here take the compact candidate form (see
``kernels/csrc/scar_eval.cu``) and return ``[B, 2]`` float32 (window
latency, window energy):

  lat_tab, e_tab     [Lw, C]  float32  per-(layer, chiplet class) costs
  seg_cls            [B, S]   int32    chiplet class of each segment
  last               [B, S]   int32    window-relative last layer of each
                                       segment (ascending over live ones)
  n_segs             [B]      int32    live segments (0 = padding row)
  comm_lat, comm_e   [B, S]   float32  per-segment comm terms
  pipelined          bool     latency = max over live segments when more
                              than one is live, else their sum

``scar_eval`` launches the kernel for CUDA tensors and uses the plain
version only for tensors on the CPU; a CUDA tensor never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library

__all__ = ["blocked_cumsum", "scar_eval", "scar_eval_plain"]

PREFIX_BLOCK = 16
MAX_LAYERS = 4096         # two carry levels of 16-blocks in the kernel
_SMEM_LIMIT = 48 * 1024   # static launch limit without an opt-in attribute


def blocked_cumsum(x: torch.Tensor, block: int = PREFIX_BLOCK
                   ) -> torch.Tensor:
    """Inclusive prefix sums along dim 0 in a fixed association.

    Sequential within blocks of ``block`` rows, then each block offset by
    the prefix of the earlier blocks' totals, computed the same way.  This
    is the association of the reference's float32 evaluator (``jnp.cumsum``
    on the CPU), and the one the CUDA kernel uses, so all three give the
    same float32 bits; ``torch.cumsum`` sums in another order.
    """
    n = x.shape[0]
    if n <= block:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[0])
        for i in range(n):
            acc = acc + x[i]
            out[i] = acc
        return out
    nb = -(-n // block)
    pad = x.new_zeros((nb * block - n,) + tuple(x.shape[1:]))
    xb = torch.cat([x, pad]).reshape((nb, block) + tuple(x.shape[1:]))
    within = torch.empty_like(xb)
    acc = torch.zeros_like(xb[:, 0])
    for i in range(block):
        acc = acc + xb[:, i]
        within[:, i] = acc
    carry = blocked_cumsum(within[:, -1], block)
    out = within.clone()
    out[1:] = within[1:] + carry[:-1].unsqueeze(1)
    return out.reshape((nb * block,) + tuple(x.shape[1:]))[:n]


def scar_eval_plain(lat_tab: torch.Tensor, e_tab: torch.Tensor,
                    seg_cls: torch.Tensor, last: torch.Tensor,
                    n_segs: torch.Tensor, comm_lat: torch.Tensor,
                    comm_e: torch.Tensor, pipelined: bool) -> torch.Tensor:
    """Plain torch version of the kernel: same inputs, same float32 ops."""
    B, S = seg_cls.shape
    Lw, C = lat_tab.shape
    zrow = lat_tab.new_zeros((1, C))
    cum_lat = torch.cat([zrow, blocked_cumsum(lat_tab)])         # [Lw+1, C]
    cum_e = torch.cat([zrow, blocked_cumsum(e_tab)])
    cls = seg_cls.long().clamp(0, C - 1)
    hi = last.long().clamp(0, Lw - 1) + 1
    lo = torch.cat([torch.zeros_like(hi[:, :1]),
                    (last[:, :-1].long().clamp(min=-1) + 1).clamp(max=Lw)],
                   dim=1)
    seg_lat = (cum_lat[hi, cls] - cum_lat[lo, cls]) + comm_lat
    seg_e = (cum_e[hi, cls] - cum_e[lo, cls]) + comm_e
    live = torch.arange(S, device=seg_cls.device)[None, :] < n_segs[:, None]
    zero = lat_tab.new_zeros(())
    lat_sum = lat_tab.new_zeros(B)
    e_sum = lat_tab.new_zeros(B)
    lat_max = torch.full((B,), float("-inf"), dtype=lat_tab.dtype,
                         device=lat_tab.device)
    for s in range(S):                 # segment order, as the kernel sums
        lat_sum = lat_sum + torch.where(live[:, s], seg_lat[:, s], zero)
        e_sum = e_sum + torch.where(live[:, s], seg_e[:, s], zero)
        lat_max = torch.maximum(lat_max, torch.where(
            live[:, s], seg_lat[:, s], lat_max))
    lat = torch.where(n_segs > 1, lat_max, lat_sum) if pipelined else lat_sum
    return torch.stack([lat, e_sum], dim=1)


def _check(lat_tab, e_tab, seg_cls, last, n_segs, comm_lat, comm_e):
    Lw, C = lat_tab.shape
    B, S = seg_cls.shape
    want = {"lat_tab": (lat_tab, torch.float32, (Lw, C)),
            "e_tab": (e_tab, torch.float32, (Lw, C)),
            "seg_cls": (seg_cls, torch.int32, (B, S)),
            "last": (last, torch.int32, (B, S)),
            "n_segs": (n_segs, torch.int32, (B,)),
            "comm_lat": (comm_lat, torch.float32, (B, S)),
            "comm_e": (comm_e, torch.float32, (B, S))}
    dev = lat_tab.device
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"scar_eval: {name} on {t.device}, lat_tab on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"scar_eval: {name} is {t.dtype}, want {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"scar_eval: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"scar_eval: {name} is not contiguous")
    if not 1 <= Lw <= MAX_LAYERS or not 1 <= C <= 64 or S < 1:
        raise ValueError(f"scar_eval: unsupported Lw={Lw}, C={C}, S={S}")


def scar_eval(lat_tab: torch.Tensor, e_tab: torch.Tensor,
              seg_cls: torch.Tensor, last: torch.Tensor,
              n_segs: torch.Tensor, comm_lat: torch.Tensor,
              comm_e: torch.Tensor, pipelined: bool) -> torch.Tensor:
    """``[B, 2]`` (latency, energy): the CUDA kernel on CUDA tensors.

    Tensors on the CPU take ``scar_eval_plain``.  ``scar_eval.launches``
    counts kernel launches.
    """
    _check(lat_tab, e_tab, seg_cls, last, n_segs, comm_lat, comm_e)
    if lat_tab.device.type == "cpu":
        return scar_eval_plain(lat_tab, e_tab, seg_cls, last, n_segs,
                               comm_lat, comm_e, pipelined)
    if lat_tab.device.type != "cuda":
        raise ValueError(f"scar_eval: no kernel for {lat_tab.device}")
    Lw, C = lat_tab.shape
    B, S = seg_cls.shape
    lib = _lib()
    smem = lib.scar_eval_smem_bytes(Lw, C)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"scar_eval: Lw={Lw}, C={C} needs {smem} B of "
                         f"shared memory (limit {_SMEM_LIMIT})")
    out = torch.empty((B, 2), dtype=torch.float32, device=lat_tab.device)
    with torch.cuda.device(lat_tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scar_eval_launch(
            lat_tab.data_ptr(), e_tab.data_ptr(), Lw, C, seg_cls.data_ptr(),
            last.data_ptr(), n_segs.data_ptr(), comm_lat.data_ptr(),
            comm_e.data_ptr(), B, S, int(bool(pipelined)), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"scar_eval launch failed: CUDA error {err}")
    scar_eval.launches += 1
    return out


scar_eval.launches = 0


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with typed entry points."""
    global _LIB
    if _LIB is None:
        lib = load_library("scar_eval")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.scar_eval_launch.argtypes = [p, p, i, i, p, p, p, p, p, i, i, i,
                                         p, p]
        lib.scar_eval_launch.restype = i
        lib.scar_eval_smem_bytes.argtypes = [i, i]
        lib.scar_eval_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB
