"""The ``scar_search`` CUDA kernel's wrapper and its plain torch version.

Counterpart of the Pallas kernel ``repro/kernels/scar_search/kernel.py``
(the AND + popcount disjointness screen) and of the per-stage code around
it in ``repro/core/device_search.py::beam_scan`` (``keep_budget``,
``score_pick`` up to the top-k).  Both functions here compute one beam
stage's screen:

  beam_words  [Bm, W]  int32    packed beam occupancy (uint32 bits)
  cand_words  [N, W]   int32    packed candidate occupancy (uint32 bits)
  valid       [N]      bool     real candidates (not padding)
  state       [4]      int64    the previous stage's (total, expansions,
                                live beam rows, no placement)
  keep, max_exp        int      per-row width, global expansion budget
  b_lat, b_e  [Bm]     float    the beam rows' latency and energy
  c_lat, c_e  [N]      float    the candidates', same dtype (float32 on
                                the fused path, float64 on the protocol
                                path)
  metric               str      "edp", "latency" or "energy"
  ->  score   [Bm, N]  float    metric(max(b_lat, c_lat), b_e + c_e) where
                                the candidate is accepted, else +inf
      state   [4]      int64    this stage's (total, expansions after it,
                                live rows of the next beam, no placement)

A candidate is accepted by row b when it is disjoint from the row (AND
popcount 0), valid, the row is live, it is among the row's first ``keep``
disjoint candidates, and the expansions before it in row-major order stay
under ``max_exp`` (a stage's first acceptance always goes through): the
semantics of ``engine.BeamEngine.combine``.

Occupancy words are uint32 bit patterns carried in int32 tensors
(``device_search.split_words_u32(...).view(np.int32)``): the kernel reads
them as ``unsigned``; ``conflict_counts_plain`` widens to int64 and masks
to the low 32 bits before its SWAR popcount, since torch has no popcount
op and its right shift of a negative int32 is arithmetic.

``scar_search`` launches the kernel for CUDA tensors and uses
``scar_search_plain`` only for tensors on the CPU; a CUDA tensor never
falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library

__all__ = ["conflict_counts_plain", "scar_search", "scar_search_plain"]

_LOW32 = 0xFFFFFFFF
_METRIC = {"latency": 1, "energy": 2}      # anything else: edp (0)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in ``[0, 2**32)`` (SWAR, no wraparound)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def conflict_counts_plain(beam_words: torch.Tensor,
                          cand_words: torch.Tensor) -> torch.Tensor:
    """``[Bm, N]`` int32 AND popcounts (the Pallas kernel's function).

    Sums one ``[Bm, N]`` word plane at a time, so memory stays
    ``O(Bm * N)`` whatever ``W`` is.
    """
    bm, w = beam_words.shape
    n = cand_words.shape[0]
    acc = torch.zeros((bm, n), dtype=torch.int64, device=beam_words.device)
    for k in range(w):
        inter = beam_words[:, k, None] & cand_words[None, :, k]   # int32
        acc += _popcount32(inter.long() & _LOW32)
    return acc.to(torch.int32)


def _metric(lat: torch.Tensor, energy: torch.Tensor,
            metric: str) -> torch.Tensor:
    code = _METRIC.get(metric, 0)
    return lat if code == 1 else energy if code == 2 else lat * energy


def scar_search_plain(beam_words, cand_words, valid, state, *, keep: int,
                      max_exp: int, b_lat, b_e, c_lat, c_e,
                      metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: ``(score [Bm, N], state [4])``."""
    bm, n = beam_words.shape[0], cand_words.shape[0]
    expansions, live_rows = state[1], state[2]
    live = torch.arange(bm, device=beam_words.device) < live_rows
    dis = ((conflict_counts_plain(beam_words, cand_words) == 0)
           & valid[None, :] & live[:, None])
    # first ``keep`` disjoint per row, then the global expansion budget in
    # row-major acceptance order (a stage's first acceptance always goes
    # through) — cf. BeamEngine.combine
    rank = torch.cumsum(dis, dim=1)
    flat = (dis & (rank <= keep)).reshape(-1)
    before = torch.cumsum(flat, dim=0) - flat.long()
    flat = flat & ((expansions + before < max_exp) | (before == 0))
    total = flat.sum()
    new_lat = torch.maximum(b_lat[:, None], c_lat[None, :])
    new_e = b_e[:, None] + c_e[None, :]
    score = torch.where(flat.view(bm, n), _metric(new_lat, new_e, metric),
                        float("inf"))
    return score, torch.stack([total, expansions + total,
                               total.clamp(max=bm), (total == 0).long()])


def _check(beam_words, cand_words, valid, state, b_lat, b_e, c_lat,
           c_e) -> None:
    bm, n = beam_words.shape[0], cand_words.shape[0]
    w = beam_words.shape[1] if beam_words.dim() == 2 else -1
    fdt = c_lat.dtype
    want = {"beam_words": (beam_words, torch.int32, (bm, w)),
            "cand_words": (cand_words, torch.int32, (n, w)),
            "valid": (valid, torch.bool, (n,)),
            "state": (state, torch.int64, (4,)),
            "b_lat": (b_lat, fdt, (bm,)), "b_e": (b_e, fdt, (bm,)),
            "c_lat": (c_lat, fdt, (n,)), "c_e": (c_e, fdt, (n,))}
    dev = beam_words.device
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"scar_search: {name} on {t.device}, "
                             f"beam_words on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"scar_search: {name} is {t.dtype}, want "
                            f"{dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"scar_search: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"scar_search: {name} is not contiguous")
    if fdt not in (torch.float32, torch.float64):
        raise TypeError(f"scar_search: scores are {fdt}, want float32 or "
                        "float64")
    if w < 1 or bm < 1 or n < 1:
        raise ValueError(f"scar_search: empty screen Bm={bm}, N={n}, W={w}")


def scar_search(beam_words, cand_words, valid, state, *, keep: int,
                max_exp: int, b_lat, b_e, c_lat, c_e,
                metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(score [Bm, N], state [4])``: the CUDA kernel on CUDA tensors.

    Tensors on the CPU take ``scar_search_plain``.
    ``scar_search.launches`` counts kernel launches (one per call).
    """
    _check(beam_words, cand_words, valid, state, b_lat, b_e, c_lat, c_e)
    dev = beam_words.device
    if dev.type == "cpu":
        return scar_search_plain(beam_words, cand_words, valid, state,
                                 keep=keep, max_exp=max_exp, b_lat=b_lat,
                                 b_e=b_e, c_lat=c_lat, c_e=c_e,
                                 metric=metric)
    if dev.type != "cuda":
        raise ValueError(f"scar_search: no kernel for {dev}")
    bm, w = beam_words.shape
    n = cand_words.shape[0]
    lib = _lib()
    # the new state, then the zeroed ticket / count buffer
    ints = torch.empty(4 + 2 * ((lib.scar_search_sync_ints(bm, n) + 1) // 2),
                       dtype=torch.int64, device=dev)
    score = torch.empty((bm, n), dtype=c_lat.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scar_search_launch(
            beam_words.data_ptr(), cand_words.data_ptr(), valid.data_ptr(),
            state.data_ptr(), int(keep), int(max_exp), b_lat.data_ptr(),
            b_e.data_ptr(), c_lat.data_ptr(), c_e.data_ptr(),
            _METRIC.get(metric, 0), int(c_lat.dtype == torch.float64), bm,
            n, w, ints[4:].data_ptr(), score.data_ptr(), ints.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"scar_search launch failed: CUDA error {err}")
    scar_search.launches += 1
    return score, ints[:4]


scar_search.launches = 0


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with typed entry points."""
    global _LIB
    if _LIB is None:
        lib = load_library("scar_search")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.scar_search_launch.argtypes = [p, p, p, p, q, q, p, p, p, p, i,
                                           i, i, i, i, p, p, p, p]
        lib.scar_search_launch.restype = i
        lib.scar_search_sync_ints.argtypes = [i, i]
        lib.scar_search_sync_ints.restype = q
        _LIB = lib
    return _LIB
