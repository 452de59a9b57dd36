"""The ``scar_search`` CUDA kernel's wrapper and its plain torch version.

Counterpart of the Pallas kernel ``repro/kernels/scar_search/kernel.py``.
Both functions here compute the beam search's disjointness screen:

  beam_words  [Bm, W]  int32  packed beam occupancy (uint32 bits)
  cand_words  [N, W]   int32  packed candidate occupancy (uint32 bits)
  ->          [Bm, N]  int32  popcount of the word-wise AND (0 = disjoint)

Occupancy words are uint32 bit patterns carried in int32 tensors
(``device_search.split_words_u32(...).view(np.int32)``): the kernel reads
them as ``unsigned``; the plain version widens to int64 and masks to the
low 32 bits before its SWAR popcount, since torch has no popcount op and
its right shift of a negative int32 is arithmetic.

``scar_search`` launches the kernel for CUDA tensors and uses the plain
version only for tensors on the CPU; a CUDA tensor never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import load_library

__all__ = ["conflict_counts_plain", "scar_search"]

_SMEM_LIMIT = 48 * 1024   # static launch limit without an opt-in attribute
_LOW32 = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in ``[0, 2**32)`` (SWAR, no wraparound)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def conflict_counts_plain(beam_words: torch.Tensor,
                          cand_words: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: ``[Bm, N]`` int32 AND popcounts.

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


def _check(beam_words: torch.Tensor, cand_words: torch.Tensor) -> None:
    for name, t in (("beam_words", beam_words), ("cand_words", cand_words)):
        if t.dtype != torch.int32:
            raise TypeError(f"scar_search: {name} is {t.dtype}, want "
                            "torch.int32 (uint32 bits)")
        if t.dim() != 2:
            raise ValueError(f"scar_search: {name} has shape "
                             f"{tuple(t.shape)}, want 2-D")
        if not t.is_contiguous():
            raise ValueError(f"scar_search: {name} is not contiguous")
    if beam_words.shape[1] != cand_words.shape[1]:
        raise ValueError(f"scar_search: W differs, beam {beam_words.shape[1]}"
                         f" vs candidates {cand_words.shape[1]}")
    if beam_words.device != cand_words.device:
        raise ValueError(f"scar_search: beam_words on {beam_words.device}, "
                         f"cand_words on {cand_words.device}")
    if beam_words.shape[1] < 1:
        raise ValueError("scar_search: W must be at least 1")


def scar_search(beam_words: torch.Tensor,
                cand_words: torch.Tensor) -> torch.Tensor:
    """``[Bm, N]`` int32 conflict counts: the CUDA kernel on CUDA tensors.

    Tensors on the CPU take ``conflict_counts_plain``.
    ``scar_search.launches`` counts kernel launches.
    """
    _check(beam_words, cand_words)
    dev = beam_words.device
    if dev.type == "cpu":
        return conflict_counts_plain(beam_words, cand_words)
    if dev.type != "cuda":
        raise ValueError(f"scar_search: no kernel for {dev}")
    bm, w = beam_words.shape
    n = cand_words.shape[0]
    lib = _lib()
    smem = lib.scar_search_smem_bytes(w)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"scar_search: W={w} needs {smem} B of shared "
                         f"memory (limit {_SMEM_LIMIT})")
    out = torch.empty((bm, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scar_search_launch(beam_words.data_ptr(),
                                     cand_words.data_ptr(), bm, n, w,
                                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scar_search launch failed: CUDA error {err}")
    scar_search.launches += 1
    return out


scar_search.launches = 0


_LIB = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use, with typed entry points."""
    global _LIB
    if _LIB is None:
        lib = load_library("scar_search")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.scar_search_launch.argtypes = [p, p, i, i, i, p, p]
        lib.scar_search_launch.restype = i
        lib.scar_search_smem_bytes.argtypes = [i]
        lib.scar_search_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB
