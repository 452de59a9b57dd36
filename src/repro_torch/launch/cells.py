"""Dry-run cell matrix: (architecture x input shape) with validity rules
(counterpart of ``repro.launch.cells``).

Shapes:
  train_4k     seq 4096,   global_batch 256   (training step)
  prefill_32k  seq 32768,  global_batch 32    (inference prefill)
  decode_32k   KV 32768,   global_batch 128   (one decode token)
  long_500k    KV 524288,  global_batch 1     (long-context decode)

Skips:
  * long_500k only for sub-quadratic archs (xlstm-350m, zamba2-2.7b).
  * decode shapes skipped for encoder-only archs (hubert-xlarge).

``input_specs``, ``cache_specs`` and ``param_shapes`` give ``meta``
tensors of the reference's shapes and types (where the reference gives
``jax.ShapeDtypeStruct``s): no allocation.  A decode cell's ``index`` is a
Python int, as the port's decode step takes it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ASSIGNED
from repro_torch.models import ModelDims, get_arch
from repro_torch.models.config import ArchConfig

__all__ = ["Cell", "SHAPES", "all_cells", "cache_specs", "cell_valid",
           "input_specs", "param_shapes"]

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str

    @property
    def kind(self) -> str:
        return SHAPES[self.shape]["kind"]

    @property
    def seq(self) -> int:
        return SHAPES[self.shape]["seq"]

    @property
    def batch(self) -> int:
        return SHAPES[self.shape]["batch"]

    @property
    def seq_shard(self) -> bool:
        """Shard KV cache over sequence (batch too small for data axis)."""
        return self.shape == "long_500k"


def cell_valid(cell: Cell) -> tuple[bool, str]:
    cfg = get_arch(cell.arch)
    if cell.shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: no sub-quadratic path at 512k"
    if cfg.encoder_only and cell.kind == "decode":
        return False, "encoder-only arch: no autoregressive decode step"
    return True, ""


def all_cells(include_skipped: bool = False) -> list[Cell]:
    out = []
    for arch in ASSIGNED:
        for shape in SHAPES:
            c = Cell(arch, shape)
            if include_skipped or cell_valid(c)[0]:
                out.append(c)
    return out


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cell: Cell) -> dict:
    """Model inputs of the cell's step function as ``meta`` tensors
    (``index``: a Python int, the cache's last position)."""
    cfg = get_arch(cell.arch)
    B, S = cell.batch, cell.seq
    out: dict = {}
    if cell.kind == "decode":
        out = {"tokens": _meta((B, 1), torch.int32), "index": S - 1}
    elif cfg.frontend_stub:
        out["frames"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _meta((B, S), torch.int32)
    if cell.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    if cfg.cross_ctx_len:
        out["cross_ctx"] = _meta((B, cfg.cross_ctx_len, cfg.d_model),
                                 torch.bfloat16)
    return out


def cache_specs(cell: Cell, dims: ModelDims, dtype=torch.bfloat16,
                par=None) -> list:
    """The decode cache (``init_cache``) on ``meta``: the global batch's,
    or with ``par`` the rank's (its rows and KV heads)."""
    from repro_torch.models.transformer import init_cache
    cfg = get_arch(cell.arch)
    batch = cell.batch if par is None else cell.batch // par.dp.size
    return init_cache(cfg, dims, batch, cell.seq, dtype, META, par=par)


def param_shapes(cfg: ArchConfig, dims: ModelDims, dtype=torch.bfloat16,
                 shard=None) -> dict:
    """``init_params`` on ``meta`` (no allocation); ``shard`` as
    ``init_params`` takes it (a rank's shards)."""
    from repro_torch.models.transformer import init_params
    return init_params(cfg, dims, generator=torch.Generator().manual_seed(0),
                       dtype=dtype, shard=shard, device=META)
