"""The weight carrier: the JAX package's parameters as the port's.

``params_from_numpy`` takes the tree ``repro.models.init_params`` returns,
as nested dictionaries of numpy arrays (``jax.tree.map(np.asarray,
params)``, or ``models.testing.numpy_tree``), and returns the parameters
``models.transformer`` reads.  The reference stacks each pattern
position's parameters over the super-block axis (``layers["p{i}"]``, leading
dimension ``n_super``); the port holds one dictionary per layer.  The
shared attention block (``shared_attn``) becomes one dictionary that every
``SHARED_ATTN`` position reads; each position keeps its own KV cache.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig
from .transformer import _dtype

# Parameters the reference keeps in float32 whatever the model's type:
# Mamba-2's A_log, D and dt_bias and the MoE router
FLOAT32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _tensor(name: str, a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        want = torch.float32 if name in FLOAT32_LEAVES else dtype
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=want)
    return torch.from_numpy(a).to(device)


def _convert(tree: dict, device, dtype, index=None) -> dict:
    """Every array of ``tree`` as a tensor; ``index`` picks one entry of the
    leading (super-block) axis."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _convert(v, device, dtype, index)
        else:
            out[name] = _tensor(name, v if index is None else v[index],
                                device, dtype)
    return out


def params_from_numpy(cfg: ArchConfig, tree: dict, *, device,
                      dtype=torch.bfloat16) -> dict:
    """The port's parameters, on ``device``, from the reference's tree."""
    dtype = _dtype(dtype)
    layers = tree["layers"]
    params = {
        "embed": _tensor("embed", tree["embed"], device, dtype),
        "final_ln": _convert(tree["final_ln"], device, dtype),
        "layers": [[_convert(layers[f"p{pi}"], device, dtype, si)
                    for pi in range(len(cfg.block_pattern))]
                   for si in range(cfg.n_super_blocks)],
    }
    for name in ("shared_attn", "lm_head"):
        if name in tree:
            params[name] = _convert(tree[name], device, dtype)
    return params
