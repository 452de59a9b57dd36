"""The weight carrier: the JAX package's parameters as the port's.

``params_from_numpy`` takes the tree ``repro.models.init_params`` returns,
as nested dictionaries of numpy arrays (``jax.tree.map(np.asarray,
params)``, or ``models.testing.numpy_tree``), and returns the parameters
``models.transformer`` reads.  The reference stacks each pattern
position's parameters over the super-block axis (``layers["p{i}"]``, leading
dimension ``n_super``); the port holds one dictionary per layer.  The
shared attention block (``shared_attn``) becomes one dictionary that every
``SHARED_ATTN`` position reads; each position keeps its own KV cache.

For training: ``opt_state_from_numpy`` carries the reference's AdamW state
(``mu`` and ``nu`` as numpy trees in the reference's layout, and the step)
across in the same way, so that a step from the same state can be
compared; ``numpy_from_params`` goes the other way, stacking a port tree
(parameters, gradients, moments) back into the reference's layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig
from .transformer import _dtype

# Parameters the reference keeps in float32 whatever the model's type:
# Mamba-2's A_log, D and dt_bias, the MoE router and the cross block's gate
FLOAT32_LEAVES = ("A_log", "D", "dt_bias", "router", "xgate")


def _tensor(name: str, a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        want = torch.float32 if name in FLOAT32_LEAVES else dtype
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=want)
    return torch.from_numpy(a).to(device)


def _convert(tree: dict, device, dtype, index=None, leaf=_tensor) -> dict:
    """Every array of ``tree`` as a tensor; ``index`` picks one entry of the
    leading (super-block) axis."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _convert(v, device, dtype, index, leaf)
        else:
            out[name] = leaf(name, v if index is None else v[index],
                             device, dtype)
    return out


def params_from_numpy(cfg: ArchConfig, tree: dict, *, device,
                      dtype=torch.bfloat16, leaf=_tensor) -> dict:
    """The port's parameters, on ``device``, from the reference's tree."""
    dtype = _dtype(dtype)
    layers = tree["layers"]
    params = {
        "embed": leaf("embed", tree["embed"], device, dtype),
        "final_ln": _convert(tree["final_ln"], device, dtype, leaf=leaf),
        "layers": [[_convert(layers.get(f"p{pi}", {}), device, dtype, si,
                             leaf)
                    for pi in range(len(cfg.block_pattern))]
                   for si in range(cfg.n_super_blocks)],
    }
    for name in ("shared_attn", "lm_head"):
        if name in tree:
            params[name] = _convert(tree[name], device, dtype, leaf=leaf)
    return params


def opt_state_from_numpy(cfg: ArchConfig, state: dict, *, device,
                         moment_dtype=torch.float32) -> dict:
    """The port's AdamW state (``optim.adamw.init_state``'s layout), on
    ``device``, from the reference's: ``mu`` and ``nu`` numpy trees in the
    reference's parameter layout, every leaf in ``moment_dtype``, and the
    step as an int32 tensor."""
    def moment(name, a, device, dtype):
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(
            device=device, dtype=dtype)
    return {key: params_from_numpy(cfg, state[key], device=device,
                                   dtype=moment_dtype, leaf=moment)
            for key in ("mu", "nu")} | {
        "step": torch.tensor(int(np.asarray(state["step"])),
                             dtype=torch.int32, device=device)}


def numpy_from_params(cfg: ArchConfig, params: dict) -> dict:
    """A port tree (parameters, gradients or moments) in the reference's
    layout, as float32 numpy: each pattern position's layers stacked over
    the super-block axis (``layers["p{i}"]``, empty for the shared
    attention positions)."""
    def host(t):
        return t.detach().float().cpu().numpy()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else host(v)
                for k, v in tree.items()}

    def stack(trees):
        first = trees[0]
        return {k: stack([t[k] for t in trees]) if isinstance(first[k], dict)
                else np.stack([host(t[k]) for t in trees])
                for k in first}

    out = {k: walk(v) for k, v in params.items()
           if k not in ("layers",) and isinstance(v, dict)}
    out["embed"] = host(params["embed"])
    out["layers"] = {f"p{pi}": stack([layer[pi]
                                      for layer in params["layers"]])
                     for pi in range(len(cfg.block_pattern))}
    return out
