"""Atomic, verified, asynchronous checkpointing (counterpart of
``repro.distributed.checkpoint``).

Layout:  <dir>/step_<N>/
            manifest.json   {step, leaves: [{path, shape, dtype, sha256}]}
            data.npz        one entry per tree leaf, host arrays

The reference's layout and properties, with a JSON manifest where it
writes msgpack (neither ``msgpack`` nor ``ml_dtypes`` is on the card's
machine): a bfloat16 leaf is stored as its ``uint16`` bit pattern and its
dtype is named in the manifest.  Trees are the port's nested dictionaries
and lists of tensors (``optim.tree``); leaves are named by their paths.

* **atomic**: written to ``step_<N>.tmp`` then renamed; a crash never
  leaves a half-written checkpoint that parses.
* **verified**: each leaf's sha256 is in the manifest; a corrupt
  checkpoint is skipped at restore, which falls back to the one before.
* **kept**: the newest ``keep`` steps stay, older ones are removed.
* **async**: ``save_async`` copies the tree to the host, then serialises on
  a background thread.
* ``restore`` takes ``device=`` where the reference takes shardings.
* **elastic** (``save_sharded`` / ``restore_sharded``): a sharded run
  saves whole leaves in the layout above, gathered leaf by leaf (rank 0
  writes); every rank of the resuming run reads whole leaves and cuts its
  own blocks by the specs of its mesh, so a run saved at one mesh resumes
  at another.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.tree import tree_flatten_with_paths, tree_unflatten

__all__ = ["list_steps", "restore", "restore_sharded", "save", "save_async",
           "save_sharded"]

_BF16 = "bfloat16"


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the host array stored for it, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree) -> list[tuple[str, np.ndarray, str]]:
    out = []
    for path, leaf in tree_flatten_with_paths(tree):
        arr, dtype = _host(leaf)
        out.append((path, np.array(arr, copy=True), dtype))
    return out


def _write(ckpt_dir: str, step: int, leaves, keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for path, arr, dtype in leaves:
        manifest["leaves"].append({
            "path": path, "shape": list(arr.shape), "dtype": dtype,
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()})
    np.savez(os.path.join(tmp, "data.npz"),
             **{path: arr for path, arr, _ in leaves})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Write ``tree`` as step ``step``; returns the checkpoint's path."""
    return _write(ckpt_dir, step, _snapshot(tree), keep)


def save_async(ckpt_dir: str, step: int, tree,
               keep: int = 3) -> threading.Thread:
    """Copy ``tree`` to the host now, write it on a daemon thread (join
    the returned thread before the next save)."""
    leaves = _snapshot(tree)
    t = threading.Thread(target=_write, args=(ckpt_dir, step, leaves, keep),
                         daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in list_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _verify_and_load(path: str) -> Optional[dict[str, torch.Tensor]]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        with np.load(os.path.join(path, "data.npz")) as data:
            for leaf in manifest["leaves"]:
                arr = data[leaf["path"]]
                if hashlib.sha256(arr.tobytes()).hexdigest() != \
                        leaf["sha256"]:
                    return None
                t = torch.from_numpy(arr.copy())
                if leaf["dtype"] == _BF16:
                    t = t.view(torch.int16).view(torch.bfloat16)
                out[leaf["path"]] = t
        return out
    except Exception:  # noqa: BLE001 - any corruption: unusable checkpoint
        return None


def restore(ckpt_dir: str, like, device=None,
            step: Optional[int] = None) -> tuple[Any, int]:
    """The newest valid checkpoint (or step ``step``) in ``like``'s
    structure, each leaf on ``device`` (default: the host).

    Returns (tree, step); raises FileNotFoundError if nothing valid exists.
    """
    steps = list_steps(ckpt_dir)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in reversed(steps):
        data = _verify_and_load(os.path.join(ckpt_dir, f"step_{s:08d}"))
        if data is None:
            continue  # corrupt: fall back to an older checkpoint
        leaves = [data[path] for path, _ in tree_flatten_with_paths(like)]
        if device is not None:
            leaves = [t.to(device) for t in leaves]
        return tree_unflatten(like, leaves), s
    raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")


def save_sharded(ckpt_dir: str, step: int, tree, specs, par,
                 keep: int = 3) -> Optional[str]:
    """Gather ``tree`` (the rank's blocks under ``specs``, a tree of
    ``sharding.P``) leaf by leaf over ``par``'s mesh and write the whole
    leaves from the mesh's first rank; every rank of the mesh must call.
    Returns the path on the writing rank, None on the others."""
    import torch.distributed as dist
    from . import tensor_parallel as tpl
    whole = tpl.gather_tree(tree, specs, par)
    path = None
    if par.mesh.coords is not None and not any(par.mesh.coords.values()):
        path = save(ckpt_dir, step, whole, keep)
    group = par.mesh.all.group
    if group is not None:
        dist.barrier(group=group)
    return path


def restore_sharded(ckpt_dir: str, like, specs, par, device=None,
                    step: Optional[int] = None) -> tuple[Any, int]:
    """The newest valid checkpoint's whole leaves cut to this rank's
    blocks under ``specs`` (of the resuming mesh), on ``device``."""
    from . import tensor_parallel as tpl
    whole, s = restore(ckpt_dir, like, step=step)
    local = tpl.shard_tree(whole, specs, par)
    if device is not None:
        from repro_torch.optim.tree import tree_map
        local = tree_map(lambda t: t.to(device), local)
    return local, s
