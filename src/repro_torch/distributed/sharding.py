"""Sharding rules: mesh axes -> partition specs for parameters, activations,
optimizer state and KV caches (counterpart of
``repro.distributed.sharding``).

Two styles, chosen per architecture:

* ``tp`` (default): Megatron-style tensor parallelism over the ``model``
  axis (attention heads, FFN hidden, MoE experts, vocab), batch over
  ``(pod, data)``.  Padding of heads, vocab and experts to the TP degree
  is ``models.transformer.ModelDims``'s (exact at tp = 1).
* ``dp`` (small archs: xlstm-350m, zamba2-2.7b): parameters replicated,
  batch over as many mesh axes as divide it, optimizer state ZeRO-1.

A spec is a ``P``: a tuple with one entry per leading dimension, an axis
name, a tuple of names or None, as ``jax.sharding.PartitionSpec`` holds
them.  The rules are the reference's over the port's parameter layout
(``params["layers"][super_block][position]``): where the reference gives a
leaf stacked under ``layers`` a leading None for the super-block axis, the
port's leaf has no such axis.  GSPMD turns the reference's specs into
collectives; the port runs them by hand (``distributed.tensor_parallel``).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

if TYPE_CHECKING:
    from repro_torch.models.config import ArchConfig

__all__ = ["DP_STYLE_ARCHS", "FSDP_ARCHS", "LayerP", "P", "ShardingSpecs",
           "batch_specs", "make_specs", "opt_state_specs", "param_specs",
           "style_for", "tree_map_specs", "zero1_specs"]

DP_STYLE_ARCHS = {"xlstm-350m", "zamba2-2.7b"}
# >=30 GB parameter archs: weights sharded 2D over (data x model), FSDP;
# MoE experts shard E over 'data' and d_ff over 'model'.  At a data axis
# above 1 each super-block all-gathers its weights over 'data' before it
# runs and reduce-scatters their gradients (``tensor_parallel.FSDP``).
FSDP_ARCHS = {"arctic-480b", "llama-3.2-vision-90b", "command-r-35b",
              "qwen2.5-32b"}


class P(tuple):
    """A partition spec: ``P("model", None)``; equal to the tuple of its
    entries, which are normalised as ``PartitionSpec`` normalises them (a
    tuple of one name is the name, an empty one None), and so equal to
    ``tuple(PartitionSpec(...))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def axes(self) -> set[str]:
        """Every axis name the spec uses."""
        out: set[str] = set()
        for s in self:
            if isinstance(s, str):
                out.add(s)
            elif s:
                out.update(s)
        return out


@dataclasses.dataclass(frozen=True)
class ShardingSpecs:
    """Activation-side specs."""
    act: P            # [B, S, D]
    ffn: P            # [B, S, F]
    expert: P         # [G, E, C, D]
    kv_cache: P       # [B, S, H, hd]
    kv_cache_stacked: P   # [L, B, S, H, hd]
    logits: P         # [B, S, V]
    heads: P = None   # [B, S, H, hd] attention q/k/v heads
    ssm_heads: P = None   # [B, L, H, P] ssm heads


def style_for(cfg: ArchConfig) -> str:
    return "dp" if cfg.name in DP_STYLE_ARCHS else "tp"


def _mesh_shape(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _dp_axes(mesh_axes: tuple[str, ...], batch: int,
             mesh_shape: dict[str, int], style: str) -> tuple[str, ...]:
    """Batch axes: every mesh axis (in order) whose product divides batch."""
    cand = ["pod", "data"] if "pod" in mesh_axes else ["data"]
    if style == "dp":
        cand = cand + ["model"]
    axes: list[str] = []
    prod = 1
    for a in cand:
        if a in mesh_axes and batch % (prod * mesh_shape[a]) == 0:
            axes.append(a)
            prod *= mesh_shape[a]
    return tuple(axes)


def make_specs(cfg: ArchConfig, mesh, batch: int, seq_shard: bool = False,
               seq_parallel: bool = False,
               expert_axes: str = "default") -> ShardingSpecs:
    """Activation specs for a cell.  ``mesh``: anything with
    ``axis_names`` and ``devices`` (``launch.mesh.MeshSpec``).

    ``seq_shard``: the KV cache's sequence axis over 'data' (long-context
    decode at batch 1).  ``seq_parallel``: Megatron-SP, the activations'
    sequence axis over 'model' between blocks.  ``expert_axes``:
    'default' | 'model_major', the MoE's expert layout."""
    from repro_torch.models.transformer import ModelDims
    style = style_for(cfg)
    shape = _mesh_shape(mesh)
    dp = _dp_axes(tuple(mesh.axis_names), batch, shape, style)
    dp_spec = dp if dp else None
    model = "model" if style == "tp" else None
    kv_seq = "data" if seq_shard else None
    m_sz = shape.get("model", 1)
    heads = None
    ssm_heads = None
    if "model" not in dp:
        dims = ModelDims.create(cfg, tp=m_sz if style == "tp" else 1)
        if dims.n_q_pad % m_sz == 0 and dims.n_kv_pad % m_sz == 0:
            heads = P(dp_spec, None, "model", None)
        if cfg.ssm is not None:
            ssm_h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
            if ssm_h % m_sz == 0:
                ssm_heads = P(dp_spec, None, "model", None)
    if cfg.moe is not None and cfg.name in FSDP_ARCHS:
        expert = (P(None, "model", None, None) if expert_axes == "model_major"
                  else P(None, "data", None, None))
    else:
        expert = P(dp_spec, model, None, None)
    sp = seq_parallel and "model" not in dp
    batch_entry = dp_spec if not seq_shard else None
    return ShardingSpecs(
        act=P(dp_spec, "model" if sp else None, None),
        ffn=P(dp_spec, None, model),
        expert=expert,
        kv_cache=P(batch_entry, kv_seq, "model", None),
        kv_cache_stacked=P(None, batch_entry, kv_seq, "model", None),
        logits=P(dp_spec, None, "model" if style == "tp" else None),
        heads=heads,
        ssm_heads=ssm_heads,
    )


# ---------------------------------------------------------------------------
# parameter partition specs
# ---------------------------------------------------------------------------

def _param_rule(path: list[str], cfg: ArchConfig, style: str) -> P:
    if style == "dp":
        return P()
    d2 = "data" if cfg.name in FSDP_ARCHS else None  # FSDP's second axis
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    gparent = path[-3] if len(path) > 2 else ""
    if name == "embed":
        return P("model", None) if cfg.tie_embeddings else P(None, "model")
    if parent == "lm_head":
        return P(None, "model") if name == "w" else P("model")
    if parent in ("wq", "wk", "wv") and gparent in ("attn", "xattn"):
        return P(d2, "model") if name == "w" else P("model")
    if parent == "wo" and gparent in ("attn", "xattn"):
        return P("model", d2)
    if parent in ("wi", "wg") and gparent in ("mlp", "shared", "dense_mlp"):
        return P(d2, "model") if name == "w" else P("model")
    if parent == "wo" and gparent in ("mlp", "shared", "dense_mlp"):
        return P("model", d2) if name == "w" else P()
    if parent == "moe":
        if d2 and name in ("wi", "wg"):
            return P("data", None, "model")
        if d2 and name == "wo":
            return P("data", "model", None)
        if name in ("wi", "wg", "wo"):
            return P("model", None, None)
        return P()  # router replicated
    return P()  # norms, gates, ssm / lstm parameters


def _map_paths(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over a tree of dictionaries and
    lists and trees of the same structure (spec trees among them)."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, *(r[k] for r in rest),
                              path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, *(r[i] for r in rest),
                           path=path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(list(path), tree, *rest)


def tree_map_specs(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (dictionaries and lists) and the
    entries at the same places of ``rest``, which may be spec trees (a
    ``P`` is a leaf there, not a tuple to walk)."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_specs(cfg: ArchConfig, params, prefix: tuple = ()) -> Any:
    """A ``P`` for each leaf of the port's parameter tree, or of its
    subtree at path ``prefix`` (leaves: anything with ``.shape``)."""
    style = style_for(cfg)

    def f(path, leaf):
        inner = path[3:] if path and path[0] == "layers" else path
        spec = _param_rule(inner or path, cfg, style)
        return spec if len(spec) <= len(leaf.shape) else \
            P(*spec[:len(leaf.shape)])

    return _map_paths(f, params, path=tuple(str(k) for k in prefix))


class LayerP(P):
    """A ZeRO-1 spec whose first entry shards the layer axis: the
    reference's choice for a leaf stacked under ``layers`` whose largest
    free dimension is the super-block axis (a bias sharded over 'model',
    a gate).  The port's per-layer leaf has no such axis, so the spec
    keeps the entry and names the leaf's ``layer`` of ``n_layers``: the
    data rank whose block of layers holds it keeps the whole moment."""

    def __new__(cls, *entries, layer: int = 0, n_layers: int = 1):
        self = super().__new__(cls, *entries)
        self.layer, self.n_layers = layer, n_layers
        return self


def zero1_specs(param_spec_tree, params, data_divisor: int) -> Any:
    """ZeRO-1: the optimizer moments' specs, each parameter's spec with
    'data' on its largest dimension that is not sharded and that
    ``data_divisor`` divides (none where the spec already uses 'data').
    A leaf of ``params["layers"][i][j]`` counts the super-block axis (the
    reference's stacked leading dimension, ``len(params["layers"])``) as a
    dimension too, the first; where that one wins the spec is a
    ``LayerP``."""
    n_layers = len(params["layers"]) if isinstance(params, dict) and \
        "layers" in params else 0

    def f(path, leaf, spec):
        layer = int(path[1]) if path and path[0] == "layers" else None
        shape = tuple(leaf.shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if layer is not None:
            shape, entries = (n_layers,) + shape, [None] + entries
        best, best_size = -1, 0
        for i, (s, dim) in enumerate(zip(entries, shape)):
            if s is None and dim % data_divisor == 0 and dim > best_size:
                best, best_size = i, dim
        if best >= 0 and "data" not in P(*spec).axes():
            entries[best] = "data"
        if layer is None:
            return P(*entries)
        if entries[0] is None:
            return P(*entries[1:])
        return LayerP(*entries, layer=layer, n_layers=n_layers)

    return _map_paths(f, params, param_spec_tree)


def opt_state_specs(cfg: ArchConfig, params, opt_state,
                    data_divisor: int) -> dict:
    """Specs of ``optim.adamw.init_state``'s tree: ZeRO-1 moments and a
    replicated step."""
    zspec = zero1_specs(param_specs(cfg, params), params, data_divisor)
    return {"mu": zspec, "nu": zspec, "step": P()}


def batch_specs(cfg: ArchConfig, mesh, batch_dict: dict, batch: int) -> dict:
    """Each input's spec: its batch axis over ``_dp_axes``."""
    dp = _dp_axes(tuple(mesh.axis_names), batch, _mesh_shape(mesh),
                  style_for(cfg))
    dp_spec = dp if dp else None
    return {k: P(dp_spec, *([None] * (len(v.shape) - 1)))
            for k, v in batch_dict.items()}
