"""Tensor, data and fully sharded data parallel execution over a mesh of
ranks.

The reference sets partition specs on parameters and sharding constraints
on activations, and XLA's GSPMD inserts the collectives; a sharded
reference step computes the one-device function of the same padded model.
The port runs the same partition by hand, so that its sharded run on N
ranks computes that function too:

* ``Parallel``: one rank's place in a cell: the tensor-parallel axis
  (``model`` in the ``tp`` style), the batch axes (``sharding._dp_axes``),
  the ``data`` axis (ZeRO-1) and, for the FSDP archs
  (``sharding.FSDP_ARCHS``), the ``data`` axis their layer weights are
  sharded over (``fsdp``; size 1 for every other arch), each an
  ``launch.mesh.Axis`` with its process group.
* parameters and optimizer state are cut from whole leaves by their specs
  (``shard_params``, ``init_opt_state``, ``shard_tree``): a dimension of n
  over k ranks gives rank r the r-th block of ``ceil(n / k)`` (the last
  blocks shorter, as GSPMD pads), copied so that no strided view of the
  whole leaf stays alive; ``gather_tree`` puts whole leaves back
  together (checkpoints);
* the two Megatron operators as ``torch.autograd.Function``s:
  ``copy_to`` (identity forward, all-reduce of the gradient backward)
  before a column-parallel product, and ``reduce_from`` (all-reduce
  forward, identity backward) after a row-parallel one, where the
  reference's constraint returns to replicated.
  ``torch.distributed.nn.functional.all_reduce`` sums the gradient in its
  backward too, which after a row-parallel product would scale every
  upstream gradient by the TP degree;
* Megatron sequence parallelism (``Parallel.sp``, the reference's
  ``make_specs(seq_parallel=True)``: its ``act`` spec splits the sequence
  over ``model`` between blocks): the residual stream, norms and residual
  adds hold the rank's block of the sequence (``split_sizes``, the last
  blocks shorter or empty, as GSPMD pads; a decode step's one position
  sits on rank 0).  ``gather_seq`` (all-gather along the sequence,
  reduce-scatter of the gradient) takes ``copy_to``'s place before a
  column-parallel product and ``scatter_seq`` (reduce-scatter, all-gather
  of the gradient) ``reduce_from``'s after a row-parallel one; the
  replicated leaves' gradients (norms, gates, the MoE router) are then
  each rank's part and ``reduce_grads`` sums them over ``model``;
* the model-major expert layout (``Parallel.model_major``, the
  reference's ``expert_axes="model_major"``, arctic-480b: the one MoE arch
  in ``FSDP_ARCHS``): each model rank runs ``E / tp`` experts whole on the
  tokens dispatched to them, where the default layout runs every expert
  on the rank's ``d_ff`` columns.  The parameters keep their specs, so a
  layer's expert weights, as the FSDP gather leaves them (``[E, d, f /
  tp]``), are brought to ``[E / tp, d, f]`` by one all-to-all over
  ``model`` a leaf (``expert_major``; the gradient goes back by the
  reverse all-to-all);
* FSDP's operator (``FSDP.gather``, an ``autograd.Function``): a layer
  leaf's ``(data, model)`` block all-gathered over ``data`` into the
  tp-rank's Megatron shard just before its super-block runs; backward,
  the gradient summed over ``data`` and cut back to the block (a
  reduce-scatter: gloo has none, so an all-reduce and a narrow).  Each
  rank holds only its blocks between steps, and its optimizer moments are
  those blocks' (``zero_specs``);
* vocab-parallel embedding and cross-entropy (``embed_lookup``,
  ``cross_entropy_terms``; the head is a column-parallel product);
* the data-parallel pieces: a rank's rows of a global batch
  (``local_rows``, accumulation-aware), rows gathered back
  (``gather_rows``), gradients summed over the batch axes (an FSDP
  leaf's over those other than ``data``, whose sum its reduce-scatter
  made) and the global gradient norm over the shards (``reduce_grads``,
  ``grad_norm``).

Collectives go through ``distributed.collectives`` (counted, FSDP's under
``fsdp_all_gather`` and ``fsdp_all_reduce``, sequence parallelism's under
``sp_all_gather`` and ``sp_reduce_scatter``, the expert layout's under
``expert_all_to_all``; staged through the host where gloo cannot take a
CUDA tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.launch.mesh import Axis, RankMesh
from repro_torch.models.config import ArchConfig
from repro_torch.optim.tree import tree_leaves
from . import collectives as coll
from . import sharding as shd

__all__ = ["FSDP", "Parallel", "copy_to", "cross_entropy_terms",
           "embed_lookup", "expert_major", "gather_leaf", "gather_rows",
           "gather_seq", "gather_tree", "grad_norm", "init_opt_state",
           "local_rows", "make_parallel", "reduce_from", "reduce_grads",
           "scatter_seq", "seq_block", "shard_leaf", "shard_params",
           "shard_tree", "split_sizes", "zero_specs"]


def split_sizes(n: int, k: int) -> list[int]:
    """The block sizes of n over k ranks: ``ceil(n / k)`` each, the last
    ones shorter (possibly empty)."""
    c = -(-n // k)
    return [max(0, min(c, n - r * c)) for r in range(k)]


def _span(n: int, axis: Axis) -> tuple[int, int]:
    """(start, length) of ``axis.rank``'s block of n."""
    sizes = split_sizes(n, axis.size)
    return sum(sizes[:axis.rank]), sizes[axis.rank]


@dataclasses.dataclass
class Parallel:
    """One rank's place in a sharded cell (``make_parallel``)."""
    cfg: ArchConfig
    mesh: RankMesh
    tp: Axis                    # the model axis in the tp style, else 1
    dp: Axis                    # the batch axes (_dp_axes), jointly
    data: Axis                  # the data axis (ZeRO-1)
    # the data axis an FSDP arch's layer weights are sharded over (size 1
    # for every other arch), and the names of the batch axes
    fsdp: Axis = dataclasses.field(default_factory=Axis)
    dp_names: tuple = ()
    # Megatron sequence parallelism over the tp axis, and the model-major
    # expert layout (``make_parallel``)
    sp: bool = False
    model_major: bool = False

    @property
    def member(self) -> bool:
        return self.mesh.member

    @property
    def tp_axis(self) -> Optional[Axis]:
        """The tensor-parallel axis, or None at tp = 1 (the blocks' code
        path is then the one-device one)."""
        return self.tp if self.tp.size > 1 else None

    def axis_for(self, entry) -> Axis:
        """The ``Axis`` a spec entry (a name or a tuple of names) shards
        over on this rank."""
        return self.mesh.axes((entry,) if isinstance(entry, str)
                              else tuple(entry))

    def fsdp_leaf(self, spec: shd.P) -> bool:
        """Whether a parameter of ``spec`` is held as its block over the
        FSDP axis (gathered before use, its gradient reduce-scattered)."""
        return self.fsdp.size > 1 and "data" in shd.P(*spec).axes()

    def fsdp_ctx(self, n_experts: int) -> Optional["FSDP"]:
        """The blocks' FSDP context (``BlockCtx.fsdp``), or None where no
        weight is sharded over ``data``; ``n_experts``: the padded expert
        count (``ModelDims.expert_pad``)."""
        if self.fsdp.size == 1:
            return None
        return FSDP(cfg=self.cfg, axis=self.fsdp,
                    reduce="data" in self.dp_names, n_experts=n_experts)


# the blocks sequence parallelism runs (attention and its MoE and cross
# variants); the scans of the other kinds need the whole sequence, and no
# published tp-style config has them
_SP_BLOCKS = {"attn", "moe", "cross_attn"}


def make_parallel(cfg: ArchConfig, mesh: RankMesh, batch: int,
                  seq_parallel: bool = False,
                  expert_axes: str = "default") -> Parallel:
    """The rank's ``Parallel`` for ``cfg`` at global batch ``batch`` on
    ``mesh``.  The FSDP archs' layer weights are sharded over ``data`` as
    well as ``model``: at a ``data`` axis above 1 each super-block gathers
    its weights over ``data`` before it runs (``FSDP``); at 1 FSDP is
    tensor parallelism.

    ``seq_parallel`` and ``expert_axes`` are ``sharding.make_specs``'
    options, read by the same rules: sequence parallelism where
    ``model`` is not a batch axis (it then splits the sequence over the
    tensor-parallel axis; a ``dp``-style arch has none, and runs as
    without it), the model-major layout for a MoE arch in
    ``FSDP_ARCHS``.  Neither changes a parameter's spec."""
    if expert_axes not in ("default", "model_major"):
        raise ValueError(f"expert_axes {expert_axes!r}: want 'default' or "
                         "'model_major'")
    spec = mesh.spec
    style = shd.style_for(cfg)
    shape = dict(zip(spec.axis_names, spec.shape))
    dp_axes = shd._dp_axes(spec.axis_names, batch, shape, style)
    fsdp = (mesh.axis("data") if cfg.name in shd.FSDP_ARCHS
            and style == "tp" else Axis())
    tp = mesh.axis("model") if style == "tp" else Axis()
    sp = bool(seq_parallel) and "model" not in dp_axes and tp.size > 1
    if sp and not {k.value for k in cfg.block_pattern} <= _SP_BLOCKS:
        raise ValueError(f"{cfg.name}: sequence parallelism runs attention, "
                         "MoE and cross-attention blocks only")
    model_major = (expert_axes == "model_major" and cfg.moe is not None
                   and cfg.name in shd.FSDP_ARCHS and tp.size > 1)
    return Parallel(cfg=cfg, mesh=mesh, tp=tp, dp=mesh.axes(dp_axes),
                    data=mesh.axis("data"), fsdp=fsdp,
                    dp_names=tuple(dp_axes), sp=sp, model_major=model_major)


# ---------------------------------------------------------------------------
# cutting and joining leaves
# ---------------------------------------------------------------------------

def _layer_owner(spec: shd.P, par: Parallel) -> Optional[bool]:
    """For a ``sharding.LayerP`` over a data axis above 1, whether this
    rank's block of the layers holds the leaf's; None otherwise."""
    if not isinstance(spec, shd.LayerP) or par.data.size == 1:
        return None
    lo, n = _span(spec.n_layers, par.data)
    return lo <= spec.layer < lo + n


def _owner_rank(spec: shd.P, par: Parallel) -> int:
    sizes = split_sizes(spec.n_layers, par.data.size)
    starts = [sum(sizes[:r]) for r in range(len(sizes))]
    return max(r for r, lo in enumerate(starts)
               if lo <= spec.layer and sizes[r])


def _dims(spec: shd.P) -> shd.P:
    """The entries of ``spec`` over the leaf's own dimensions."""
    return shd.P(*spec[1:]) if isinstance(spec, shd.LayerP) else spec


def shard_leaf(t: torch.Tensor, spec: shd.P, par: Parallel) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` under ``spec``: a
    contiguous copy, or ``t`` itself where nothing is sharded (a
    ``LayerP`` leaf: whole on the data rank that holds its layer, empty on
    the others)."""
    if _layer_owner(spec, par) is False:
        return t.new_empty((0,))
    out = t
    for i, entry in enumerate(_dims(spec)):
        if entry is None:
            continue
        axis = par.axis_for(entry)
        if axis.size > 1:
            lo, n = _span(t.shape[i], axis)
            out = out.narrow(i, lo, n)
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree: Any, specs: Any, par: Parallel) -> Any:
    return shd.tree_map_specs(lambda t, s: shard_leaf(t, s, par), tree,
                              specs)


def shard_params(cfg: ArchConfig, params: Any, par: Parallel,
                 prefix: tuple = ()) -> Any:
    """The rank's shards of a parameter (sub)tree at ``prefix``
    (``init_params(shard=...)`` cuts each layer as it is drawn)."""
    return shard_tree(params, shd.param_specs(cfg, params, prefix), par)


def _gather_dim(t: torch.Tensor, dim: int, axis: Axis,
                sizes: Optional[list[int]] = None,
                label: str = "all_gather") -> torch.Tensor:
    """Every rank's block of ``t`` along ``dim`` joined in rank order;
    blocks may differ in length (``split_sizes``; gathered first unless
    given)."""
    if sizes is None:
        lens = torch.tensor([t.shape[dim]], dtype=torch.int64,
                            device=t.device)
        sizes = [int(s) for s in coll.all_gather(lens, axis)]
    width = max(sizes)
    pad = list(t.shape)
    pad[dim] = width - t.shape[dim]
    src = torch.cat([t, t.new_zeros(pad)], dim) if pad[dim] else t
    parts = coll.all_gather(src, axis, label=label)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim)


def gather_leaf(t: torch.Tensor, spec: shd.P, par: Parallel) -> torch.Tensor:
    """The whole leaf from every rank's block (a collective over the
    spec's axes)."""
    owner = _layer_owner(spec, par)
    if owner is not False:
        for i, entry in enumerate(_dims(spec)):
            if entry is None:
                continue
            axis = par.axis_for(entry)
            if axis.size > 1:
                t = _gather_dim(t, i, axis)
    if owner is None:
        return t
    src = _owner_rank(spec, par)
    shape = torch.tensor(t.shape if owner else [0] * (len(spec) - 1),
                         dtype=torch.int64, device=t.device)
    coll.broadcast(shape, src, par.data)
    buf = t if owner else t.new_empty([int(d) for d in shape])
    return coll.broadcast(buf.contiguous(), src, par.data)


def gather_tree(tree: Any, specs: Any, par: Parallel,
                to_host: bool = True) -> Any:
    """Whole leaves, one at a time (each on the host when ``to_host``, so
    no rank holds the whole tree on its device)."""
    def one(t, s):
        full = gather_leaf(t, s, par)
        return full.cpu() if to_host else full
    return shd.tree_map_specs(one, tree, specs)


def zero_specs(cfg: ArchConfig, params: Any, par: Parallel) -> Any:
    """The cut of each leaf the rank's update works on: ZeRO-1's
    (``sharding.zero1_specs``: 'data' on the largest free dimension),
    except that an FSDP leaf (``Parallel.fsdp_leaf``) is already the
    rank's block over 'data': ``P()``, nothing more to cut, its update
    local."""
    pspecs = shd.param_specs(cfg, params)
    z = shd.zero1_specs(pspecs, params, par.data.size)
    if par.fsdp.size == 1:
        return z
    return shd.tree_map_specs(
        lambda zs, ps: shd.P() if par.fsdp_leaf(ps) else zs, z, pspecs)


def init_opt_state(opt, params: Any, par: Parallel) -> tuple[dict, dict]:
    """AdamW's state for the rank's parameters (each moment the rank's
    block of its ``zero_specs`` spec: ZeRO-1's, or an FSDP leaf's own
    block), and the specs of the whole state
    (``sharding.opt_state_specs``: what ``gather_tree`` joins)."""
    specs = shd.opt_state_specs(par.cfg, params, None, par.data.size)
    local = zero_specs(par.cfg, params, par)

    def zeros(p, s):
        if _layer_owner(s, par) is False:
            return torch.zeros((0,), dtype=opt.moment_dtype, device=p.device)
        shape = list(p.shape)
        for i, entry in enumerate(_dims(s)):
            if entry == "data" and par.data.size > 1:
                shape[i] = _span(shape[i], par.data)[1]
        return torch.zeros(shape, dtype=opt.moment_dtype, device=p.device)

    moments = [shd.tree_map_specs(zeros, params, local) for _ in range(2)]
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"mu": moments[0], "nu": moments[1], "step": step}, specs


def zero_view(t: torch.Tensor, zspec: shd.P, par: Parallel) -> torch.Tensor:
    """The rank's ZeRO-1 block of a (model-sharded) parameter or
    gradient under its ``zero_specs`` spec: a view along the spec's 'data'
    dimension (a ``LayerP`` leaf: whole on the rank that holds its layer,
    empty elsewhere; an FSDP leaf, ``P()``: itself)."""
    owner = _layer_owner(zspec, par)
    if owner is not None:
        return t if owner else t.reshape(-1)[:0]
    if par.data.size > 1:
        for i, entry in enumerate(zspec):
            if entry == "data":
                lo, n = _span(t.shape[i], par.data)
                return t.narrow(i, lo, n)
    return t


def zero_gather(t: torch.Tensor, zspec: shd.P, par: Parallel,
                like: torch.Tensor) -> torch.Tensor:
    """A ZeRO-1 block's updated values from every data rank, joined into
    a tensor like ``like`` (the rank's parameter; an FSDP leaf's update
    is its own)."""
    owner = _layer_owner(zspec, par)
    if owner is not None:
        buf = t.contiguous() if owner else torch.empty_like(like)
        return coll.broadcast(buf, _owner_rank(zspec, par), par.data)
    if par.data.size > 1:
        for i, entry in enumerate(zspec):
            if entry == "data":
                return _gather_dim(t, i, par.data,
                                   split_sizes(like.shape[i], par.data.size))
    return t


# ---------------------------------------------------------------------------
# FSDP: a layer's weights gathered over 'data' as it runs
# ---------------------------------------------------------------------------

class _GatherFSDP(torch.autograd.Function):
    """A leaf's blocks joined over the FSDP axis along ``dim``; backward,
    the gradient summed over the axis (where it is a batch axis: each
    rank's rows gave a share) and cut back to the rank's block."""

    @staticmethod
    def forward(ctx, w, axis: Axis, dim: int, sizes: tuple, reduce: bool):
        ctx.args = (axis, dim, sum(sizes[:axis.rank]), sizes[axis.rank],
                    reduce)
        return _gather_dim(w, dim, axis, list(sizes),
                           label="fsdp_all_gather")

    @staticmethod
    def backward(ctx, g):
        axis, dim, lo, n, reduce = ctx.args
        if reduce:
            g = coll.all_reduce(
                g.clone(memory_format=torch.contiguous_format), axis.group,
                label="fsdp_all_reduce")
        return g.narrow(dim, lo, n).contiguous(), None, None, None, None


@dataclasses.dataclass(frozen=True)
class FSDP:
    """What a super-block needs to gather its weights over the FSDP axis
    (``Parallel.fsdp_ctx``): the axis, whether it is a batch axis (the
    backward sums over it), and the padded expert count.  The dimension
    an FSDP spec puts on 'data' spans the model width, or a MoE's stacked
    experts (``sharding._param_rule``)."""
    cfg: ArchConfig
    axis: Axis
    reduce: bool
    n_experts: int

    def gather(self, layer: Any) -> Any:
        """The tp-rank's Megatron shards of a super-block's parameters
        (``params["layers"][i]``) from the rank's ``(data, model)``
        blocks: one all-gather a leaf sharded over 'data', every other
        leaf as it is."""
        specs = shd.param_specs(self.cfg, layer, ("layers", "0"))

        def one(path, t, spec):
            if "data" not in spec.axes():
                return t
            dim = list(spec).index("data")
            whole = (self.n_experts if path[-2] == "moe"
                     else self.cfg.d_model)
            sizes = split_sizes(whole, self.axis.size)
            if t.shape[dim] != sizes[self.axis.rank]:
                raise ValueError(
                    f"{'/'.join(path)}: a block of {t.shape[dim]} along "
                    f"dim {dim}, want {sizes[self.axis.rank]} of {whole}")
            return _GatherFSDP.apply(t, self.axis, dim, tuple(sizes),
                                     self.reduce)
        return shd._map_paths(one, layer, specs)


# ---------------------------------------------------------------------------
# the Megatron operators
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return coll.all_reduce(g.clone(memory_format=torch.contiguous_format),
                               ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward; the gradient passed on as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return coll.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """Every rank's columns joined along the last axis; the gradient's own
    columns backward."""

    @staticmethod
    def forward(ctx, x, axis: Axis, sizes: tuple):
        ctx.span = (sum(sizes[:axis.rank]), sizes[axis.rank])
        width = max(sizes)
        src = x
        if x.shape[-1] < width:
            src = torch.cat([x, x.new_zeros(x.shape[:-1] + (
                width - x.shape[-1],))], -1)
        parts = coll.all_gather(src, axis)
        return torch.cat([p[..., :s] for p, s in zip(parts, sizes)], -1)

    @staticmethod
    def backward(ctx, g):
        lo, n = ctx.span
        return g[..., lo:lo + n].contiguous(), None, None


class _GatherSeq(torch.autograd.Function):
    """Every rank's block of the sequence (dim 1) joined; backward, the
    gradient summed over the axis and cut back to the rank's block (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis: Axis, sizes: tuple):
        ctx.args = (axis, sizes)
        return _gather_dim(x, 1, axis, list(sizes), label="sp_all_gather")

    @staticmethod
    def backward(ctx, g):
        axis, sizes = ctx.args
        return coll.reduce_scatter(g, axis, 1, list(sizes),
                                   label="sp_reduce_scatter"), None, None


class _ScatterSeq(torch.autograd.Function):
    """Partial sums over the whole sequence reduce-scattered to the rank's
    block; backward, the blocks' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, axis: Axis, sizes: tuple):
        ctx.args = (axis, sizes)
        return coll.reduce_scatter(x, axis, 1, list(sizes),
                                   label="sp_reduce_scatter")

    @staticmethod
    def backward(ctx, g):
        axis, sizes = ctx.args
        return _gather_dim(g.contiguous(), 1, axis, list(sizes),
                           label="sp_all_gather"), None, None


class _SeqBlock(torch.autograd.Function):
    """A replicated sequence's rank block; backward, the blocks'
    gradients all-gathered (each rank's positions' share)."""

    @staticmethod
    def forward(ctx, x, axis: Axis, sizes: tuple):
        ctx.args = (axis, sizes)
        return x.narrow(1, sum(sizes[:axis.rank]),
                        sizes[axis.rank]).contiguous()

    @staticmethod
    def backward(ctx, g):
        axis, sizes = ctx.args
        return _gather_dim(g.contiguous(), 1, axis, list(sizes),
                           label="sp_all_gather"), None, None


def gather_seq(x: torch.Tensor, tp: Axis, sizes) -> torch.Tensor:
    """Before a column-parallel product under sequence parallelism: the
    whole sequence from the ranks' blocks (``sizes``, their lengths)."""
    return _GatherSeq.apply(x, tp, tuple(sizes))


def scatter_seq(x: torch.Tensor, tp: Axis, sizes) -> torch.Tensor:
    """After a row-parallel product under sequence parallelism: the
    partial sums added up, the rank's block of the sequence kept."""
    return _ScatterSeq.apply(x, tp, tuple(sizes))


def seq_block(x: torch.Tensor, tp: Axis, sizes) -> torch.Tensor:
    """The rank's block of a sequence every rank holds whole (an input
    the stack begins from)."""
    return _SeqBlock.apply(x, tp, tuple(sizes))


class _ExpertMajor(torch.autograd.Function):
    """``[E, .., f / tp, ..]`` (every expert, the rank's ``f`` columns at
    ``dim``) to ``[E / tp, .., f, ..]`` (the rank's experts whole) by one
    all-to-all over the axis; backward, the reverse all-to-all."""

    @staticmethod
    def forward(ctx, w, axis: Axis, dim: int):
        ctx.args = (axis, dim)
        got = coll.all_to_all(w, axis, label="expert_all_to_all")
        # chunk j: rank j's columns of this rank's experts
        return torch.cat(got.chunk(axis.size), dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.args
        # chunk j: this rank's experts' gradient on rank j's columns
        got = coll.all_to_all(torch.cat(g.chunk(axis.size, dim)), axis,
                              label="expert_all_to_all")
        return got, None, None


def expert_major(w: torch.Tensor, tp: Axis, dim: int,
                 f: int) -> torch.Tensor:
    """An expert leaf of every expert on the rank's columns of ``f``
    (``d_ff``, along ``dim``) as the rank's block of the experts, whole.
    The experts are padded to a multiple of tp (``ModelDims``); ``f`` must
    split evenly too (the published configs' do)."""
    if w.shape[0] % tp.size or f % tp.size:
        raise ValueError(f"model-major experts: {w.shape[0]} experts and "
                         f"d_ff {f} over {tp.size} ranks must split evenly")
    return _ExpertMajor.apply(w, tp, dim)


def copy_to(x: torch.Tensor, tp: Optional[Axis]) -> torch.Tensor:
    """Before a column-parallel product (no-op without an axis)."""
    return x if tp is None else _CopyToTP.apply(x, tp.group)


def reduce_from(x: torch.Tensor, tp: Optional[Axis]) -> torch.Tensor:
    """After a row-parallel product: the partial sums added up."""
    return x if tp is None else _ReduceFromTP.apply(x, tp.group)


def gather_last(x: torch.Tensor, tp: Axis, full: int) -> torch.Tensor:
    """Columns sharded over ``tp`` (``full`` in all) joined."""
    return _GatherLast.apply(x, tp, tuple(split_sizes(full, tp.size)))


# ---------------------------------------------------------------------------
# vocab-parallel embedding and cross-entropy
# ---------------------------------------------------------------------------

def embed_lookup(tokens: torch.Tensor, embed: torch.Tensor, tied: bool,
                 tp: Axis, vocab: int, d_model: int,
                 sp: Optional[tuple] = None) -> torch.Tensor:
    """The embedding of ``tokens`` from the rank's block of ``embed``:
    tied (``P("model", None)``, rows of the vocab) the rank's rows looked
    up and the partial sums added; untied (``P(None, "model")``, columns of
    d_model) the rank's columns gathered along d.  Under sequence
    parallelism (``sp``, the blocks' lengths) the rank's block of the
    sequence: the tied sums reduce-scattered, the untied rows cut from the
    gathered ones."""
    if not tied:
        x = gather_last(torch.nn.functional.embedding(tokens, embed), tp,
                        d_model)
        return seq_block(x, tp, sp) if sp else x
    lo, n = _span(vocab, tp)
    mine = (tokens >= lo) & (tokens < lo + n)
    local = torch.nn.functional.embedding(
        torch.where(mine, tokens - lo, torch.zeros_like(tokens)), embed)
    local = local * mine[..., None].to(local.dtype)
    return scatter_seq(local, tp, sp) if sp else reduce_from(local, tp)


def cross_entropy_terms(logits_local: torch.Tensor, labels: torch.Tensor,
                        tp: Axis, vocab: int) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` per position over the whole
    vocab from the rank's float32 columns: the maximum (no gradient) and
    the sums of exponentials and of the label's logit reduced over
    ``tp``."""
    lo, n = _span(vocab, tp)
    m = logits_local.detach().amax(dim=-1)
    coll.all_reduce(m, tp.group, op="max")
    se = reduce_from(torch.exp(logits_local - m[..., None]).sum(-1), tp)
    mine = (labels >= lo) & (labels < lo + n)
    idx = torch.where(mine, labels - lo, torch.zeros_like(labels))
    ll = torch.gather(logits_local, -1, idx[..., None])[..., 0]
    ll = reduce_from(ll * mine.to(ll.dtype), tp)
    return m + torch.log(se) - ll


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------

def local_rows(x, par: Parallel, accum: int = 1):
    """The rank's rows of a global batch array (numpy or torch): the batch
    in ``accum`` microbatches, each split over the batch axes in blocks,
    the rank's block of each in order (so that microbatch i of the rank is
    its block of the global microbatch i)."""
    if par.dp.size == 1:
        return x
    rest = tuple(x.shape[1:])
    return x.reshape((accum, par.dp.size, -1) + rest)[:, par.dp.rank] \
        .reshape((-1,) + rest)


def gather_rows(x: torch.Tensor, par: Parallel) -> torch.Tensor:
    """Every batch rank's rows joined in rank order (the global batch)."""
    if par.dp.size == 1:
        return x
    return torch.cat(coll.all_gather(x, par.dp), 0)


def _flat_reduce(tensors: list[torch.Tensor], axis: Axis) -> None:
    """All-reduce (sum) ``tensors`` in place over ``axis``, one
    collective per dtype."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = coll.all_reduce(torch.cat([t.reshape(-1) for t in ts]),
                               axis.group)
        for t, part in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def reduce_grads(grads: Any, pspecs: Any, par: Parallel) -> Any:
    """Gradients summed over the batch axes (each rank's loss is its rows'
    share of the global mean, so the sum is the global gradient); an FSDP
    leaf's (``Parallel.fsdp_leaf``) over the batch axes but 'data', which
    its reduce-scatter has summed already.  Under sequence parallelism a
    leaf not sharded over 'model' is summed over it first: each rank's is
    its block of the sequence's share (a norm, a gate) or its experts'
    (the router)."""
    own: list[torch.Tensor] = []
    rest: list[torch.Tensor] = []
    local: list[torch.Tensor] = []

    def sort(g, s):
        (own if par.fsdp_leaf(s) else rest).append(g)
        if par.sp and "model" not in shd.P(*s).axes():
            local.append(g)
    shd.tree_map_specs(sort, grads, pspecs)
    if par.sp and local:
        _flat_reduce(local, par.tp)
    if par.dp.size > 1 and rest:
        _flat_reduce(rest, par.dp)
    others = par.mesh.axes(tuple(n for n in par.dp_names if n != "data"))
    if others.size > 1 and own:
        _flat_reduce(own, others)
    return grads


def grad_norm(grads: Any, pspecs: Any, par: Parallel) -> torch.Tensor:
    """The global L2 norm of gradients held as shards: squares of leaves
    sharded over the tensor-parallel axis summed over it (an FSDP leaf's
    over the FSDP axis first), replicated leaves counted once."""
    sharded, fsdp, replicated = [], [], []

    def part(g, spec):
        sq = torch.sum(torch.square(g.float()))
        if par.fsdp_leaf(spec):
            fsdp.append(sq)
        elif any(par.axis_for(e).size > 1 for e in spec if e is not None):
            sharded.append(sq)
        else:
            replicated.append(sq)
    shd.tree_map_specs(part, grads, pspecs)
    total = sum(replicated, torch.zeros((), device=tree_leaves(
        grads)[0].device))
    if fsdp:
        sharded.append(coll.all_reduce(torch.stack(fsdp).sum(),
                                       par.fsdp.group))
    if sharded:
        s = torch.stack(sharded).sum()
        if par.tp.size > 1:
            coll.all_reduce(s, par.tp.group)
        total = total + s
    return torch.sqrt(total)
