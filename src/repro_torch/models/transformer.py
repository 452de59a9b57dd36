"""Config-driven model stack: init / forward / prefill / decode
(counterpart of ``repro.models.transformer``).

Parameters are plain dictionaries of tensors.  Where the reference stacks
each pattern position's parameters over the super-block axis and runs the
stack under ``jax.lax.scan``, the port keeps one dictionary per layer
(``params["layers"][super_block][position]``) and runs the super-blocks in a
Python loop.  ``ModelDims.create(cfg, tp)`` pads query heads, KV heads,
vocab and experts to the tensor-parallel degree as the reference does
(exact at tp = 1).  Every entry point takes ``par``, a rank's
``distributed.tensor_parallel.Parallel``: the batch it is given is then the
rank's rows, the parameters its shards (``init_params(shard=...)``), and
the blocks run on the rank's heads, ``d_ff`` columns, experts and vocab
columns with the Megatron collectives between them; an FSDP arch at a
``data`` axis above 1 holds each layer's weights as ``(data, model)``
blocks, and the stack gathers a super-block's over ``data`` just before
it runs and lets them go after (``tensor_parallel.FSDP``).  Under
sequence parallelism (``par.sp``) the stack's input is the rank's block
of the sequence (the embedding reduce-scattered), the blocks keep it so
between their layers, and the logits and the loss gather the sequence
back before the head.  ``par=None`` is the one-device path.

Caches mirror the layer list (``cache[super_block][position]``).  Prefill
and decode write the attention KV caches in place and replace each Mamba-2
block's state and conv window and each xLSTM block's states; prefill puts
each cross block's projected context keys and values in its ``cross``
entry, which decode reads.  Both return the cache they were given.
Positions and cache indices are Python ints, so a decode loop reads nothing
back from the device.

Training: ``loss_fn`` is the reference's sequence-chunked cross-entropy,
and ``_run_stack(remat=True)`` recomputes each super-block in the backward
pass (``torch.utils.checkpoint``, non-reentrant) under one of the
reference's three policies (``REMAT_POLICIES``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from .blocks import BlockCtx, block_apply, block_cache, block_init
from .config import ArchConfig, BlockKind
from .layers import _col_in, dense_init, rmsnorm, rmsnorm_init

Params = dict


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Head, vocab and expert counts of the stack, padded to the
    tensor-parallel degree ``tp`` (exact at tp = 1; ``expert_pad`` is 1
    without MoE)."""
    n_q_pad: int
    n_kv_pad: int
    vocab_pad: int
    expert_pad: int = 1
    tp: int = 1

    @staticmethod
    def create(cfg: ArchConfig, tp: int = 1) -> "ModelDims":
        """The reference's padding: query heads, vocab and experts to a
        multiple of tp; KV heads likewise, and to tp itself where tp
        exceeds them (each rank keeps a KV head of its own)."""
        n_kv = cfg.n_kv_heads if cfg.n_kv_heads % tp == 0 else _pad_to(
            cfg.n_kv_heads, tp)
        if tp > cfg.n_kv_heads:
            n_kv = tp
        return ModelDims(n_q_pad=_pad_to(cfg.n_heads, tp), n_kv_pad=n_kv,
                         vocab_pad=_pad_to(cfg.vocab, tp),
                         expert_pad=(_pad_to(cfg.moe.n_experts, tp)
                                     if cfg.moe else 1), tp=tp)


def make_ctx(cfg: ArchConfig, dims: ModelDims, mode: str,
             positions: torch.Tensor, cache_index: Optional[int] = None,
             cross_ctx: Optional[torch.Tensor] = None,
             max_cache_len: int = 0, par=None) -> BlockCtx:
    """The blocks' context; with ``par`` at tp > 1 the head counts are the
    rank's (the padded counts over tp) and ``tp`` its axis; ``fsdp`` the
    FSDP axis's context where layer weights are sharded over ``data``;
    ``sp`` the sequence's blocks over tp (``positions`` holds the whole
    sequence) under sequence parallelism."""
    tp = par.tp_axis if par is not None else None
    n = tp.size if tp is not None else 1
    return BlockCtx(cfg=cfg, mode=mode, positions=positions,
                    cache_index=cache_index, cross_ctx=cross_ctx,
                    n_q_pad=dims.n_q_pad // n,
                    n_kv_pad=dims.n_kv_pad // n, expert_pad=dims.expert_pad,
                    max_cache_len=max_cache_len, tp=tp,
                    fsdp=(par.fsdp_ctx(dims.expert_pad) if par is not None
                          else None),
                    sp=_sp_sizes(par, positions.shape[-1]),
                    model_major=par is not None and par.model_major)


def _sp_sizes(par, seq: int) -> Optional[tuple]:
    """The lengths of the ranks' blocks of a sequence of ``seq`` under
    sequence parallelism, else None."""
    if par is None or not par.sp:
        return None
    from repro_torch.distributed.tensor_parallel import split_sizes
    return tuple(split_sizes(seq, par.tp.size))


def _dtype(dtype) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(
        dtype, dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, dims: ModelDims, *,
                generator: torch.Generator,
                dtype=torch.bfloat16, shard=None, device=None) -> Params:
    """Random weights drawn from ``generator``, on ``device`` (default: the
    generator's; ``meta`` with a CPU generator gives the shapes and types
    alone, as ``launch.cells.param_shapes`` takes them).

    Draws are made on the device (a CUDA generator for the card), in the
    reference's order of layers, but torch's normal stream is not JAX's:
    the same seed gives other weights (``models.convert`` carries the
    reference's own).  Mamba-2's ``A_log``, ``D`` and ``dt_bias`` are
    float32 whatever ``dtype`` is, as in the reference.

    ``shard(path, subtree)``, where given, cuts each layer, the embedding,
    the final norm and the head as soon as it is drawn (the whole model
    never lies on one rank); the draws are those of the unsharded call.
    """
    dtype = _dtype(dtype)
    ctx = make_ctx(cfg, dims, "full", torch.zeros((1,), dtype=torch.long))
    with torch.device(generator.device if device is None else device):
        return _init_params(cfg, dims, generator, dtype, shard, ctx)


def _init_params(cfg: ArchConfig, dims: ModelDims, generator: torch.Generator,
                 dtype: torch.dtype, shard, ctx: BlockCtx) -> Params:
    pattern = cfg.block_pattern
    cut = shard if shard is not None else (lambda path, tree: tree)
    layers = [[cut(("layers", si, pi),
                   block_init(generator, cfg, ctx, dtype, kind))
               for pi, kind in enumerate(pattern)]
              for si in range(cfg.n_super_blocks)]
    params: Params = {
        "embed": cut(("embed",), (torch.randn(
            (dims.vocab_pad, cfg.d_model), generator=generator)
            * 0.02).to(dtype)),
        "layers": layers,
        "final_ln": cut(("final_ln",),
                        rmsnorm_init(cfg.d_model, dtype)),
    }
    if BlockKind.SHARED_ATTN in pattern:
        params["shared_attn"] = cut(("shared_attn",), block_init(
            generator, cfg, ctx, dtype, BlockKind.ATTN))
    if not cfg.tie_embeddings:
        params["lm_head"] = cut(("lm_head",), dense_init(
            generator, cfg.d_model, dims.vocab_pad, dtype))
    return params


# ---------------------------------------------------------------------------
# forward (full sequence: prefill) and the training loss
# ---------------------------------------------------------------------------

def _inputs(cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """The batch's tokens [B, S] (or frames [B, S, d])."""
    if cfg.frontend_stub and "frames" in batch:
        return batch["frames"]
    return batch["tokens"]


def _embed(cfg: ArchConfig, params: Params, batch: dict, dims=None,
           tp=None, sp: Optional[tuple] = None
           ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The stack's input in the model's type, and the batch's
    ``cross_ctx`` (the VLM's context, in its own type) or None.  ``tp``:
    the rank's block of the embedding (``tensor_parallel.embed_lookup``);
    ``sp``: the sequence's blocks, of which the rank's is returned."""
    if cfg.frontend_stub and "frames" in batch:
        x = batch["frames"]
        if sp:
            from repro_torch.distributed import tensor_parallel as tpl
            x = tpl.seq_block(x, tp, sp)
    elif tp is not None:
        from repro_torch.distributed import tensor_parallel as tpl
        x = tpl.embed_lookup(batch["tokens"], params["embed"],
                             cfg.tie_embeddings, tp, dims.vocab_pad,
                             cfg.d_model, sp=sp)
    else:
        # a gather; its backward sums repeated tokens in a fixed order on
        # the card (a sort, not float atomics), so training reruns bit for
        # bit
        x = torch.nn.functional.embedding(batch["tokens"], params["embed"])
    return (x.to(torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32),
            batch.get("cross_ctx"))


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor, dims=None,
            tp=None, sp: Optional[tuple] = None,
            last_only: bool = False) -> torch.Tensor:
    """Logits over the whole (padded) vocab; under ``tp`` each rank's
    vocab columns, gathered; ``last_only``: the last position's alone.
    Under ``sp`` x is the rank's block of the sequence: normed there, the
    sequence (or its last position, from the rank that holds it)
    gathered before the head."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    if last_only and sp:            # the last non-empty block's last row
        owner = max(r for r, n in enumerate(sp) if n)
        x = x[:, -1:] if tp.rank == owner else x[:, :0]
        sp = tuple(int(r == owner) for r in range(len(sp)))
    elif last_only:
        x = x[:, -1:]
    x = _col_in(rmsnorm(params["final_ln"], x, cfg.norm_eps), tp, sp)
    y = x @ w.to(x.dtype)
    if tp is None:
        return y
    from repro_torch.distributed import tensor_parallel as tpl
    return tpl.gather_last(y, tp, dims.vocab_pad)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _saving(ops: tuple):
    """A selective-checkpoint context factory that keeps the outputs of
    ``ops`` and recomputes everything else."""
    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


# The reference's jax.checkpoint policies: ``nothing`` saves only each
# super-block's input; ``dots`` also the outputs of products without batch
# dimensions (torch dispatches a dense layer's ``x @ w`` as ``mm``);
# ``checkpoint_dots`` those of every product (``bmm`` too: the attention
# and SSD einsums of the plain paths).  The CUDA kernels' outputs are
# recomputed under all three.
REMAT_POLICIES = {
    "nothing": None,
    "dots": _saving(_MATMULS),
    "checkpoint_dots": _saving(_MATMULS + _BATCHED),
}


def _run_stack(cfg: ArchConfig, params: Params, x: torch.Tensor,
               ctx: BlockCtx, cache: Optional[list], remat: bool = False,
               remat_policy: str = "nothing"
               ) -> tuple[torch.Tensor, Optional[list]]:
    """Every super-block in order; each block's new cache replaces its
    entry of ``cache`` (attention caches are the same, updated, dicts).
    ``remat`` (training, no cache) recomputes each super-block in the
    backward pass under ``REMAT_POLICIES[remat_policy]``.

    Under ``ctx.fsdp`` a super-block's weights are gathered just before it
    runs and dropped after it, so one super-block's gathered weights live
    at a time (no prefetch); under ``remat`` the gather is inside the
    recomputed function, so the backward gathers again and no gathered
    weight is saved for it.  Without remat, autograd keeps each gathered
    weight for its backward, as it keeps the activations."""
    shared = params.get("shared_attn")

    def gathered(layer_params):
        return layer_params if ctx.fsdp is None else ctx.fsdp.gather(
            layer_params)

    if remat:
        if cache is not None:
            raise ValueError("remat applies to the cache-free training pass")
        context = REMAT_POLICIES[remat_policy]

        def super_block(x, layer_params):
            layer_params = gathered(layer_params)
            for pi, kind in enumerate(cfg.block_pattern):
                x, _ = block_apply(layer_params[pi], x, ctx, None, kind,
                                   shared=shared)
            return x

        for layer_params in params["layers"]:
            kw = {"context_fn": context} if context is not None else {}
            x = ckpt.checkpoint(super_block, x, layer_params,
                                use_reentrant=False, **kw)
        return x, None
    for si, shards in enumerate(params["layers"]):
        layer_params = gathered(shards)
        for pi, kind in enumerate(cfg.block_pattern):
            c_in = cache[si][pi] if cache is not None else None
            x, c_out = block_apply(layer_params[pi], x, ctx, c_in, kind,
                                   shared=shared)
            if cache is not None:
                cache[si][pi] = c_out
        del layer_params    # before the next super-block's gather
    return x, cache


def forward(cfg: ArchConfig, dims: ModelDims, params: Params, batch: dict,
            return_cache: bool = False, max_cache_len: int = 0, par=None,
            last_only: bool = False) -> tuple[torch.Tensor, Optional[list]]:
    """Full-sequence forward.  batch: tokens [B, S] (or frames [B, S, d]),
    and cross_ctx [B, Tctx, d] for a VLM.  Returns (logits [B, S, vocab],
    the filled cache or None); ``last_only``: the last position's logits
    alone ([B, 1, vocab])."""
    tp = par.tp_axis if par is not None else None
    B, S = _inputs(cfg, batch).shape[:2]
    sp = _sp_sizes(par, S)
    x, cross = _embed(cfg, params, batch, dims, tp, sp)
    positions = torch.arange(S, device=x.device)[None, :]
    ctx = make_ctx(cfg, dims, "full", positions, cross_ctx=cross,
                   max_cache_len=max_cache_len or S, par=par)
    cache = None
    if return_cache:
        cache = init_cache(cfg, dims, B, max_cache_len or S, x.dtype,
                           x.device, par=par)
        # prefill fills positions [0, S) of the attention caches
        ctx = dataclasses.replace(ctx, cache_index=0)
    x, cache = _run_stack(cfg, params, x, ctx, cache)
    return _logits(cfg, params, x, dims, tp, sp, last_only), cache


def _chunk_loss(xc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed cross-entropy of one sequence chunk and its count of valid
    labels (labels < 0 are masked), with float32 logits."""
    logits = (xc @ w.to(xc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.clamp_min(0)[..., None])[..., 0]
    mask = (lc >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def _chunk_loss_tp(xc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor,
                   tp, vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_chunk_loss`` from the rank's vocab columns
    (``tensor_parallel.cross_entropy_terms``); ``xc`` is the head's
    column-parallel input (``layers._col_in``)."""
    from repro_torch.distributed import tensor_parallel as tpl
    terms = tpl.cross_entropy_terms((xc @ w.to(xc.dtype)).float(), lc, tp,
                                    vocab)
    mask = (lc >= 0).float()
    return (terms * mask).sum(), mask.sum()


def loss_fn(cfg: ArchConfig, dims: ModelDims, params: Params, batch: dict,
            remat: bool = True, loss_chunk: int = 512,
            remat_policy: str = "nothing", par=None) -> torch.Tensor:
    """Cross-entropy with sequence-chunked, recomputed logits (the
    reference's ``loss_fn``).

    batch: tokens [B, S] (or frames [B, S, d] for frontend stubs), labels [B,
    S], and cross_ctx [B, Tctx, d] for a VLM.  The stack runs with ``remat``;
    each chunk of ``loss_chunk`` positions forms its float32 logits inside a
    checkpoint, so the backward recomputes them and at most ``B x loss_chunk x
    vocab`` logits live at a time.  Returns the mean over labels >= 0.

    With ``par`` the batch is the rank's rows and the loss its share of
    the global mean (its rows' sum over the global count of labels), so
    that the shares, and their gradients, sum over the batch axes to the
    global mean's (``tensor_parallel.reduce_grads``).  Under sequence
    parallelism the normed rank blocks are gathered into the whole
    sequence before the chunks, so the loss is the same on every rank.
    """
    tp = par.tp_axis if par is not None else None
    S = _inputs(cfg, batch).shape[1]
    sp = _sp_sizes(par, S)
    x, cross = _embed(cfg, params, batch, dims, tp, sp)
    positions = torch.arange(S, device=x.device)[None, :]
    ctx = make_ctx(cfg, dims, "full", positions, cross_ctx=cross,
                   max_cache_len=S, par=par)
    x, _ = _run_stack(cfg, params, x, ctx, None, remat=remat,
                      remat_policy=remat_policy)
    x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
    if sp:
        from repro_torch.distributed import tensor_parallel as tpl
        x = tpl.gather_seq(x, tp, sp)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    labels = batch["labels"]
    c = min(loss_chunk, S)
    if S % c:
        c = S
    if tp is None:
        sums = [ckpt.checkpoint(_chunk_loss, x[:, i:i + c],
                                labels[:, i:i + c], w, use_reentrant=False)
                for i in range(0, S, c)]
    else:
        # the head's input: gathered above under SP, else a chunk at a
        # time through ``copy_to``
        sums = [ckpt.checkpoint(_chunk_loss_tp, x[:, i:i + c] if sp
                                else _col_in(x[:, i:i + c], tp, None),
                                labels[:, i:i + c], w, tp, dims.vocab_pad,
                                use_reentrant=False)
                for i in range(0, S, c)]
    total = torch.stack([t for t, _ in sums]).sum()
    n = torch.stack([m for _, m in sums]).sum()
    if par is not None and par.dp.size > 1:
        from repro_torch.distributed import collectives
        n = collectives.all_reduce(n.detach().clone(), par.dp.group)
    return total / torch.clamp_min(n, 1.0)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, dims: ModelDims, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None, par=None) -> list:
    """Zeroed caches, one per layer (``[super_block][position]``); with
    ``par``, of the rank's KV heads (``batch`` is the rank's rows)."""
    ctx = make_ctx(cfg, dims, "full", torch.zeros((1,), dtype=torch.long),
                   max_cache_len=max_len, par=par)
    return [[block_cache(cfg, ctx, batch, _dtype(dtype), kind, device)
             for kind in cfg.block_pattern]
            for _ in range(cfg.n_super_blocks)]


def prefill(cfg: ArchConfig, dims: ModelDims, params: Params, batch: dict,
            max_cache_len: int, par=None) -> tuple[torch.Tensor, list]:
    """Run the prompt, return (last-token logits, filled cache); with
    ``par`` only the last position's logits are formed."""
    logits, cache = forward(cfg, dims, params, batch, return_cache=True,
                            max_cache_len=max_cache_len, par=par,
                            last_only=par is not None)
    return logits[:, -1], cache


def decode_step(cfg: ArchConfig, dims: ModelDims, params: Params,
                tokens: torch.Tensor, cache: list, index: int,
                cross_ctx: Optional[torch.Tensor] = None, par=None
                ) -> tuple[torch.Tensor, list]:
    """One autoregressive step.  tokens: [B, 1]; index: the position (a
    Python int).  A VLM's cross blocks read the context's keys and values
    from the cache prefill filled; ``cross_ctx`` is read only by a cache
    without them, as in the reference."""
    tp = par.tp_axis if par is not None else None
    sp = _sp_sizes(par, 1)          # the one position on the first rank
    x, cross = _embed(cfg, params, {"tokens": tokens,
                                    "cross_ctx": cross_ctx}, dims, tp, sp)
    positions = torch.full((tokens.shape[0], 1), index, dtype=torch.long,
                           device=x.device)
    ctx = make_ctx(cfg, dims, "decode", positions, cache_index=index,
                   cross_ctx=cross, par=par)
    x, cache = _run_stack(cfg, params, x, ctx, cache)
    return _logits(cfg, params, x, dims, tp, sp)[:, 0], cache
