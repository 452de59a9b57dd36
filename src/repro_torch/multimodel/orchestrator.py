"""The scheduler as the placement engine for multi-model serving
(counterpart of ``repro.multimodel.orchestrator``).

The reference plans several LMs onto a TPU pod modelled as an MCM (chips =
chiplets, ICI = NoP, host ingest = off-chip), its two chiplet classes the
two execution templates a chip slot may take: tp-major (weight-stationary
analogue, NVDLA) and batch-major (output-stationary analogue, ShiDianNao).
Then it builds a sub-mesh per placement from exactly the chips it was given
and lowers each model's prefill there.

Pipeline, as in the reference:
  1. each requested model's ``ArchConfig`` -> the scheduler's layer graph;
  2. ``schedule`` against the pod-as-MCM cost model (``TPU_PKG``,
     ``TPU_NPE``, ``tpu_chip_classes``: the reference's pod model, copied
     bit for bit so that plans match; they are the cost model's inputs,
     not this card's numbers);
  3. ``realize``: each placement of a window gets the ranks at its
     chips' coordinates of ``mesh`` (the pod's rows x columns over the
     launched ranks) as a ``(data, model)`` sub-mesh, tensor parallel over
     all of them where the arch is ``tp``-style and its heads divide, else
     data parallel, with seeded weights (or weights carried across from the
     JAX package as numpy trees), and its prefill function runs there.
     Without ``mesh`` every placement runs on the one device at tp = 1.
     A tensor-parallel sub-mesh is ``(1, n)``, so an FSDP arch placed
     there has a ``data`` axis of 1, where FSDP is tensor parallelism; on
     a data-parallel ``(n, 1)`` one it gathers each layer's weights over
     ``data`` (``distributed.tensor_parallel.FSDP``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.chiplet import (MCM, ChipletClass, Dataflow,
                                      PackageParams, make_mcm)
from repro_torch.core.scheduler import SearchConfig, schedule
from repro_torch.core.workload import Model, Scenario, transformer_layers
from repro_torch.launch.platform import resolve_device
from repro_torch.models import ModelDims, get_arch, init_params
from repro_torch.models.config import ArchConfig

__all__ = ["TPU_NPE", "TPU_PKG", "ModelPlacement", "PodPlan", "ServeRequest",
           "arch_to_workload", "make_pod_mcm", "placement_tp", "plan",
           "realize", "tpu_chip_classes"]

# The reference's v5e-flavoured package constants for the pod-as-MCM cost
# model (inputs of the cost model, not measurements of this card).
TPU_PKG = PackageParams(
    dram_lat_s=2e-6,           # host/DCN ingest latency
    dram_e_pj_per_bit=20.0,
    dram_bw=100e9,             # host ingest bandwidth
    nop_hop_lat_s=1e-6,        # ICI hop
    nop_e_pj_per_bit=5.0,
    nop_bw=50e9,               # ICI link bandwidth
    clock_hz=750e6,
    mac_e_pj=0.13,
    sram_e_pj_per_bit=0.08,
    l2_bytes_per_cycle=1092.0,  # 819 GB/s HBM @ 750 MHz
    contention_delta=0.05,
)

# n_pe * clock = peak MACs/s = 197 TFLOP/s / 2 (the reference's pod model)
TPU_NPE = 131072


def tpu_chip_classes() -> tuple[ChipletClass, ChipletClass]:
    """TP-major (WS analogue) and batch-major (OS analogue) templates."""
    def mk(df):
        return ChipletClass(df, n_pe=TPU_NPE, bw_noc=819e9,
                            bw_mem=819e9, sz_mem=16 * 2**30)
    return mk(Dataflow.NVDLA), mk(Dataflow.SHIDIANNAO)


def make_pod_mcm(rows: int = 16, cols: int = 16,
                 pattern: str = "het_sides") -> MCM:
    base = make_mcm(pattern, rows=rows, cols=cols)
    return MCM(name=f"tpu_pod_{pattern}_{rows}x{cols}", rows=rows, cols=cols,
               class_map=base.class_map, classes=tpu_chip_classes(),
               pkg=TPU_PKG)


def arch_to_workload(cfg: ArchConfig, batch: int, seq: int) -> Model:
    """ArchConfig -> the scheduler's layer graph (transformer-equivalent
    accounting for ssm/lstm blocks: their projections are GEMMs of the same
    shapes)."""
    d_ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
    if cfg.moe is not None:
        d_ff = cfg.moe.top_k * cfg.moe.expert_d_ff + (
            cfg.moe.n_shared_experts * cfg.moe.expert_d_ff)
        if cfg.moe.dense_residual:
            d_ff += cfg.moe.dense_d_ff
    layers = transformer_layers(
        cfg.name, n_blocks=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads, d_ff=max(d_ff, cfg.d_model),
        seq=seq, batch=batch, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd)
    return Model(cfg.name, tuple(layers), batch)


@dataclasses.dataclass
class ServeRequest:
    arch: str
    batch: int
    seq: int


@dataclasses.dataclass
class ModelPlacement:
    arch: str
    window: int
    chips: tuple[int, ...]       # chip ids, row-major over the pod grid
    template: str                # tp-major | batch-major | mixed


@dataclasses.dataclass
class PodPlan:
    outcome: object              # core ScheduleOutcome
    placements: list[ModelPlacement]
    rows: int
    cols: int


def plan(requests: list[ServeRequest], rows: int = 16, cols: int = 16,
         pattern: str = "het_sides", metric: str = "edp",
         cfg: Optional[SearchConfig] = None, *,
         device: Optional[torch.device | str] = None) -> PodPlan:
    """Run the scheduler over the pod and return chip placements; the
    scheduler's batched math runs on ``device`` (None: the card)."""
    mcm = make_pod_mcm(rows, cols, pattern)
    models = tuple(arch_to_workload(get_arch(r.arch), r.batch, r.seq)
                   for r in requests)
    sc = Scenario("pod_serving", models)
    out = schedule(sc, mcm, cfg or SearchConfig(metric=metric),
                   device=device)
    placements = []
    for w, wr in enumerate(out.windows):
        for p in wr.plan.plans:
            classes = {mcm.class_of(c).dataflow for c in p.chiplets}
            template = ("tp-major" if classes == {Dataflow.NVDLA} else
                        "batch-major" if classes == {Dataflow.SHIDIANNAO}
                        else "mixed")
            placements.append(ModelPlacement(
                arch=requests[p.model_idx].arch, window=w,
                chips=p.chiplets, template=template))
    return PodPlan(outcome=out, placements=placements, rows=rows, cols=cols)


def placement_tp(cfg: ArchConfig, n: int) -> int:
    """The reference's TP degree of a placement on n chips: n where the
    arch is ``tp``-style and n divides its heads, else 1."""
    from repro_torch.distributed.sharding import style_for
    return n if (cfg.n_heads % n == 0 and style_for(cfg) == "tp") else 1


def realize(plan_: PodPlan, requests: list[ServeRequest],
            device: Optional[torch.device | str] = None, window: int = 0,
            reduced_archs: bool = False, *,
            weights: Optional[dict] = None,
            dtype: Optional[str] = None, mesh=None) -> dict:
    """Build each model placed in ``window`` on ``device`` (None: the
    card) at tp = 1 and return ``{arch: (device, prefill_fn)}``.

    With ``mesh`` (a ``launch.mesh.MeshSpec`` of the launched ranks whose
    ``devices`` lay out as the pod's rows x columns; every rank calls):
    each placement on n chips gets the ranks at its chips as a ``(data,
    model)`` sub-mesh, ``(1, n)`` at ``tp = placement_tp(cfg, n)`` = n,
    else ``(n, 1)`` with the batch ``max(batch, n)``, as the reference
    builds it; a numpy tree in ``weights`` must be at
    ``ModelDims.create(cfg, tp)``'s padded shapes.  Returns
    ``{arch: (sub-mesh MeshSpec, prefill_fn)}`` for this rank's placements;
    ``prefill_fn`` gives the whole batch's last-token logits on every rank
    of the placement.

    Models are at full width unless ``reduced_archs`` (the reference's
    ``models.testing.reduced``).  Weights are drawn on the device from a
    generator seeded with 0, or, for an arch in ``weights``,
    carried across from a numpy tree in the JAX package's layout
    (``models.convert.params_from_numpy``).  ``dtype`` (``"float32"``,
    ``"bfloat16"``) replaces the configs' own (bf16; the parity tests
    compare float32 prefills).
    ``prefill_fn(batch=None)`` runs the prefill of the request's batch and
    sequence (``None``: the seeded ``synth_batch``) and returns (last-token
    logits, cache).
    """
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.models.testing import reduced, synth_batch

    if mesh is not None:
        from repro_torch.launch.mesh import rank_device
        dev = rank_device(device)
    else:
        dev = resolve_device(device)
    out = {}
    for pl_ in plan_.placements:
        if pl_.window != window:
            continue
        req = next(r for r in requests if r.arch == pl_.arch)
        cfg = get_arch(pl_.arch)
        if reduced_archs:
            cfg = reduced(cfg)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        par, where, batch_size = None, dev, req.batch
        if mesh is not None:
            par, batch_size = _sub_mesh(cfg, plan_, pl_, mesh, req.batch)
            if not par.member:
                continue
            where = par.mesh.spec
        dims = ModelDims.create(cfg, par.tp.size if par else 1)
        shard = None if par is None else (
            lambda path, tree, _c=cfg, _p=par: _tp().shard_params(
                _c, tree, _p, path))
        with torch.inference_mode():
            if weights is not None and pl_.arch in weights:
                params = params_from_numpy(cfg, weights[pl_.arch],
                                           device=dev, dtype=cfg.dtype)
                if shard is not None:
                    params = shard((), params)
            else:
                params = init_params(cfg, dims, generator=torch.Generator(
                    device=dev).manual_seed(0), dtype=cfg.dtype,
                    shard=shard)
        step = make_prefill_step(cfg, dims, max_cache_len=req.seq, par=par)

        def prefill_fn(batch=None, _cfg=cfg, _req=req, _params=params,
                       _step=step, _b=batch_size):
            if batch is None:
                batch = synth_batch(_cfg, batch=_b, seq=_req.seq,
                                    seed=0, device=dev)
                batch.pop("labels", None)
            with torch.inference_mode():
                return _step(_params, batch)

        out[pl_.arch] = (where, prefill_fn)
    return out


def _tp():
    from repro_torch.distributed import tensor_parallel
    return tensor_parallel


def _sub_mesh(cfg: ArchConfig, plan_: PodPlan, pl_: ModelPlacement, mesh,
              batch: int):
    """The placement's ``Parallel`` (built on every rank) and its batch."""
    from repro_torch.launch.mesh import RankMesh, make_mesh
    grid = mesh.devices.reshape(plan_.rows, plan_.cols)
    ranks = tuple(int(grid[divmod(c, plan_.cols)]) for c in pl_.chips)
    n = len(ranks)
    tp = placement_tp(cfg, n)
    if tp == 1:
        batch = max(batch, n)
    spec = make_mesh((n // tp, tp), ("data", "model"), ranks)
    return _tp().make_parallel(cfg, RankMesh(spec), batch), batch
