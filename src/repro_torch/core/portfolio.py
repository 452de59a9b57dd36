"""Portfolio runner: multi-scenario sweeps over scenario x MCM x metric
(counterpart of ``repro.core.portfolio``).

* ``SweepJob`` is one picklable grid point (pattern name + mesh size + cfg
  overrides, never live objects, so jobs ship cheaply to workers);
  ``TraceJob`` is its online analogue (a ``scenarios.TRACE_PRESETS`` trace
  replayed through ``repro_torch.online.simulate``).  Both carry
  ``device``: ``None`` is the card, resolved inside the process that runs
  the job (it raises there without one); the tests pass ``"cpu"``.
* ``run_portfolio`` executes a job list inline (``processes<=1``) or on a
  ``spawn`` process pool (never ``fork``: CUDA may be initialised in the
  parent).  Each worker owns one CUDA context on the same card.  Before the
  pool starts, when any job runs on the card, the parent builds the
  scheduler kernels once, so the workers load the libraries instead of
  each running ``nvcc`` on the same sources.  Jobs are dispatched grouped
  by CostDB affinity, so identical (scenario/trace, MCM) points share one
  worker's warm caches, with oversized groups cut into fair-share
  sub-chunks.
* ``sweep_grid`` / ``trace_sweep_grid`` build the full cross products.

Results come back as ``SweepResult`` records carrying the full
``ScheduleOutcome`` plus wall time (``TraceResult`` with a ``QoSReport`` for
trace jobs), in the same order as the submitted jobs.  Each record also
carries ``launches``, the ``scar_eval`` and ``scar_search`` launches its
job made, ``pid``, the process that ran it, and ``peak_bytes``, that
process's peak device memory after the job (0 on the CPU).
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

import torch

from repro_torch import obs

from .scenarios import get_scenario, mesh_shape
from .scheduler import ScheduleOutcome, SearchConfig, run_config

__all__ = ["SweepJob", "SweepResult", "TraceJob", "TraceResult",
           "default_processes", "run_portfolio", "sweep_grid",
           "trace_sweep_grid"]

# the kernels a scheduling job may launch
SCHEDULER_KERNELS = ("scar_eval", "scar_search")


@dataclasses.dataclass(frozen=True)
class SweepJob:
    """One (scenario, MCM, metric) pipeline run; picklable by construction."""

    scenario: str
    pattern: str
    rows: int = 3
    cols: int = 3
    n_pe: int = 4096
    standalone: bool = False
    cfg: Optional[SearchConfig] = None
    label: Optional[str] = None          # caller-facing name for the point
    device: Optional[str] = None         # None: the card

    @property
    def name(self) -> str:
        if self.label is not None:
            return self.label
        tag = "standalone_" if self.standalone else ""
        metric = (self.cfg or SearchConfig()).metric
        return (f"{self.scenario}/{tag}{self.pattern}"
                f"_{self.rows}x{self.cols}/{metric}")


@dataclasses.dataclass
class SweepResult:
    job: SweepJob
    outcome: ScheduleOutcome
    wall_s: float
    launches: dict = dataclasses.field(default_factory=dict)
    pid: int = 0
    peak_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class TraceJob:
    """One online-trace replay (preset name -> ``online.simulate``).

    ``mode`` selects the warm incremental re-scheduler or the cold
    from-scratch oracle; ``policy`` the epoch-boundary / preemption /
    MCM-reconfiguration behaviour (``repro_torch.online.OnlinePolicy``, a
    frozen picklable dataclass; ``None`` is the class-blind fluid default).
    """

    trace: str                           # scenarios.TRACE_PRESETS name
    pattern: str
    rows: int = 6
    cols: int = 6
    n_pe: int = 4096
    mode: str = "warm"
    cfg: Optional[SearchConfig] = None
    policy: Optional["object"] = None    # repro_torch.online.OnlinePolicy
    label: Optional[str] = None
    device: Optional[str] = None         # None: the card

    @property
    def name(self) -> str:
        if self.label is not None:
            return self.label
        tag = "" if self.policy is None else f"/{self.policy.boundary}"
        return (f"{self.trace}/{self.pattern}_{self.rows}x{self.cols}"
                f"/{self.mode}{tag}")


@dataclasses.dataclass
class TraceResult:
    """QoS report of one trace replay (the ``SweepResult`` analogue)."""

    job: TraceJob
    report: "object"                     # repro_torch.online.metrics.QoSReport
    wall_s: float
    launches: dict = dataclasses.field(default_factory=dict)
    pid: int = 0
    peak_bytes: int = 0


def _kernel_counts() -> dict:
    from repro_torch.kernels.scar_eval import scar_eval
    from repro_torch.kernels.scar_search import scar_search
    return {"scar_eval": scar_eval.launches,
            "scar_search": scar_search.launches}


def _run_job(job):
    from repro_torch.launch.platform import resolve_device
    device = resolve_device(job.device)
    before = _kernel_counts()
    t0 = time.time()
    with obs.span("job", cat="portfolio", job=job.name):
        if isinstance(job, TraceJob):
            # lazy: repro_torch.online depends on repro_torch.core, so
            # importing it at module load would be circular
            from repro_torch.online.metrics import qos_report
            from repro_torch.online.simulator import simulate
            from .scenarios import get_trace
            sim = simulate(get_trace(job.trace), pattern=job.pattern,
                           rows=job.rows, cols=job.cols, n_pe=job.n_pe,
                           cfg=job.cfg, mode=job.mode, policy=job.policy,
                           device=device)
            res = TraceResult(job=job, report=qos_report(sim),
                              wall_s=time.time() - t0)
        else:
            sc = get_scenario(job.scenario)
            outcome = run_config(sc, job.pattern, rows=job.rows,
                                 cols=job.cols, n_pe=job.n_pe, cfg=job.cfg,
                                 standalone=job.standalone, device=device)
            res = SweepResult(job=job, outcome=outcome,
                              wall_s=time.time() - t0)
    after = _kernel_counts()
    res.launches = {k: after[k] - before[k] for k in after}
    res.pid = os.getpid()
    if device.type == "cuda":
        res.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    return res


def _db_affinity(job) -> tuple:
    """Grouping key of jobs that want the same per-worker warm caches.

    Jobs sharing the key (same scenario-or-trace, package geometry and PE
    budget) reuse one worker's CostDB and path caches.
    """
    src = job.trace if isinstance(job, TraceJob) else job.scenario
    return (src, job.pattern, job.rows, job.cols, job.n_pe)


def _run_batch(batch: list, trace: bool = False) -> tuple:
    """Worker-side: run one affinity group in order (shared warm caches).

    Returns ``(results, telemetry)``.  ``trace=True`` (the parent had
    tracing enabled) turns tracing on in the worker and ships back an
    ``obs.snapshot()`` the parent folds into its own tracer, so one Chrome
    trace shows every process's span stream; the snapshot also carries the
    worker's counters, which the parent adds into its registry.  A pool
    worker may run several batches: its spans and counters are reset first,
    so each snapshot holds its own batch alone (the reference ships the
    worker's whole history with every batch, and the parent merges the
    earlier batches' spans and counters again).
    """
    if trace:
        if not obs.enabled():
            obs.enable()
        obs.reset()
    results = [_run_job(j) for j in batch]
    return results, (obs.snapshot() if trace else None)


def _init_worker(path: list[str]) -> None:
    # spawn workers re-import ``repro_torch`` from scratch; inherit the
    # parent's sys.path so PYTHONPATH-less installs (pip install -e .) and
    # source checkouts (PYTHONPATH=src) both resolve
    for p in reversed(path):
        if p not in sys.path:
            sys.path.insert(0, p)


def default_processes() -> int:
    """Worker count: $SCAR_PORTFOLIO_PROCS, else min(n_cpu, 8)."""
    env = os.environ.get("SCAR_PORTFOLIO_PROCS")
    if env is not None:
        return max(1, int(env))
    return max(1, min(os.cpu_count() or 1, 8))


def _on_card(job) -> bool:
    return job.device is None or torch.device(job.device).type == "cuda"


def run_portfolio(jobs: list,
                  processes: Optional[int] = None) -> list:
    """Run every job; results align with the input order.

    Jobs are ``SweepJob`` or ``TraceJob`` instances, freely mixed.
    ``processes``: None -> ``default_processes()``; <=1 -> inline in this
    process (no pool, easiest to debug); otherwise a ``spawn`` pool.

    Jobs are submitted grouped by ``_db_affinity`` in contiguous chunks, so
    jobs sharing a (scenario/trace, MCM) land on the same worker and hit its
    per-process CostDB/path caches instead of every worker rebuilding the
    same database.
    """
    if processes is None:
        processes = default_processes()
    processes = min(processes, len(jobs)) if jobs else 1
    if processes <= 1:
        return [_run_job(j) for j in jobs]
    import multiprocessing as mp
    if any(_on_card(j) for j in jobs):
        # one nvcc run per source here, not one per cold worker
        from repro_torch.kernels import build
        build.build(list(SCHEDULER_KERNELS))
    groups: dict[tuple, list[int]] = {}
    for i, j in enumerate(jobs):
        groups.setdefault(_db_affinity(j), []).append(i)
    # one pool task per affinity group, but split oversized groups into
    # fair-share sub-chunks so a sweep whose jobs all share one (scenario,
    # MCM) — e.g. a metric or warm/cold mode axis — still parallelises
    # (the caches are per-process, so every sub-chunk re-warms its own)
    cap = max(1, math.ceil(len(jobs) / processes))
    batches = []
    for idxs in groups.values():
        for s in range(0, len(idxs), cap):
            batches.append(idxs[s:s + cap])
    ctx = mp.get_context("spawn")
    tracing = obs.enabled()
    with ProcessPoolExecutor(max_workers=processes, mp_context=ctx,
                             initializer=_init_worker,
                             initargs=(list(sys.path),)) as pool:
        outs = list(pool.map(_run_batch,
                             [[jobs[i] for i in idxs] for idxs in batches],
                             [tracing] * len(batches)))
    results: list = [None] * len(jobs)
    for k, (idxs, (out, snap)) in enumerate(zip(batches, outs)):
        # batches are numbered by submission order, so merged span streams
        # get stable, deterministic process ids across runs
        obs.merge_snapshot(snap, pid=k + 1)
        for i, r in zip(idxs, out):
            results[i] = r
    return results


def _meshes(rows: int, cols: int, meshes: Optional[list]) -> list:
    if meshes is None:
        return [(rows, cols)]
    return [mesh_shape(m) if isinstance(m, str) else tuple(m)
            for m in meshes]


def sweep_grid(scenarios: list[str], patterns: list[str],
               metrics: list[str] = ("edp",), rows: int = 3, cols: int = 3,
               n_pe: Optional[int] = None,
               standalone_patterns: list[str] = (),
               meshes: Optional[list] = None,
               device: Optional[str] = None,
               **cfg_kw) -> list[SweepJob]:
    """Cross product scenario x mesh x pattern x metric -> job list.

    ``n_pe=None`` follows the paper's sizing: 4096 PEs for datacenter
    scenarios, 256 for AR/VR.  ``standalone_patterns`` adds the
    no-pipelining baseline runs for the named patterns.  ``meshes`` adds a
    mesh-size axis: a list of ``(rows, cols)`` pairs or preset names from
    ``scenarios.MESH_PRESETS`` (``"8x8"``, ``"16x16"``, ...); when given it
    overrides the scalar ``rows``/``cols``.  ``device`` goes to every job.
    """
    jobs = []
    for scn in scenarios:
        npe = n_pe if n_pe is not None else (
            4096 if scn.startswith("dc") else 256)
        for mrows, mcols in _meshes(rows, cols, meshes):
            for metric in metrics:
                for pat in standalone_patterns:
                    jobs.append(SweepJob(scenario=scn, pattern=pat,
                                         rows=mrows, cols=mcols, n_pe=npe,
                                         standalone=True,
                                         cfg=SearchConfig(metric=metric,
                                                          **cfg_kw),
                                         device=device))
                for pat in patterns:
                    jobs.append(SweepJob(scenario=scn, pattern=pat,
                                         rows=mrows, cols=mcols, n_pe=npe,
                                         cfg=SearchConfig(metric=metric,
                                                          **cfg_kw),
                                         device=device))
    return jobs


def trace_sweep_grid(traces: list[str], patterns: list[str],
                     rows: int = 6, cols: int = 6, n_pe: int = 4096,
                     modes: tuple[str, ...] = ("warm",),
                     policies: tuple = (None,),
                     meshes: Optional[list] = None,
                     device: Optional[str] = None,
                     **cfg_kw) -> list[TraceJob]:
    """Cross product trace x mesh x pattern x mode x policy -> job list.

    The online analogue of ``sweep_grid``: sweeps dynamic traces (preset
    names from ``scenarios.TRACE_PRESETS``) instead of static scenarios.
    ``policies`` adds an ``OnlinePolicy`` axis (``None`` = the class-blind
    fluid default), e.g. drain-vs-preempt comparisons across meshes.
    """
    jobs = []
    for tr in traces:
        for mrows, mcols in _meshes(rows, cols, meshes):
            for pat in patterns:
                for mode in modes:
                    for pol in policies:
                        jobs.append(TraceJob(trace=tr, pattern=pat,
                                             rows=mrows, cols=mcols,
                                             n_pe=n_pe, mode=mode,
                                             policy=pol,
                                             cfg=SearchConfig(**cfg_kw),
                                             device=device))
    return jobs
