"""Online serving driver: replay a dynamic trace through the port's scheduler
(counterpart of ``examples/online_serve.py``).

Datacenter churn (tenants arriving and departing, incremental re-scheduling
at every epoch boundary) or AR/VR frame cadences (models firing at their
paper Hz with one-period deadlines):

    PYTHONPATH=src python -m repro_torch.launch.online_serve \\
        --trace dc_churn_smoke --rows 3 --cols 3 --n-pe 1024 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.online_serve \\
        --trace xr8_cadence --pattern het_sides --rows 3 --cols 3 --n-pe 256
    PYTHONPATH=src python -m repro_torch.launch.online_serve \\
        --trace dc_churn_slo_smoke --rows 3 --cols 3 --n-pe 1024 \\
        --boundary preempt --reconfig het_sides het_cb --hysteresis 0.1

The reference's flags, plus ``--device`` (where every re-plan runs: the
current CUDA device by default, raising without one; ``cpu`` when asked),
``--eval-backend`` (``SearchConfig.eval_backend``: ``auto`` | ``torch`` |
``torch_ref`` | ``cuda``) and ``--algo`` (``SearchConfig.algo``, e.g.
``beam_jax`` for the fused device search).  ``--mode cold`` runs the
from-scratch oracle instead of the warm incremental path (same plans,
slower); ``--trace-out`` writes a Chrome/Perfetto trace of the run.
"""
from __future__ import annotations

import argparse

from repro_torch import obs
from repro_torch.core import TRACE_PRESETS, SearchConfig, get_trace
from repro_torch.launch.platform import resolve_device
from repro_torch.online import (OnlinePolicy, qos_report, simulate,
                                slo_report)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="dc_churn_smoke",
                    choices=sorted(TRACE_PRESETS))
    ap.add_argument("--pattern", default="het_cross")
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--n-pe", type=int, default=4096)
    ap.add_argument("--mode", default="warm", choices=["warm", "cold"])
    ap.add_argument("--boundary", default="instant",
                    choices=["instant", "drain", "preempt"])
    ap.add_argument("--reconfig", nargs="*", default=(),
                    help="candidate MCM patterns for per-epoch re-selection")
    ap.add_argument("--hysteresis", type=float, default=0.1,
                    help="relative gain a pattern switch must clear")
    ap.add_argument("--path-cap", type=int, default=64)
    ap.add_argument("--seg-cap", type=int, default=128)
    ap.add_argument("--eval-backend", default="auto",
                    choices=["auto", "torch", "torch_ref", "cuda"])
    ap.add_argument("--algo", default="brute",
                    choices=["brute", "beam", "beam_jax", "evolutionary",
                             "anneal"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record telemetry and write a Chrome/Perfetto "
                         "trace JSON to PATH (load via ui.perfetto.dev)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.trace_out:
        obs.enable()
    trace = get_trace(args.trace)
    print(f"trace {trace.name}: kind={trace.kind} horizon={trace.horizon}s "
          f"events={trace.n_events} device={device}")
    policy = OnlinePolicy(
        boundary=args.boundary,
        reconfig_patterns=tuple(args.reconfig),
        reconfig_hysteresis=(args.hysteresis if args.reconfig
                             else float("inf")))
    sim = simulate(trace, pattern=args.pattern, rows=args.rows,
                   cols=args.cols, n_pe=args.n_pe, mode=args.mode,
                   policy=policy, device=device,
                   cfg=SearchConfig(path_cap=args.path_cap,
                                    seg_cap=args.seg_cap,
                                    eval_backend=args.eval_backend,
                                    algo=args.algo))
    if trace.kind == "churn":
        for e in sim.epochs:
            mix = ",".join(f"{name}" for _, name, _ in e.tenants) or "<idle>"
            tag = "memo" if e.memo_hit else f"{e.replan_wall_s * 1e3:.1f}ms"
            extra = ""
            if e.switched:
                extra += f" RECONFIG->{e.pattern}"
            if e.n_preempted:
                extra += f" preempted={e.n_preempted}"
            print(f"  [{e.t_start:7.2f}s -> {e.t_end:7.2f}s] "
                  f"{len(e.tenants)} tenants ({mix}) "
                  f"iters={e.iterations:7.1f} replan={tag}{extra}")
    rep = qos_report(sim)
    print(f"\nQoS ({rep.mode}): epochs={rep.n_epochs} "
          f"replans={rep.n_replans} memo_hits={rep.n_memo_hits} "
          f"replan_wall={rep.replan_wall_s:.2f}s "
          f"overhead={rep.overhead_ratio:.2%}")
    print(f"energy={rep.total_energy:.4g}J busy={rep.busy_s:.2f}s "
          f"aggregate_edp={rep.aggregate_edp:.4g}")
    for m in rep.per_model:
        miss = "" if m.miss_rate is None else f"  miss_rate={m.miss_rate:.2%}"
        print(f"  {m.model:12s} n={m.n_samples:8.1f} "
              f"p50={m.p50_latency * 1e3:7.2f}ms "
              f"p99={m.p99_latency * 1e3:7.2f}ms{miss}")
    srep = slo_report(sim)
    if len(srep.per_class) > 1 or sim.n_preemptions or sim.n_switches:
        print(f"\nSLO view: weighted_miss={srep.weighted_miss_rate:.2%} "
              f"attainment={srep.slo_attainment:.2%} "
              f"edp/iter={srep.edp_per_iteration:.4g} "
              f"preemptions={srep.n_preemptions} "
              f"reconfigs={srep.n_switches}")
        for c in srep.per_class:
            print(f"  {c.slo:17s} w={c.weight:4.2f} n={c.n_samples:8.1f} "
                  f"p50={c.p50_latency * 1e3:7.2f}ms "
                  f"p99={c.p99_latency * 1e3:7.2f}ms "
                  f"miss_rate={c.miss_rate:.2%}")

    if args.trace_out:
        obs.chrome_trace(args.trace_out)
        print(f"\ntelemetry: wrote {args.trace_out} "
              f"(open with https://ui.perfetto.dev)")
        print(obs.format_summary())
    return {"sim": sim, "qos": rep, "slo": srep}


if __name__ == "__main__":
    main()
