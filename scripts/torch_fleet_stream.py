"""Stream ``bench_fleet_serving``'s open-loop trace through the port's fleet.

The reference's fleet bench (``benchmarks/online_benches.py``) streams a
seeded open-loop churn trace (``seed=5``, ``base_rate=8.0``,
``mean_lifetime=0.7``, tenants bert-base x8 / resnet-50 x8, request rates
log-uniform over (0.25, 8.0) per second) for 50 000 simulated seconds,
about 1.06 million events, through a fleet of four 2x2 ``het_cb`` packages
(256 PE, ``path_cap=4``, ``seg_cap=8``, ``n_splits=2``) twice:
``least_loaded`` routing, then ``round_robin``.  This script runs the same
with the port's ``simulate_fleet`` on a device, never materialising the
trace, and prints per routing the host wall seconds, the event count, the
largest number of events the driver held (``max_buffered_events``; the
reference's bound is 16), re-plans and memo hits, and the two ratios the
bench gates (attainment and attainment-normalised EDP score,
least-loaded over round-robin).

``chip_smoke.py`` phase 9 runs it at a 5 000 s horizon.

Usage: python scripts/torch_fleet_stream.py [--horizon 50000] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

ZOO = (("bert-base", 8), ("resnet-50", 8))
TRACE = dict(seed=5, base_rate=8.0, mean_lifetime=0.7, zoo=ZOO,
             request_rate=(0.25, 8.0))
FLEET = dict(pattern="het_cb", rows=2, cols=2, n_pe=256, n_packages=4,
             autoscale=False)
CONFIG = dict(path_cap=4, seg_cap=8, n_splits=2)


def run(horizon: float, device) -> dict:
    """Both routings over ``horizon`` simulated seconds on ``device``.

    Returns ``{routing: (FleetReport, wall seconds)}``; the wall clock
    closes after the last re-plan's counted device fetch.
    """
    from repro_torch.core import SearchConfig
    from repro_torch.online import FleetConfig, simulate_fleet
    from repro_torch.online.traces import iter_open_loop_churn
    out = {}
    for routing in ("least_loaded", "round_robin"):
        fleet = FleetConfig(routing=routing, cfg=SearchConfig(**CONFIG),
                            **FLEET)
        events = iter_open_loop_churn(horizon=horizon, **TRACE)
        t0 = time.perf_counter()
        rep = simulate_fleet(events, horizon=horizon, fleet=fleet,
                             name=f"fleet_{routing}", device=device)
        out[routing] = (rep, time.perf_counter() - t0)
    return out


def summary(out: dict) -> str:
    lb, rr = out["least_loaded"][0], out["round_robin"][0]
    parts = [f"{r}: wall {w:.3f} s, events {rep.n_events}, "
             f"max_buffered_events {rep.max_buffered_events}, replans "
             f"{rep.n_replans}, memo hits {rep.n_memo_hits}, attainment "
             f"{rep.attainment!r}, score {rep.score!r}, rejected "
             f"{rep.rejected_tenants}"
             for r, (rep, w) in out.items()]
    parts.append(f"att_ratio {lb.attainment / rr.attainment!r}, "
                 f"score_ratio {rr.score / lb.score!r}")
    return "; ".join(parts)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=float, default=50_000.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()
    from repro_torch.launch.platform import resolve_device
    device = resolve_device(args.device)
    out = run(args.horizon, device)
    print(f"horizon {args.horizon} s on {device}: {summary(out)}")
    for rep, _ in out.values():
        if rep.max_buffered_events > 16:
            raise SystemExit(f"max_buffered_events {rep.max_buffered_events}"
                             " > 16")


if __name__ == "__main__":
    main()
