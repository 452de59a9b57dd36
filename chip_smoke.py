#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain torch version on the card, then drives the scheduler end
to end, with the host beam (``algo="beam"``) and with the fused device
search (``algo="beam_jax"``), and holds its plans and float64 metrics
against the golden file the JAX reference wrote
(``tests/fixtures/torch_port_golden.json``).  It imports neither JAX nor
the reference package.  Phases, each printed as it runs:

1. card: ``nvidia-smi`` name, power limit and SM clock, library versions,
   kernel builds (one ``nvcc`` per source, all at once)
2. kernels: ``scar_eval`` against ``scar_eval_plain`` over a sweep of
   shapes and on the packed inputs of the largest 16x16 production batch;
   ``scar_search`` against ``conflict_counts_plain`` over a sweep and on
   the screen inputs of the 16x16 fused run's largest beam stage; CUDA-event
   and profiler times and the card's bound for the same work
3. paper package: the ten Table II scenarios on the 6x6 ``het_cross`` MCM,
   under ``eval_backend="auto"`` (as the golden file was made), with every
   batch on the kernel (``eval_backend="cuda"``), and with
   ``algo="beam_jax"`` (one fetch per window)
4. production size: ``dc4_lms_seg_image`` on the 16x16 ``het_cb`` pod at
   ``path_cap=1024``, with ``algo="beam"`` under ``auto`` and with
   ``algo="beam_jax"``; each run counts its kernel launches from zero.  One
   window's fused program runs under ``torch.cuda.set_sync_debug_mode
   ("error")``, so a hidden sync raises; traced span breakdowns of both
   paths and the fused run's device time from ``torch.profiler``
5. summary: one JSON line of per-kernel numbers
6. last line: ``{"ok": true, "device": {...}}``

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a CUDA device.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_golden.json"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
KERNEL_RTOL = 1e-5              # of max |plain|; both float32

SWEEP_B = (1, 127, 128, 7872, 65536)
SWEEP_LW = (1, 11, 56, 80, 300)
SWEEP_S = (1, 6, 8)
SWEEP_C = (2, 3)
SEARCH_BM = (1, 48, 64)
SEARCH_N = (1, 255, 2048, 2049, 65536)
SEARCH_W = (2, 8)
POPC_PER_CLOCK_PER_SM = 16      # 32-bit population count, compute 9.0
H100_SMS = 132
PROD_KEY = "het_cb_16x16_cap1024/dc4_lms_seg_image"
# Scenarios whose all-float32 run (eval_backend="cuda") breaks an exact tie
# in the beam the other way: an equal-metric plan (ROADMAP.md, "Faults found
# in the port"; tests/test_torch_schedule.py pins the same on the CPU).
F32_TIE_SCENARIOS = {"dc5_lms_seg_image_wide"}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 25) -> float:
    """Median milliseconds of one ``fn()`` call between two CUDA events.

    The events bracket the call as a caller makes it, so the time includes
    the host's launch overhead whenever that exceeds the device work.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiled_device_ms(fn, kernel_name: str, reps: int = 25):
    """Mean device time (ms) of the named kernel per ``fn()`` call, from
    ``torch.profiler``; None when the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel_name in ev.key and ev.count:
            total_us = getattr(ev, "device_time_total",
                               getattr(ev, "cuda_time_total", 0.0))
            return total_us / ev.count / 1e3
    return None


def random_compact(B, Lw, S, C, seed, dev):
    """Seeded compact kernel inputs on the card, with padding rows."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def logn(shape, mu, sigma):
        return torch.exp(mu + sigma * torch.randn(shape, generator=g,
                                                  device=dev))

    kmax = min(S, Lw)
    n_segs = torch.randint(0, kmax + 1, (B,), generator=g, device=dev)
    n_segs[0] = 1
    # k - 1 distinct sorted cut points in [0, Lw - 2], then the window end
    width = max(1, Lw - 1)
    keys = torch.rand((B, width), generator=g, device=dev)
    idx = keys.argsort(dim=1)[:, :max(0, kmax - 1)]
    j = torch.arange(S, device=dev)
    big = torch.full((B, S), Lw, dtype=torch.long, device=dev)
    big[:, :idx.shape[1]] = torch.where(
        j[None, :idx.shape[1]] < (n_segs - 1)[:, None], idx, Lw)
    cuts = big.sort(dim=1).values
    last = torch.where(j[None, :] < (n_segs - 1)[:, None], cuts,
                       torch.where(j[None, :] == (n_segs - 1)[:, None],
                                   Lw - 1, -1))
    return (logn((Lw, C), -9.0, 2.0).float(), logn((Lw, C), -5.0, 2.0).float(),
            torch.randint(0, C, (B, S), generator=g, device=dev,
                          dtype=torch.int32),
            last.to(torch.int32), n_segs.to(torch.int32),
            logn((B, S), -10.0, 1.0).float(), logn((B, S), -6.0, 1.0).float())


def compare(args, pipelined, kernel, plain):
    out = kernel(*args, pipelined)
    ref = plain(*args, pipelined)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "kernel output not finite")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(err <= KERNEL_RTOL * scale,
          f"kernel disagrees: max |kernel - plain| = {err} > "
          f"{KERNEL_RTOL} * {scale}")
    return err


def bound_ms(args) -> tuple[float, str]:
    """Least time the card needs: inputs read once, output written once,
    against the adds/compares the function does (float32)."""
    lat_tab, e_tab, seg_cls, last, n_segs, comm_lat, comm_e = args
    B, S = seg_cls.shape
    nbytes = sum(t.numel() * t.element_size() for t in args) + B * 2 * 4
    live = int(n_segs.clamp(max=S).sum().item())
    # per live segment: 2 differences, 2 comm adds, 2 accumulations, 1 max;
    # plus the 2 * Lw * C prefix additions
    flops = 7 * live + 2 * lat_tab.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_bound_ms(beam, cand, sm_clock_hz) -> tuple[float, str]:
    """``scar_search``'s least time: its words read once and counts
    written once, against its ``Bm * N * W`` popcounts at 16 per clock per
    SM on 132 SMs at the card's maximum SM clock."""
    bm, w = beam.shape
    n = cand.shape[0]
    t_bytes = 4 * (bm * w + n * w + bm * n) / HBM_BYTES_PER_S * 1e3
    t_ops = bm * n * w / (POPC_PER_CLOCK_PER_SM * H100_SMS
                          * sm_clock_hz) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_words(rows, w, seed, dev):
    """Seeded int32-held uint32 words on the card: dense, sparse (ANDs of
    three draws), and an all-zero and an all-ones row."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw():
        return torch.randint(-2 ** 31, 2 ** 31, (rows, w), generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
    dense = draw()
    sparse = dense & draw() & draw()
    pick = torch.rand((rows, 1), generator=g, device=dev) < 0.5
    out = torch.where(pick, dense, sparse)
    out[0] = 0
    if rows > 1:
        out[1] = -1
    return out.contiguous()


def largest_screen(case, dev):
    """The ``(beam words, candidate words)`` of the largest beam stage
    (by ``Bm * N``) of the fused 16x16 run, recorded from the stage's
    ``conflict_counts`` call in a run of its own."""
    from repro_torch.core import device_search, get_scenario, make_mcm
    from repro_torch.core import schedule
    from repro_torch.core.scheduler import SearchConfig
    seen = {}
    real = device_search.conflict_counts

    def record(beam, cand, *, use_kernel):
        if beam.shape[0] * cand.shape[0] > seen.get("size", -1):
            seen.update(size=beam.shape[0] * cand.shape[0],
                        args=(beam.clone(), cand.clone()))
        return real(beam, cand, use_kernel=use_kernel)

    device_search.conflict_counts = record
    try:
        schedule(get_scenario(case["scenario"]),
                 make_mcm(case["pattern"], rows=case["rows"],
                          cols=case["cols"], n_pe=case["n_pe"]),
                 SearchConfig(path_cap=case["path_cap"], algo="beam_jax"),
                 device=dev)
    finally:
        device_search.conflict_counts = real
    return seen["args"]


def span_totals(run) -> str:
    """Seconds by span name of one traced ``run()`` (nested spans
    overlap)."""
    from repro_torch import obs
    obs.enable()
    try:
        run()
        totals: dict[str, float] = {}
        for ev in obs.tracer().events:
            if "dur" in ev:
                totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"]
    finally:
        obs.disable()
    return ", ".join(f"{k} {v:.4f}" for k, v in
                     sorted(totals.items(), key=lambda kv: -kv[1]))


def device_time_of(run) -> tuple[float, float, list]:
    """``(wall s, device-busy s, top kernels)`` of one ``run()`` under
    ``torch.profiler``: the sum of the device's own events (kernels,
    copies, memsets) and the five largest by total time.  The profiler
    slows the host, so the wall time here is longer than unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:    # host-side operator rows
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        rows.append((ev.key[:60], ev.count, dev_us / 1e6))
    rows.sort(key=lambda r: -r[2])
    return wall, sum(r[2] for r in rows), rows[:5]


def fused_window_without_sync(case, dev) -> None:
    """Window 0 of the 16x16 fused run: upload its inputs, then run its
    device program with synchronising CUDA calls turned into errors."""
    from repro_torch.core import device_search, get_scenario, make_mcm
    from repro_torch.core.engine import DeviceBeamEngine
    from repro_torch.core.reconfig import greedy_pack
    from repro_torch.core.scheduler import SearchConfig, get_cost_db
    from repro_torch.launch import platform
    cfg = SearchConfig(path_cap=case["path_cap"], algo="beam_jax")
    mcm = make_mcm(case["pattern"], rows=case["rows"], cols=case["cols"],
                   n_pe=case["n_pe"])
    db = get_cost_db(get_scenario(case["scenario"]), mcm)
    ranges = greedy_pack(db, mcm.class_counts(), cfg.n_splits).ranges[0]
    engine = DeviceBeamEngine(beam=cfg.beam, device=dev)
    inputs, built, n_pad = engine.window_inputs(db, mcm, cfg, ranges, {})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = device_search.fused_program(
            inputs, beam=cfg.beam, keep=cfg.keep_per_model,
            metric=cfg.metric, max_exp=engine.max_expansions, n_pad=n_pad,
            use_kernel=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fails = platform.device_fetch(out[-1])[0]
    check(not fails.any(), "the window program found no disjoint placement")
    print(f"window 0 ({len(built)} models, n_pad {n_pad}): fused program "
          "ran under set_sync_debug_mode('error') with no sync")


def golden_record(outcome) -> dict:
    return {
        "plans": [[[p.model_idx, list(p.seg_ends), list(p.chiplets)]
                   for p in wr.plan.plans] for wr in outcome.windows],
        "latency": repr(outcome.result.latency),
        "energy": repr(outcome.result.energy),
        "edp": repr(outcome.result.edp),
    }


def run_case(case, cfg, dev, *, exact_plans: bool = True):
    """Schedule one golden case on the card and hold it against the file.

    The float64 latency, energy and EDP must equal the golden ``repr``
    strings; the plans must too unless ``exact_plans`` is False, for a run
    known to break an exact tie the other way (then any difference is
    printed).
    """
    from repro_torch.core import get_scenario, make_mcm, schedule
    mcm = make_mcm(case["pattern"], rows=case["rows"], cols=case["cols"],
                   n_pe=case["n_pe"])
    t0 = time.perf_counter()
    out = schedule(get_scenario(case["scenario"]), mcm, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for v in (out.result.latency, out.result.energy, out.edp):
        check(np.isfinite(v) and v > 0, f"non-finite metric {v}")
    rec = golden_record(out)
    for w, (a, b) in enumerate(zip(rec["plans"], case["plans"])):
        if a != b:
            print(f"  window {w}: port {a}\n  window {w}: golden {b}")
    keys = ("latency", "energy", "edp") + (("plans",) if exact_plans else ())
    check(all(rec[k] == case[k] for k in keys) and
          len(rec["plans"]) == len(case["plans"]),
          f"{case['scenario']} on {case['pattern']} {case['rows']}x"
          f"{case['cols']} ({cfg.eval_backend}): port edp {rec['edp']} "
          f"latency {rec['latency']}, golden edp {case['edp']} latency "
          f"{case['latency']}")
    return out, wall


def production_batches(case, dev):
    """Packed inputs of every scoring batch of the golden 16x16 run.

    Windows are rebuilt as the schedule builds them, with each window's
    locality anchors taken from the golden plans of the windows before it.
    """
    from repro_torch.core import get_scenario, make_mcm
    from repro_torch.core.provision import provision
    from repro_torch.core.reconfig import greedy_pack
    from repro_torch.core.sched import assemble_candidates
    from repro_torch.core.scheduler import SearchConfig, get_cost_db
    from repro_torch.core.segmentation import top_k_segmentations
    from repro_torch.kernels.scar_eval import pack_candidates
    cfg = SearchConfig(path_cap=case["path_cap"])
    mcm = make_mcm(case["pattern"], rows=case["rows"], cols=case["cols"],
                   n_pe=case["n_pe"])
    db = get_cost_db(get_scenario(case["scenario"]), mcm)
    wa = greedy_pack(db, mcm.class_counts(), cfg.n_splits)
    anchors: dict[int, int] = {}
    batches = []
    for w, ranges in enumerate(wa.ranges):
        alloc = provision(db, mcm.class_counts(), ranges, mcm.n_chiplets,
                          metric=cfg.metric,
                          max_nodes_per_model=cfg.max_nodes_per_model)
        for mi, (s, e) in sorted(ranges.items()):
            segs = top_k_segmentations(db, mcm, s, e, alloc[mi],
                                       k=cfg.seg_top_k, cap=cfg.seg_cap,
                                       metric=cfg.metric)
            cand, _, _ = assemble_candidates(
                mcm, mi, (s, e), segs, anchors.get(mi),
                path_cap=cfg.path_cap, frontier_cap=cfg.frontier_cap)
            batches.append(pack_candidates(db, mcm, cand, len(ranges),
                                           prev_end=anchors.get(mi),
                                           device=dev))
        for mi, _, chips in case["plans"][w]:
            anchors[mi] = chips[-1]
    return batches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to measure")
    from repro_torch.kernels import build
    from repro_torch.kernels.scar_eval import scar_eval, scar_eval_plain
    from repro_torch.kernels.scar_search import (conflict_counts_plain,
                                                 scar_search)
    from repro_torch.core import SearchConfig
    from repro_torch.core.scheduler import clear_caches
    from repro_torch.launch import platform

    dev = torch.device("cuda", 0)
    phase("1 card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sm_clock_hz = float(clock) * 1e6
    print(f"max SM clock {clock} MHz")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  numpy {np.__version__}  "
          f"device {torch.cuda.get_device_name(0)}")
    check(hasattr(np, "bitwise_count"),
          "numpy lacks bitwise_count (engine.batched_fitness needs >= 2.0)")
    t0 = time.perf_counter()
    build.build(["scar_eval", "scar_search"])
    print(f"kernel build {time.perf_counter() - t0:.3f} s "
          f"(nvcc: {build.build_seconds})")
    for name, log in build.build_log.items():
        for line in log.strip().splitlines():
            print(f"  [{name}] {line}")

    phase("2a kernel: scar_eval vs scar_eval_plain")
    worst = 0.0
    n_cases = 0
    for B in SWEEP_B:
        for Lw in SWEEP_LW:
            for S in SWEEP_S:
                for C in SWEEP_C:
                    args = random_compact(B, Lw, S, C, n_cases, dev)
                    for pipelined in (True, False):
                        worst = max(worst, compare(args, pipelined,
                                                   scar_eval,
                                                   scar_eval_plain))
                        n_cases += 1
    print(f"sweep: {n_cases} cases, max |kernel - plain| = {worst!r}")
    golden = json.loads(GOLDEN.read_text())["cases"]
    batches = production_batches(golden[PROD_KEY], dev)
    big = max(batches, key=lambda p: p.seg_cls.shape[0] * p.lat_tab.shape[0])
    real_err = compare(big[:7], big.pipelined, scar_eval, scar_eval_plain)
    worst = max(worst, real_err)
    B, S = big.seg_cls.shape
    Lw, C = big.lat_tab.shape
    k_ms = cuda_ms(lambda: scar_eval(*big))
    p_ms = cuda_ms(lambda: scar_eval_plain(*big))
    dev_ms = profiled_device_ms(lambda: scar_eval(*big), "scar_eval_kernel")
    b_ms, b_by = bound_ms(big[:7])
    print(f"largest 16x16 batch B={B} Lw={Lw} S={S} C={C}: "
          f"max |kernel - plain| = {real_err!r}; per call (CUDA events, "
          f"median of 25): kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms; "
          f"kernel device time (profiler) {dev_ms!r} ms; bound "
          f"{b_ms:.6f} ms ({b_by}) on {smi}")
    for p in batches:
        ms = cuda_ms(lambda: scar_eval(*p), reps=20)
        print(f"  batch B={p.seg_cls.shape[0]} Lw={p.lat_tab.shape[0]} "
              f"S={p.seg_cls.shape[1]}: kernel {ms:.6f} ms, bound "
              f"{bound_ms(p[:7])[0]:.6f} ms")

    phase("2b kernel: scar_search vs conflict_counts_plain")
    n_cases = 0
    for bm in SEARCH_BM:
        for n in SEARCH_N:
            for w in SEARCH_W:
                beam = random_words(bm, w, 2 * n_cases, dev)
                cand = random_words(n, w, 2 * n_cases + 1, dev)
                out = scar_search(beam, cand)
                plain = conflict_counts_plain(beam, cand)
                torch.cuda.synchronize()
                check(torch.equal(out, plain),
                      f"scar_search disagrees at Bm={bm} N={n} W={w}")
                n_cases += 1
    print(f"sweep: {n_cases} cases (Bm {SEARCH_BM}, N {SEARCH_N}, W "
          f"{SEARCH_W}), kernel == plain on all")
    s_beam, s_cand = largest_screen(golden[PROD_KEY], dev)
    s_out = scar_search(s_beam, s_cand)
    s_plain = conflict_counts_plain(s_beam, s_cand)
    torch.cuda.synchronize()
    check(torch.equal(s_out, s_plain),
          "scar_search disagrees on the 16x16 screen inputs")
    s_err = float((s_out - s_plain).abs().max().item())
    s_ms = cuda_ms(lambda: scar_search(s_beam, s_cand))
    s_p_ms = cuda_ms(lambda: conflict_counts_plain(s_beam, s_cand))
    s_dev_ms = profiled_device_ms(lambda: scar_search(s_beam, s_cand),
                                  "scar_search")
    s_b_ms, s_b_by = search_bound_ms(s_beam, s_cand, sm_clock_hz)
    print(f"largest 16x16 beam stage Bm={s_beam.shape[0]} "
          f"N={s_cand.shape[0]} W={s_beam.shape[1]}: kernel == plain; per "
          f"call (CUDA events, median of 25): kernel {s_ms:.6f} ms, plain "
          f"{s_p_ms:.6f} ms; kernel device time (profiler) {s_dev_ms!r} ms;"
          f" bound {s_b_ms:.6f} ms ({s_b_by}) on {smi}; torch has "
          f"bitwise_count: {hasattr(torch, 'bitwise_count')}")

    phase("3 paper package: ten scenarios, 6x6 het_cross, auto, cuda, "
          "beam_jax")
    for backend, algo in (("auto", "beam"), ("cuda", "beam"),
                          ("auto", "beam_jax")):
        clear_caches()
        scar_eval.launches = 0
        scar_search.launches = 0
        for key, case in golden.items():
            if not key.startswith("het_cross_6x6/"):
                continue
            exact = backend == "auto" or \
                case["scenario"] not in F32_TIE_SCENARIOS
            platform.reset_sync_count()
            out, wall = run_case(case, SearchConfig(
                path_cap=case["path_cap"], eval_backend=backend, algo=algo),
                dev, exact_plans=exact)
            syncs = platform.sync_count()
            if algo == "beam_jax":
                check(syncs == len(out.windows),
                      f"{case['scenario']}: {syncs} fetches for "
                      f"{len(out.windows)} windows")
            print(f"  {algo} {backend} {case['scenario']}: edp {out.edp!r} "
                  f"= golden{'' if exact else ' (plans: known float32 tie)'}"
                  f", {wall:.3f} s, {syncs} fetches")
        check(scar_eval.launches > 0, f"the {algo} {backend} runs launched "
              "no scar_eval kernel")
        if algo == "beam_jax":
            check(scar_search.launches > 0, "the beam_jax runs launched no "
                  "scar_search kernel")
        print(f"{algo} {backend}: scar_eval launches {scar_eval.launches}, "
              f"scar_search launches {scar_search.launches}")

    phase("4 production size: dc4, 16x16 het_cb, path_cap=1024, beam and "
          "beam_jax")
    case = golden[PROD_KEY]
    launches = {}
    walls = {}
    for algo in ("beam", "beam_jax"):
        cfg = SearchConfig(path_cap=case["path_cap"], algo=algo)
        clear_caches()
        platform.reset_sync_count()
        scar_eval.launches = 0
        scar_search.launches = 0
        out, walls[algo] = run_case(case, cfg, dev)
        launches[algo] = {"scar_eval": scar_eval.launches,
                          "scar_search": scar_search.launches}
        syncs = platform.sync_count()
        print(f"{algo}: edp {out.edp!r} = golden; wall {walls[algo]:.3f} s;"
              f" launches {launches[algo]}; device_fetch syncs {syncs}")
        if algo == "beam":
            check(launches[algo]["scar_eval"] >= 10,
                  f"only {launches[algo]['scar_eval']} scar_eval launches "
                  "on the 16x16 beam run (want >= 10, the batches above the "
                  "auto threshold)")
        else:
            check(syncs == 5, f"{syncs} fetches on the 16x16 beam_jax run "
                  "(want one per window: 5)")
            check(launches[algo]["scar_eval"] >= 11,
                  f"only {launches[algo]['scar_eval']} scar_eval launches "
                  "on the 16x16 beam_jax run (want >= 11, every batch)")
            check(launches[algo]["scar_search"] > 0,
                  "the 16x16 beam_jax run launched no scar_search kernel")
    print(f"16x16 wall: beam {walls['beam']:.3f} s, beam_jax "
          f"{walls['beam_jax']:.3f} s")
    fused_window_without_sync(case, dev)
    for algo in ("beam", "beam_jax"):
        cfg = SearchConfig(path_cap=case["path_cap"], algo=algo)
        clear_caches()
        print(f"traced {algo} run, seconds by span (nested spans overlap): "
              + span_totals(lambda: run_case(case, cfg, dev)))
    for algo in ("beam", "beam_jax"):
        cfg = SearchConfig(path_cap=case["path_cap"], algo=algo)
        clear_caches()
        wall, busy, top = device_time_of(lambda: run_case(case, cfg, dev))
        print(f"profiled {algo} run: wall {wall:.4f} s, device busy "
              f"{busy:.6f} s ({100 * busy / wall:.2f}%), top by device time:"
              + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top))

    phase("5 summary")
    print(json.dumps({"kernels": [{
        "name": "scar_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scar_eval.cu",
        "replaces": "src/repro/kernels/scar_eval/kernel.py:64",
        "launches": launches["beam_jax"]["scar_eval"],
        "max_abs_err": worst, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "device_ms": dev_ms,
        "launches_by_path": {a: launches[a]["scar_eval"] for a in launches},
    }, {
        "name": "scar_search", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scar_search.cu",
        "replaces": "src/repro/kernels/scar_search/kernel.py:37",
        "launches": launches["beam_jax"]["scar_search"],
        "max_abs_err": s_err, "ms": s_ms,
        "plain_ms": s_p_ms, "bound_ms": s_b_ms, "bound_by": s_b_by,
        "library_ms": None, "device_ms": s_dev_ms,
        "launches_by_path": {a: launches[a]["scar_search"]
                             for a in launches},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
