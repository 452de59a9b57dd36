#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain torch version on the card, then drives the scheduler end
to end, with the host beam (``algo="beam"``) and with the fused device
search (``algo="beam_jax"``), and holds its plans and float64 metrics
against the golden file the JAX reference wrote
(``tests/fixtures/torch_port_golden.json``); then serves zamba2-2.7b at
full width and holds reduced zamba2's logits against the reference's
(``tests/fixtures/torch_lm_golden.npz``); then replays the online serving
layer's traces on the card; then runs the portfolio sweeps, plans and
realizes three models on a pod, and serves the MoE and xLSTM models at
full width.  It imports neither JAX nor the reference
package.  Phases, each printed as it runs:

1. card: ``nvidia-smi`` name, power limit and SM clock, library versions,
   kernel builds (one ``nvcc`` per source, all at once)
2a. ``scar_eval`` (a whole window's scores, comm terms included, in one
   launch) against ``scar_eval_window_plain``, bit for bit, over a sweep
   of shapes (one and four models a launch) and on every window of the
   16x16 production run, built as the fused schedule builds them; CUDA-event
   and profiler times of the largest window and the card's bound for it.
   Then the congestion comm model: a sweep with random per-link waits
   under the three NoC presets (one to four models, cold and anchored,
   pipelined and not, Lw up to 5 000), whole-window and one-model
   launches, and every window of the 16x16 ``narrow`` congestion run with
   the link costs its fused chain scored it with; times and bound of the
   largest of those windows beside the analytic one
2b. ``scar_search`` (a beam stage's whole screen: disjointness, keep,
   expansion budget, masked scores) against ``scar_search_plain``, bit for
   bit in float32 and float64, over a sweep and on the inputs of the 16x16
   fused run's largest beam stage, with times and the bound
2c. ``flash_attention`` against ``attention_plain`` over a sweep (Sq == Skv
   of 1 to 2048, Sq < Skv with ``q_offset`` and ``kv_len``, head_dim 16 to
   128, GQA groups 1, 2, 8, causal or not, bf16 and float32) and on the
   inputs of the full-width zamba2-2.7b prefill's first attention block,
   with times (the profiler's device time sums every kernel a call
   launches, its parts printed), the bound, the dynamic shared memory a
   CTA takes, and ``F.scaled_dot_product_attention`` on the same inputs as
   a yardstick (the port never calls it)
2d. ``ssd_scan`` against ``ssd_scan_plain`` likewise (chunks 16 to 256, N
   and P of 16 and 64, q and k broadcast over heads, the running-sum state
   carry, in bf16 exactly over 8 chunks; slow-decay cases up to the serve
   shape; batch-1 prompts up to 32k rows, timed) and on the inputs of the
   first Mamba-2 block
2e. the kernels at the new models' shapes: ``ssd_scan`` at xlstm-350m's
   mLSTM widths (q, k, v [4, 1024, 4, 256] bf16, chunk 256) with its
   normaliser in the same launch, ``flash_attention`` at head_dim 128
   (qwen2-moe-a2.7b's MHA [4, 1024, 16, 128], minitron-8b's GQA [4, 1024,
   32, 128] over 8 kv heads): each output within 2e-2 of the largest plain
   output, times, bounds, SDPA for attention
3. paper package: the ten Table II scenarios on the 6x6 ``het_cross`` MCM,
   under ``eval_backend="auto"`` (as the golden file was made), with every
   batch on the kernel (``eval_backend="cuda"``), and with
   ``algo="beam_jax"`` (one fetch per window)
4. production size: ``dc4_lms_seg_image`` on the 16x16 ``het_cb`` pod at
   ``path_cap=1024``, with ``algo="beam"`` under ``auto`` and with
   ``algo="beam_jax"``; each run counts its kernel launches from zero (one
   ``scar_eval`` a window and one ``scar_search`` a beam stage under
   ``beam_jax``).  One window's fused program runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so a hidden sync raises;
   the profiler's device events of each window program, traced span
   breakdowns of both paths and each run's device time from
   ``torch.profiler``
5. every other search option, against the golden file: the ten 6x6
   scenarios under ``comm_model="congestion"`` (``het_rows`` NoC) with
   ``beam`` under ``auto``, with every batch on the kernel and with
   ``beam_jax``; 16x16 ``dc4`` with the ``narrow`` NoC under ``beam`` and
   ``beam_jax`` (one ``scar_eval`` launch a model, one ``scar_search`` a
   stage, one fetch a window) and one of its congestion windows under
   ``set_sync_debug_mode("error")``; ``evolutionary``, ``anneal`` and
   ``refine_iters=300`` cases on 6x6 and ``anneal`` on 16x16; a 16x16
   refinement with ``eval_backend="cuda"`` (the relocate screen on the
   kernel): never worse, valid, the same twice; span breakdowns and the
   profiled device busy share of the 16x16 congestion ``beam_jax`` run
6. LM serving at full width: ``repro_torch.launch.serve.main`` on
   zamba2-2.7b, batch 4, prompt 1024, 32 tokens, bf16, greedy: 45
   ``ssd_scan`` and 9 ``flash_attention`` launches per prefill and none in
   decode; every kernel call of one bf16 prefill against its plain version
   on its own inputs (2e-2); profiles of one prefill and one decode step;
   the same prefill with the plain versions on the card, compared on the
   last-token logits in bf16 (same greedy tokens, but for rows whose two
   largest plain logits are exactly equal) and in float32 (within 1e-3)
7. reference parity: reduced zamba2 in float32 on the card (kernels on,
   TF32 off) against the logits the JAX reference wrote
   (``tests/fixtures/torch_lm_golden.npz``)
9. online serving (``repro_torch.online``, run before the summary), against
   the records the JAX reference wrote
   (``tests/fixtures/torch_online_golden.json``), every run's counts from
   zero and its planning caches cleared first: ``dc_churn_6x6`` on 6x6
   ``het_cross`` (``path_cap=64``, ``seg_cap=128``) warm and cold under
   ``auto`` (== the float64 record), warm and cold with every batch on
   ``scar_eval`` (== the reference's float32 record but for its known
   exact ties; warm == cold; one launch and one fetch a scoring batch)
   and under ``beam_jax`` (the same ties; warm == cold; one fetch and one
   ``scar_eval`` launch a window searched, ``scar_search`` launched), with
   the median re-plan times, and the warm runs profiled and traced;
   ``dc_churn_8x8_slo`` under ``drain`` and ``preempt`` with
   reconfiguration (== the record), and the latter under ``beam_jax``,
   held equal to the port's plain-kernel run on the CPU; ``xr8_cadence``;
   ``dc_fleet_smoke`` through both routings; ``bench_fleet_serving``'s
   open-loop trace streamed over 5 000 s (``scripts/torch_fleet_stream.py``,
   at most 16 events buffered)
10. portfolio (``repro_torch.core.portfolio``) against the records the
   JAX reference wrote (``tests/fixtures/torch_portfolio_golden.json``):
   the headline grid (ten scenarios x seven packages, 3x3) inline with its
   two EDP reductions, and the large-mesh grid (dc4, xr7 x het_cb,
   het_sides x 8x8, 16x16, ``path_cap=512``) under the default search and
   ``beam_jax``, inline and on four ``spawn`` workers sharing the card:
   ``==`` the records, launches summed over the workers' jobs == inline,
   wall time and each worker's peak memory
11. multimodel (``repro_torch.multimodel``): the 16x16 pod plan == the
   record; then minitron-8b, qwen2-moe-a2.7b and xlstm-350m planned at
   batch 4, sequence 1024 and realized at full width one at a time on the
   card: launches, prefill time, peak memory, every kernel call of one
   prefill against its plain version (2e-2); the bf16 last-token logits
   against the plain path's (each routing its own tokens) beside a
   witness, the plain path with one-ulp moves at the share of outputs the
   kernels leave unequal, both printed; for minitron-8b and
   qwen2-moe-a2.7b the same prefill realized in float32, kernels against
   plain versions within 1e-3 of the largest logit (phase 6's check)
12. serving qwen2-moe-a2.7b and xlstm-350m at full width (batch 4, prompt
   1024, 32 tokens): prefill time, decode tokens/s, peak memory, launches
   per prefill (none in decode), a profiled prefill's device idle share,
   and, printed, the step where each row's greedy tokens part from the
   plain versions' run
13. sync witness: the 16x16 ``dc4`` golden case of phases 4-5 under
   ``beam`` with ``auto`` and with ``eval_backend="cuda"``, under
   ``beam_jax``, and under ``beam_jax`` with the ``narrow`` congestion
   NoC, and one warm ``dc_churn_6x6`` replay with every batch on
   ``scar_eval`` (phase 9's), each under
   ``torch.cuda.set_sync_debug_mode("warn")`` with every warning recorded:
   the syncs the CUDA runtime reports, how many were raised from
   ``launch/platform.py`` (the sanctioned site of SL002, the port
   linter's sync rule), ``sync_count()``, and every other reporting site
   as file:line x count, each site the innermost ``repro_torch`` frame
   of the warning's Python stack.  A site in ``repro_torch/core/`` or
   ``kernels/`` must carry a reasoned ``# scarlint: ignore[SL002]``;
   sites elsewhere are printed.  Plans stay those of phases 4, 5 and 9;
   the linter's own run over ``src/repro_torch`` (its wall time on this
   host) opens the phase
8. summary: a JSON line of the portfolio, multimodel, serving and sync
   witness numbers,
   then one of per-kernel numbers (``launches_by_path`` includes the
   online, portfolio, realized and served runs; ``shapes`` the new models'
   kernel shapes of phase 2e)
10. last line: ``{"ok": true, "device": {...}}``

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a CUDA device.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
import traceback
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

GOLDEN = ROOT / "tests" / "fixtures" / "torch_port_golden.json"
LM_GOLDEN = ROOT / "tests" / "fixtures" / "torch_lm_golden.npz"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # H100 SXM, bf16 tensor cores, dense
# kernel vs plain, elementwise |k - p| <= atol + rtol |p| (tests/test_kernels.py)
LM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# whole-model float32 logits against the reference fixture, as the CPU
# tests hold them: max |port - reference| <= LM_MODEL_REL * max |reference|
LM_MODEL_REL = 5e-5
SERVE_ARGV = ["--arch", "zamba2-2.7b", "--batch", "4", "--prompt-len",
              "1024", "--gen", "32"]
# the new models' kernel shapes: xlstm-350m's mLSTM scan (B, L, H, N = P,
# chunk; with its normaliser), qwen2-moe-a2.7b's MHA and minitron-8b's GQA
# attention (B, S, Hq, Hkv, D), causal
XLSTM_SSD = (4, 1024, 4, 256, 256)
ATTN_D128 = {"qwen2-moe-a2.7b": (4, 1024, 16, 16, 128),
             "minitron-8b": (4, 1024, 32, 8, 128)}
# the models served at full width (phases 11 and 12), batch 4, prompt 1024:
# each kernel's launches per prefill (one per layer of its kind)
NEW_SERVE = {"qwen2-moe-a2.7b": {"flash_attention": 24, "ssd_scan": 0},
             "xlstm-350m": {"flash_attention": 0, "ssd_scan": 12}}
POD_ARCHS = ("minitron-8b", "qwen2-moe-a2.7b", "xlstm-350m")
POD_LAUNCHES = {"minitron-8b": {"flash_attention": 32, "ssd_scan": 0},
                **NEW_SERVE}
PORTFOLIO_GOLDEN = (ROOT / "tests" / "fixtures"
                    / "torch_portfolio_golden.json")
# the realized models whose float32 prefill fits on the card and whose
# kernel shapes the float32 kernels take (xlstm-350m's N = P = 256 is above
# the float32 scan's 128): kernel path against plain path, each routing its
# own tokens, within 1e-3 of the largest logit (phase 6's float32 check)
F32_POD_ARCHS = ("minitron-8b", "qwen2-moe-a2.7b")
PROFILER_TRIES = 2              # sessions before a profiled time is None
PORTFOLIO_PROCS = 4
FLASH_S = (1, 64, 1000, 2048)
FLASH_D = (16, 64, 80, 128)
FLASH_G = (1, 2, 8)
# (Sq, Skv, q_offset, kv_len): a later query chunk, prefill into a longer
# cache (the serve path), one row at a decode position
FLASH_OFFSET = ((100, 300, 37, 200), (48, 1056, 0, 48), (1024, 1056, 0, 1024),
                (1, 1056, 500, 501))
# (B, L, H, N, P, chunk, q and k broadcast over heads)
SSD_CASES = ((1, 128, 2, 16, 16, 16, False), (2, 256, 4, 64, 64, 64, False),
             (2, 48, 8, 16, 16, 16, True), (1, 512, 4, 64, 64, 256, True),
             (2, 1024, 8, 16, 64, 256, True), (1, 256, 3, 64, 16, 64, False))
# slow decay a = -0.01 U[0, 1) (Mamba-2's small dt), >= 4 chunks each, the
# last at the serve shape: where rounding the bf16 kernel's float32-held
# operands once to bf16 would break 2e-2.  bf16 is held elementwise to
# 2e-2; float32 to 2e-5 of the largest plain output, since the state sums
# up to 1024 barely decayed steps into outputs of several hundred, and an
# output near zero carries the summation order's own error (about 1e-4)
# beyond an elementwise 2e-5.
SSD_SLOW_CASES = ((1, 1024, 8, 64, 64, 256, True),
                  (2, 256, 4, 32, 48, 64, False),
                  (4, 1024, 80, 64, 64, 256, True))
# bf16 ssd_scan at zamba2-2.7b's widths (80 heads, N = P = 64, chunk 256,
# q and k broadcast) and batch 1, prompts up to 32k rows: its time per row
# as the chain of chunks grows from 4 to 128 links
SSD_LONG = (1024, 4096, 16384, 32768)
KERNEL_RTOL = 1e-5              # of max |plain|; both float32

# scar_eval sweep: B, Lw (2 400 takes 54 KB of shared memory at C = 2,
# past the 48 KB a launch gets without opting in; 5 000 a third carry
# level of the blocked prefix), S, C, models a launch
SWEEP_B = (1, 127, 128, 4672, 65536)
SWEEP_LW = (1, 16, 17, 56, 300, 2400, 5000)
SWEEP_S = (1, 6, 8)
SWEEP_C = (2, 3)
SWEEP_MODELS = (1, 4)
# scar_search sweep: Bm, N (8 193: one past a 1 024-candidate tile;
# 65 536 at Bm 64: 4 096 CTAs, several waves of the card, so tiles wait on
# tickets whose CTAs started in an earlier wave), W (each vector path and
# the any-W one), keep (N: no limit), max_exp, score type
SEARCH_BM = (1, 48, 64)
SEARCH_N = (1, 255, 8192, 8193, 65536)
SEARCH_W = (2, 3, 4, 8)
SEARCH_MAX_EXP = (1, 7, 20000)
LOP3_PER_CLOCK_PER_SM = 64      # 32-bit logical operation, compute 9.0
H100_SMS = 132
PROD_KEY = "het_cb_16x16_cap1024/dc4_lms_seg_image"
CONG_KEY = "het_cb_16x16_cap1024_congestion_narrow/dc4_lms_seg_image"
REFINE_ITERS = 300              # phase 5's 16x16 refinement
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


def profiled_device_ms(fn, reps: int = 25):
    """Device time (ms) of one ``fn()`` call from ``torch.profiler``: the
    sum over every device event the call makes (all its kernels, and any
    fill it needs), with the parts as ``(name, events per call, ms per
    call)``; ``(None, [])`` when the profiler records none in
    ``PROFILER_TRIES`` sessions (it sometimes returns a session without
    device events)."""
    for _ in range(PROFILER_TRIES):
        ms, parts = _profiled_device_ms(fn, reps)
        if parts:
            return ms, parts
    return None, []


def _profiled_device_ms(fn, reps: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == DeviceType.CPU:
            continue
        us = getattr(ev, "device_time_total",
                     getattr(ev, "cuda_time_total", 0.0))
        if us > 0 and ev.count:
            parts.append((ev.key[:60], ev.count / reps, us / reps / 1e3))
    if not parts:
        return None, []
    return sum(t for _, _, t in parts), parts


def show_parts(parts) -> str:
    return "; ".join(f"{k} x{n:g} {t:.6f} ms" for k, n, t in parts)


def random_model(rng, B, Lw, S, C, *, prev_end=None, pipelined=True):
    """Seeded raw inputs of one model (``scar_eval.ModelInputs``) on the
    host: some zero byte counts (the comm formulas' ``sz > 0`` branches),
    a single-segment row and a padding row."""
    from repro_torch.kernels.scar_eval import ModelInputs

    def logn(mu, shape, zeros=0.0):
        a = rng.lognormal(mu, 2, shape).astype(np.float32)
        return np.where(rng.random(shape) < zeros, np.float32(0), a)

    n_segs = rng.integers(1, min(S, Lw) + 1, B)
    n_segs[0] = 1
    if B > 1:
        n_segs[-1] = 0
    # k - 1 strictly increasing cuts in [0, Lw - 2], then the window end
    j = np.arange(S)
    u = np.sort(rng.random((B, S)), axis=1)
    cuts = np.floor(u * (Lw - n_segs[:, None] + 1)).astype(np.int64) + j
    last = np.where(j < n_segs[:, None] - 1, cuts,
                    np.where(j == n_segs[:, None] - 1, Lw - 1, -1))
    chips = np.where(j < n_segs[:, None], rng.integers(0, 36, (B, S)), -1)
    return ModelInputs(logn(-9, (Lw, C)), logn(-5, (Lw, C)),
                       logn(12, Lw, 0.1), logn(10, Lw, 0.1),
                       float(np.float32(rng.lognormal(10, 1))),
                       chips.astype(np.int32), last.astype(np.int32),
                       n_segs.astype(np.int32), prev_end, pipelined)


def random_window(rng, n_models, B, Lw, S, C, dev, noc=None):
    """A seeded ``scar_eval`` window batch on the card, on a 6x6 mesh: one
    model, or up to four of other widths and batch sizes, cold and
    anchored, pipelined and not.  With ``noc`` (a NoC preset), under the
    congestion model: each model with seeded per-link waiting times (some
    links idle)."""
    from repro_torch.core.chiplet import PackageParams
    from repro_torch.core.scenarios import noc_config
    from repro_torch.kernels.scar_eval import pack_window
    models = []
    for i in range(n_models):
        m = random_model(rng, max(1, B >> i), max(1, Lw - 7 * i), S, C,
                         prev_end=None if i % 2 == 0 else 5 * i,
                         pipelined=i != 3)
        if noc is not None:
            cost = rng.lognormal(-9, 2, 60).astype(np.float32)
            cost[rng.random(60) < 0.2] = 0
            m = m._replace(link_cost=cost)
        models.append(m)
    return pack_window(models, rng.integers(0, C, 36), PackageParams(), 6,
                       n_models, device=dev, rows=6,
                       noc=None if noc is None else noc_config(noc))


def same_bits(out, ref, what: str) -> float:
    """Raises unless ``out`` equals ``ref`` bit for bit; returns
    ``max |out - ref|`` over the finite entries (0.0)."""
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    err = (out[fin] - ref[fin]).abs().max().item() if fin.any() else 0.0
    check(torch.equal(out, ref), f"{what}: kernel differs from its plain "
          f"version (max |kernel - plain| {err})")
    return err


def eval_bound_ms(batch) -> tuple[float, str]:
    """``scar_eval``'s least time on one window: every input read once and
    the ``[B, 2]`` scores written once, against the float32 operations:
    about 32 a live segment (segment sums, the DRAM and NoP formulas, the
    segment total, sum and max), 13 a candidate (its first segment's
    input) and ``(2 C + 1) Lw`` prefix additions a model.  Under the
    congestion model the link costs are read too, and a live segment
    takes about 12 more operations (the two corrections and their sums),
    a candidate 5 (its first input's), and one max for every link of its
    routes: to its DRAM port, to the next segment, from the anchor."""
    tensors = list(batch[:10])
    if batch.link_cost is not None:
        tensors.append(batch.link_cost)
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + 8 * batch.chips.shape[0]
    live = int(batch.n_segs.clamp(0, batch.chips.shape[1]).sum().item())
    cands = int((batch.n_segs > 0).sum().item())
    flops = 32 * live + 13 * cands + (2 * batch.lat_tab.shape[1] + 1) \
        * batch.lat_tab.shape[0]
    if batch.link_cost is not None:
        flops += 12 * live + 5 * cands + route_links(batch)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def route_links(batch) -> int:
    """Links on the routes of a window's live transfers: each live
    segment's DRAM route, the forward to the next segment, and the
    anchored first input's route."""
    cols = batch.cols
    S = batch.chips.shape[1]
    chips = batch.chips.clamp(min=0).long()
    n = batch.n_segs.long()[:, None]
    j = torch.arange(S, device=chips.device)[None, :]
    r, c = chips // cols, chips % cols
    nxt = torch.roll(chips, -1, 1)
    hd = torch.minimum(c, cols - 1 - c)
    hn = (r - nxt // cols).abs() + (c - nxt % cols).abs()
    total = int((hd * (j < n)).sum().item() + (hn * (j < n - 1)).sum()
                .item())
    for slot in batch.models:
        if slot.prev_end is not None:
            c0 = chips[slot.cand_off:slot.cand_off + slot.n_cand, 0]
            live = n[slot.cand_off:slot.cand_off + slot.n_cand, 0] > 0
            pr, pc = divmod(slot.prev_end, cols)
            total += int((((c0 // cols - pr).abs() + (c0 % cols - pc).abs())
                          * live).sum().item())
    return total


def screen_bound_ms(t, sm_clock_hz) -> tuple[float, str]:
    """``scar_search``'s least time on one stage: its words, validity,
    state and lat / energy rows read once, the score plane and state
    written once, against the disjointness test of this stage's live rows
    and valid candidates, ``W`` AND-into-OR operations (one LOP3 each) a
    pair at 64 per clock per SM on 132 SMs at the card's maximum SM
    clock."""
    bm, w = t["beam_words"].shape
    n = t["cand_words"].shape[0]
    es = t["c_lat"].element_size()
    nbytes = 4 * (bm + n) * w + n + es * (2 * bm + 2 * n + bm * n) + 64
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    pairs = min(int(t["state"][2]), bm) * int(t["valid"].sum())
    t_ops = pairs * w / (LOP3_PER_CLOCK_PER_SM * H100_SMS
                         * sm_clock_hz) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_stage(bm, n, w, dtype, seed, dev):
    """Seeded screen inputs on the card: int32-held uint32 words (dense,
    and sparse ANDs of three and of six draws, so that rows find few or
    many disjoint candidates; an all-zero and an all-ones row), a valid
    prefix, live rows and expansions so far, and lat / energy rows."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def words(rows):
        def draw():
            return torch.randint(-2 ** 31, 2 ** 31, (rows, w), generator=g,
                                 device=dev, dtype=torch.int64).to(
                                     torch.int32)
        dense = draw()
        sparse3 = dense & draw() & draw()
        sparse6 = sparse3 & draw() & draw() & draw()
        pick = torch.randint(0, 3, (rows, 1), generator=g, device=dev)
        out = torch.where(pick == 0, dense,
                          torch.where(pick == 1, sparse3, sparse6))
        out[0] = 0
        if rows > 1:
            out[1] = -1
        return out.contiguous()

    def logn(rows, mu):
        return torch.exp(mu + torch.randn(rows, generator=g, device=dev)
                         ).to(dtype)

    n_valid = int(torch.randint(n // 2, n + 1, (1,), generator=g,
                                device=dev).item())
    live = int(torch.randint(0, bm + 1, (1,), generator=g,
                             device=dev).item())
    return dict(beam_words=words(bm), cand_words=words(n),
                valid=torch.arange(n, device=dev) < n_valid,
                state=torch.tensor([0, seed % 10, live, 0], device=dev),
                b_lat=logn(bm, -6.0), b_e=logn(bm, -2.0),
                c_lat=logn(n, -6.0), c_e=logn(n, -2.0))


def largest_screen(case, dev):
    """The screen inputs of the largest beam stage (by ``Bm * N``, then
    by live beam rows) of the fused 16x16 run, recorded from the stage's
    ``screen`` call in a run of its own."""
    from repro_torch.core import device_search, get_scenario, make_mcm
    from repro_torch.core import schedule
    from repro_torch.core.scheduler import SearchConfig
    seen = {}
    real = device_search.screen

    def record(beam_words, cand_words, valid, state, *, use_kernel,
               **stage):
        key = (beam_words.shape[0] * cand_words.shape[0],
               int(state[2].item()))
        if key > seen.get("key", (-1, -1)):
            args = dict(beam_words=beam_words, cand_words=cand_words,
                        valid=valid, state=state, **stage)
            seen.update(key=key, args={k: v.clone() if torch.is_tensor(v)
                                       else v for k, v in args.items()})
        return real(beam_words, cand_words, valid, state,
                    use_kernel=use_kernel, **stage)

    device_search.screen = record
    try:
        schedule(get_scenario(case["scenario"]),
                 make_mcm(case["pattern"], rows=case["rows"],
                          cols=case["cols"], n_pe=case["n_pe"]),
                 SearchConfig(path_cap=case["path_cap"], algo="beam_jax"),
                 device=dev)
    finally:
        device_search.screen = real
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


def device_time_of(run, host_ops: bool = True
                   ) -> tuple[float, float, list, int]:
    """``(wall s, device-busy s, top kernels, device events)`` of one
    ``run()`` under ``torch.profiler``: the sum of the device's own events
    (kernels, copies, memsets), the five largest by total time, and their
    number.  The profiler slows the host, so the wall time here is longer
    than unprofiled; ``host_ops=False`` records the device alone (a run of
    some 10^5 launches then takes seconds, not minutes, to summarise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    with profile(activities=acts) as prof:
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
    return wall, sum(r[2] for r in rows), rows[:5], sum(r[1] for r in rows)


def golden_mcm(case):
    from repro_torch.core import make_mcm
    from repro_torch.core.scenarios import noc_config
    return make_mcm(case["pattern"], rows=case["rows"], cols=case["cols"],
                    n_pe=case["n_pe"],
                    noc=noc_config(case["noc"]) if case["noc"] else None)


def case_config(case, **change):
    """The golden case's ``SearchConfig``, with ``change`` applied."""
    from repro_torch.core.scheduler import SearchConfig
    return SearchConfig(**{"path_cap": case["path_cap"], **case["config"],
                           **change})


def production_windows(case, dev):
    """Every window of a golden 16x16 run, built and uploaded as the
    fused schedule builds it (``DeviceBeamEngine.window_inputs``), each
    window's anchors taken from the golden plans of the windows before it.
    Returns the config, the engine and per window ``(window, n_pad)``."""
    from repro_torch.core import get_scenario
    from repro_torch.core.engine import DeviceBeamEngine
    from repro_torch.core.reconfig import greedy_pack
    from repro_torch.core.scheduler import get_cost_db
    cfg = case_config(case, algo="beam_jax")
    mcm = golden_mcm(case)
    db = get_cost_db(get_scenario(case["scenario"]), mcm)
    engine = DeviceBeamEngine(beam=cfg.beam, device=dev,
                              comm_model=cfg.comm_model)
    anchors: dict[int, int] = {}
    windows = []
    for w, ranges in enumerate(greedy_pack(db, mcm.class_counts(),
                                           cfg.n_splits).ranges):
        window, _, n_pad = engine.window_inputs(db, mcm, cfg, ranges,
                                                dict(anchors))
        windows.append((window, n_pad))
        for mi, _, chips in case["plans"][w]:
            anchors[mi] = chips[-1]
    return cfg, engine, windows


def window_program(window, n_pad, cfg, engine):
    from repro_torch.core import device_search
    return device_search.fused_program(
        window, beam=cfg.beam, keep=cfg.keep_per_model, metric=cfg.metric,
        max_exp=engine.max_expansions, n_pad=n_pad, use_kernel=True,
        congestion=cfg.comm_model == "congestion")


def fused_window_without_sync(windows, cfg, engine, w: int = 0) -> None:
    """Window ``w`` of a 16x16 fused run, its inputs uploaded: its device
    program with synchronising CUDA calls turned into errors."""
    from repro_torch.launch import platform
    window, n_pad = windows[w]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = window_program(window, n_pad, cfg, engine)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fails = platform.device_fetch(out[-1])[0]
    check(not fails.any(), "the window program found no disjoint placement")
    print(f"window {w} ({len(window[0].models)} models, n_pad {n_pad}, "
          f"{cfg.comm_model}): fused program ran under "
          "set_sync_debug_mode('error') with no sync")


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
    from repro_torch.core import get_scenario, schedule
    mcm = golden_mcm(case)
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


# the sync witness (phase 13): the runs, and the directories of
# src/repro_torch where the port's linter (SL002) allows no uncounted sync
SYNC_RUNS = (("16x16 beam auto", PROD_KEY, {"algo": "beam"}),
             ("16x16 beam cuda", PROD_KEY, {"algo": "beam",
                                             "eval_backend": "cuda"}),
             ("16x16 beam_jax", PROD_KEY, {"algo": "beam_jax"}),
             ("16x16 narrow congestion beam_jax", CONG_KEY,
              {"algo": "beam_jax"}))
SYNC_SCOPE = ("core", "kernels")
SYNC_WARNING = "called a synchronizing CUDA operation"
PORT_SRC = ROOT / "src" / "repro_torch"


def reported_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``.

    Every warning is kept (``simplefilter("always")``: otherwise Python
    shows one per location).  Returns ``fn()``'s result, one record per
    reported sync — the warning's own ``file:line``, and the innermost
    frame of its Python stack inside ``src/repro_torch`` as ``(path
    relative to the repo, line)`` (None when the stack holds none) — and
    the texts of the other warnings (the mode's own notice that it is a
    prototype, once a process).
    """
    records, others = [], []

    def keep(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            others.append(str(message))
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if pathlib.Path(f.filename).is_relative_to(PORT_SRC)]
        inner = frames[-1] if frames else None
        records.append((f"{filename}:{lineno}",
                        None if inner is None else (
                            pathlib.Path(inner.filename).relative_to(
                                ROOT).as_posix(), inner.lineno)))

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, records, others


def sync_witness_phase(golden, dev, smi: str) -> dict:
    """Phase 13: the syncs the CUDA runtime reports on the scheduler's
    paths, held against SL002's static claim (see the docstring)."""
    from repro_torch.analysis.lint import (BASELINE_FILENAME, Baseline,
                                           ModuleContext, lint_paths)
    from repro_torch.core import get_scenario, schedule
    from repro_torch.core.scheduler import clear_caches
    from repro_torch.launch import platform
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_torch_online_golden as og

    report = lint_paths([PORT_SRC], root=ROOT,
                        baseline=Baseline.load(ROOT / BASELINE_FILENAME))
    check(report.ok(strict_baseline=True), "scarlint over src/repro_torch: "
          + "; ".join(f.format_text() for f in report.active))
    print(f"card: {smi}")
    print(f"scarlint over src/repro_torch on this host: "
          f"{report.files_scanned} files, {len(report.active)} active / "
          f"{len(report.suppressed)} suppressed findings "
          f"{report.per_rule()} in {report.runtime_ms:.1f} ms")
    contexts: dict[str, ModuleContext] = {}

    def reasoned_ignore(path: str, line: int) -> bool:
        if path not in contexts:
            contexts[path] = ModuleContext(str(ROOT / path),
                                           (ROOT / path).read_text(),
                                           rel_path=path)
        ctx = contexts[path]
        if not ctx.is_suppressed("SL002", line):
            return False
        i = line
        while "scarlint: ignore" not in ctx.line_text(i):
            i -= 1
        return "--" in ctx.line_text(i)

    def hold(label, fn, expect):
        clear_caches()
        platform.reset_sync_count()
        out, records, others = reported_syncs(fn)
        syncs = platform.sync_count()
        expect(out)
        sites = collections.Counter(
            f"{inner[0]}:{inner[1]}" if inner else where
            for where, inner in records)
        at_platform = sum(1 for _, inner in records if inner
                          and inner[0].endswith("launch/platform.py"))
        same = sum(1 for where, inner in records if inner
                   and where == f"{ROOT / inner[0]}:{inner[1]}")
        unsuppressed = []
        for _, inner in records:
            if inner is None:
                continue
            parts = pathlib.PurePosixPath(inner[0]).relative_to(
                "src/repro_torch").parts
            if parts[0] in SYNC_SCOPE and not reasoned_ignore(*inner):
                unsuppressed.append(f"{inner[0]}:{inner[1]}")
        print(f"{label}: {len(records)} syncs reported by the runtime, "
              f"{at_platform} raised from launch/platform.py; sync_count() "
              f"{syncs}; sites (innermost repro_torch frame): "
              + ", ".join(f"{k} x{n}" for k, n in sorted(sites.items()))
              + f"; warning location == that frame for {same} of "
              f"{len(records)}; other warnings: {sorted(set(others))}")
        check(not unsuppressed, f"{label}: syncs reported in core/ or "
              f"kernels/ outside launch/platform.py, without a reasoned "
              f"SL002 suppression: {sorted(set(unsuppressed))}")
        return {"reported": len(records), "platform": at_platform,
                "sync_count": syncs, "sites": dict(sorted(sites.items()))}

    out = {}
    for label, key, change in SYNC_RUNS:
        case = golden[key]

        def expect(outcome, case=case, label=label):
            rec = golden_record(outcome)
            check(all(rec[k] == case[k] for k in ("plans", "latency",
                                                  "energy", "edp")),
                  f"{label}: plans or metrics are not the golden record's")

        out[label] = hold(label, lambda: schedule(
            get_scenario(case["scenario"]), golden_mcm(case),
            case_config(case, **change), device=dev), expect)
    with open(og.GOLDEN) as fh:
        f32 = json.load(fh)["runs"][ONLINE_6X6_F32]["record"]

    def expect_online(sim):
        from repro_torch.online import qos_report, slo_report
        diff, ties = og.tie_departures(
            og.sim_record(sim, qos_report, slo_report), f32)
        check(diff == ties == ONLINE_6X6_TIES["cuda"],
              f"dc_churn_6x6 cuda warm: plans depart at epochs {diff}, "
              f"exact ties {ties} (want {ONLINE_6X6_TIES['cuda']})")

    out["dc_churn_6x6 cuda warm"] = hold(
        "dc_churn_6x6 cuda warm",
        lambda: og.port_run(ONLINE_6X6_F32, dev, mode="warm"),
        expect_online)
    return out


# online serving (phase 9): the records the JAX reference wrote
# (scripts/make_torch_online_golden.py), and the epochs of dc_churn_6x6 where
# the all-float32 runs break an exact tie the other way (ROADMAP.md §3;
# tests/test_torch_online_golden_f32.py pins the same on the CPU)
ONLINE_6X6 = "online_rescheduling_6x6/auto"
ONLINE_6X6_F32 = "online_rescheduling_6x6/jax_ref"
ONLINE_6X6_TIES = {"cuda": [9, 48, 50], "beam_jax": [9, 48, 50, 56, 62, 64]}
ONLINE_SLO = ("online_slo_8x8/drain/auto",
              "online_slo_8x8/preempt_reconfig/auto")
# bench_fleet_serving's trace cut from 50 000 s to this horizon (~1e5 events)
FLEET_STREAM_HORIZON = 5_000.0


def online_run(og, key, dev, mode="warm", **change):
    """One run of the online golden spec ``key`` on ``dev``, every count
    (launches, fetches, evaluator calls, memo counters) from zero and every
    planning cache cleared first.  Returns the ``SimResult`` (or
    ``FleetReport``), its record, the counts and the host wall seconds."""
    from repro_torch import obs
    from repro_torch.core.scheduler import clear_caches
    from repro_torch.kernels.scar_eval import scar_eval
    from repro_torch.kernels.scar_search import scar_search
    from repro_torch.online import qos_report, slo_report
    clear_caches()
    obs.reset()
    scar_eval.launches = 0
    scar_search.launches = 0
    t0 = time.perf_counter()
    out = og.port_run(key, dev, mode=mode, **change)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"scar_eval": scar_eval.launches,
              "scar_search": scar_search.launches, **obs.counters()}
    rec = (og.fleet_record(out) if og.RUNS[key]["kind"] == "fleet"
           else og.sim_record(out, qos_report, slo_report))
    return out, rec, counts, wall


def replan_ms(sim) -> float:
    """Median planner wall time of a run's re-planned epochs, ms."""
    import statistics
    return statistics.median(e.replan_wall_s * 1e3 for e in sim.epochs
                             if e.outcome is not None)


def online_phase(dev) -> dict:
    """Phase 9: the online serving layer on the card (see the docstring).

    Returns the kernel launches of its runs by path for the summary line.
    """
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_torch_online_golden as og
    import torch_fleet_stream as fleet_stream
    with open(og.GOLDEN) as fh:
        gold = json.load(fh)["runs"]
    launches = {}
    fetches = "launch.platform.sync_count"

    want = gold[ONLINE_6X6]["record"]
    med = {}
    for mode in ("warm", "cold"):
        sim, rec, cnt, wall = online_run(og, ONLINE_6X6, dev, mode)
        if mode == "warm":
            check(rec == want, "dc_churn_6x6 auto warm: not the golden "
                  "record")
        else:
            check(og.without_memo(rec) == og.without_memo(want),
                  "dc_churn_6x6 auto cold: not the golden record")
        med["auto", mode] = replan_ms(sim)
        print(f"dc_churn_6x6 6x6 het_cross auto {mode}: == golden "
              f"({len(sim.epochs)} epochs, {sim.n_replans} re-plans, "
              f"{sim.n_memo_hits} memo hits); wall {wall:.3f} s, median "
              f"re-plan {med['auto', mode]:.3f} ms, {cnt[fetches]} fetches, "
              f"scar_eval launches {cnt['scar_eval']}")
    f32 = gold[ONLINE_6X6_F32]["record"]
    recs = {}
    for mode in ("warm", "cold"):
        sim, recs[mode], cnt, wall = online_run(og, ONLINE_6X6_F32, dev,
                                                mode)
        diff, ties = og.tie_departures(recs[mode], f32)
        check(diff == ties == ONLINE_6X6_TIES["cuda"],
              f"dc_churn_6x6 cuda {mode}: plans depart from the reference's "
              f"float32 record at epochs {diff}, exact ties {ties} (want the "
              f"ties {ONLINE_6X6_TIES['cuda']})")
        calls = cnt["evaluator.eval_calls.cuda"]
        check(cnt["scar_eval"] == calls > 0 and cnt[fetches] == calls,
              f"dc_churn_6x6 cuda {mode}: {cnt['scar_eval']} scar_eval "
              f"launches and {cnt[fetches]} fetches for {calls} scoring "
              "batches (want one each a batch)")
        if mode == "warm":
            launches["online_cuda"] = cnt["scar_eval"]
        med["cuda", mode] = replan_ms(sim)
        print(f"dc_churn_6x6 cuda {mode}: plans == the reference's float32 "
              f"run but the exact ties at epochs {ties}; wall {wall:.3f} s, "
              f"median re-plan {med['cuda', mode]:.3f} ms, scar_eval "
              f"launches {cnt['scar_eval']} == eval calls, {cnt[fetches]} "
              "fetches")
    check(og.without_memo(recs["warm"]) == og.without_memo(recs["cold"]),
          "dc_churn_6x6 cuda: warm and cold runs differ")
    print("dc_churn_6x6 cuda: warm == cold bit for bit")
    for mode in ("warm", "cold"):
        sim, recs[mode], cnt, wall = online_run(og, ONLINE_6X6_F32, dev,
                                                mode, algo="beam_jax")
        diff, ties = og.tie_departures(recs[mode], f32)
        check(diff == ties == ONLINE_6X6_TIES["beam_jax"],
              f"dc_churn_6x6 beam_jax {mode}: plans depart at epochs {diff}"
              f", exact ties {ties} (want the ties "
              f"{ONLINE_6X6_TIES['beam_jax']})")
        # windows searched: the warm run's window-memo misses; the cold
        # run keeps no memo and searches every window of every re-plan
        windows = (cnt["window_memo.cache_miss"] if mode == "warm" else
                   sum(len(e.outcome.windows) for e in sim.epochs
                       if e.outcome is not None))
        check(cnt[fetches] == windows == cnt["scar_eval"] > 0
              and cnt["scar_search"] > 0,
              f"dc_churn_6x6 beam_jax {mode}: {cnt[fetches]} fetches, "
              f"{cnt['scar_eval']} scar_eval and {cnt['scar_search']} "
              f"scar_search launches for {windows} windows searched (want "
              "one fetch and one scar_eval a window, scar_search > 0)")
        if mode == "warm":
            launches["online"] = {k: cnt[k]
                                  for k in ("scar_eval", "scar_search")}
        med["beam_jax", mode] = replan_ms(sim)
        print(f"dc_churn_6x6 beam_jax {mode}: plans == the reference's "
              f"float32 run but the exact ties at epochs {ties}; wall "
              f"{wall:.3f} s, median re-plan {med['beam_jax', mode]:.3f} ms;"
              f" {windows} windows searched, {cnt[fetches]} fetches, "
              f"launches scar_eval {cnt['scar_eval']}, scar_search "
              f"{cnt['scar_search']}")
    check(og.without_memo(recs["warm"]) == og.without_memo(recs["cold"]),
          "dc_churn_6x6 beam_jax: warm and cold runs differ")
    print("dc_churn_6x6 beam_jax: warm == cold bit for bit")
    print("median re-plan ms (warm / cold): " + "; ".join(
        f"{b} {med[b, 'warm']:.3f} / {med[b, 'cold']:.3f} = "
        f"{med[b, 'cold'] / med[b, 'warm']:.2f}x"
        for b in ("auto", "cuda", "beam_jax"))
        + " (the reference bench's target: warm >= 3x faster than cold)")
    for label, key, change in (("auto", ONLINE_6X6, {}),
                               ("cuda", ONLINE_6X6_F32, {}),
                               ("beam_jax", ONLINE_6X6_F32,
                                {"algo": "beam_jax"})):
        def run(key=key, change=change):
            return online_run(og, key, dev, "warm", **change)
        wall, busy, top, n_ev = device_time_of(run)
        print(f"profiled dc_churn_6x6 {label} warm: wall {wall:.4f} s, "
              f"device busy {busy:.6f} s ({100 * busy / wall:.2f}%) in "
              f"{n_ev} device events, top by device time:"
              + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top))
        print(f"traced dc_churn_6x6 {label} warm, seconds by span (nested "
              "spans overlap): " + span_totals(run))

    for key in ONLINE_SLO:
        sim, rec, cnt, wall = online_run(og, key, dev)
        check(rec == gold[key]["record"], f"{key}: not the golden record")
        lc = rec["slo"]["per_class"]
        lc = [c for c in lc if c["slo"] == "latency_critical"][0]
        print(f"{key}: == golden (preemptions {rec['slo']['n_preemptions']},"
              f" switches {rec['slo']['n_switches']}, latency-critical miss "
              f"rate {lc['miss_rate']}, EDP per iteration "
              f"{rec['slo']['edp_per_iteration']}); wall {wall:.3f} s, "
              f"median re-plan {replan_ms(sim):.3f} ms")
    key = ONLINE_SLO[1]
    sim, rec, cnt, wall = online_run(og, key, dev, algo="beam_jax")
    windows = cnt["window_memo.cache_miss"]
    check(cnt[fetches] == windows == cnt["scar_eval"] > 0
          and cnt["scar_search"] > 0,
          f"{key} beam_jax: {cnt[fetches]} fetches, {cnt['scar_eval']} "
          f"scar_eval and {cnt['scar_search']} scar_search launches for "
          f"{windows} windows searched")
    launches["online_slo"] = {k: cnt[k] for k in ("scar_eval", "scar_search")}
    t0 = time.perf_counter()
    plain = og.port_record(key, "cpu", algo="beam_jax")
    cpu_wall = time.perf_counter() - t0
    check(rec == plain, f"{key} beam_jax: the card's run differs from the "
          "port's plain run on the CPU")
    auto = gold[key]["record"]
    same = sum(a["plans"] == b["plans"]
               for a, b in zip(rec["epochs"], auto["epochs"]))
    print(f"{key} beam_jax: == the port's plain-kernel run on the CPU "
          f"({cpu_wall:.3f} s there), every epoch; {same} of "
          f"{len(auto['epochs'])} epochs' plans also == the float64 record "
          f"(float32 ties carry through the anchors); wall {wall:.3f} s, "
          f"median re-plan {replan_ms(sim):.3f} ms; {windows} windows "
          f"searched, {cnt[fetches]} fetches, launches "
          f"{launches['online_slo']}")

    key = "online_cadence/auto"
    sim, rec, cnt, wall = online_run(og, key, dev)
    check(rec == gold[key]["record"], f"{key}: not the golden record")
    print(f"xr8_cadence 3x3 het_sides: == golden ({len(sim.frames)} frames)"
          f", wall {wall:.3f} s")
    for key in ("fleet/least_loaded", "fleet/round_robin"):
        rep, rec, cnt, wall = online_run(og, key, dev)
        check(rec == gold[key]["record"], f"{key}: not the golden record")
        print(f"dc_fleet_smoke {key}: == golden (attainment "
              f"{rec['attainment']}, score {rec['score']}); wall {wall:.3f} s")
    out = fleet_stream.run(FLEET_STREAM_HORIZON, dev)
    for routing, (rep, _) in out.items():
        check(rep.max_buffered_events <= 16 and rep.n_events > 50_000,
              f"streamed fleet {routing}: {rep.max_buffered_events} events "
              f"buffered over {rep.n_events} (want <= 16)")
    print(f"streamed open-loop fleet, horizon {FLEET_STREAM_HORIZON} s: "
          + fleet_stream.summary(out))
    return launches


def kernel_err_of_max(out, ref, what: str) -> float:
    """``max |out - ref|``; raises unless it is at most ``LM_TOL`` (float32:
    2e-5) of ``max |ref|``."""
    o, r = out.float(), ref.float()
    check(bool(torch.isfinite(o).all()), f"{what}: output not finite")
    err = (o - r).abs().max().item()
    limit = LM_TOL[torch.float32] * r.abs().max().item()
    check(err <= limit, f"{what}: max |kernel - plain| = {err}, beyond "
          f"2e-5 of max |plain| ({limit})")
    return err


def kernel_err(out, ref, dtype, what: str) -> float:
    """``max |out - ref|``; raises unless ``|out - ref| <= tol + tol |ref|``
    everywhere, with ``tol`` the reference tests' 2e-5 (float32) or 2e-2
    (bf16)."""
    tol = LM_TOL[dtype]
    o, r = out.float(), ref.float()
    check(bool(torch.isfinite(o).all()), f"{what}: output not finite")
    diff = (o - r).abs()
    err = diff.max().item()
    check(bool((diff <= tol + tol * r.abs()).all()),
          f"{what}: max |kernel - plain| = {err}, beyond rtol = atol = {tol}")
    return err


def randn(shape, g, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def flash_bound_ms(q, k, causal, q_offset, kv_len) -> tuple[float, str]:
    """``flash_attention``'s least time on these inputs: q read and o
    written once, the kv rows the mask lets any query see read once, and
    two multiply-adds per head_dim element of every unmasked (query, key)
    pair, at the peak rate of the inputs' type."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1:3]
    kv_end = min(Skv, kv_len)
    if causal:
        seen = np.minimum(kv_end, np.arange(Sq) + q_offset + 1)
        pairs, kv_rows = int(seen.sum()), min(kv_end, Sq + q_offset)
    else:
        pairs, kv_rows = Sq * kv_end, kv_end
    es = q.element_size()
    nbytes = es * (2 * B * Sq * Hq * D + 2 * B * kv_rows * Hkv * D)
    flops = 4 * B * Hq * D * pairs
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bound_ms(q, k, v, chunk, norm: bool = False) -> tuple[float, str]:
    """``ssd_scan``'s least time: q and k read once (once per batch row
    when they are broadcast over heads), v and a read and o written once
    (and the normaliser written, with ``norm``); per (batch, head) the
    in-chunk causal pairs times (N + P) multiply-adds plus the inter-chunk
    and state products, 4 L N P (with ``norm`` P + 1 columns), at the peak
    rate of the inputs' type."""
    B, L, H, N = q.shape
    P = v.shape[-1] + (1 if norm else 0)
    c = min(chunk, L)
    es = v.element_size()
    heads_q = 1 if q.stride(2) == 0 else H
    heads_k = 1 if k.stride(2) == 0 else H
    nbytes = (es * (B * L * (heads_q + heads_k) * N + 2 * B * L * H * P)
              + 4 * B * L * H)
    flops = B * H * (L * (c + 1) * (N + P) + 4 * L * N * P)
    peak = BF16_FLOP_PER_S if v.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serve_argv(gen: int) -> list[str]:
    return SERVE_ARGV[:-1] + [str(gen)]


def keep(t):
    """A copy of ``t``; a head-broadcast view stays one."""
    return t[:, :, :1].clone().expand_as(t) if t.stride(2) == 0 \
        else t.clone()


@contextlib.contextmanager
def recording_calls(calls: list):
    """Every ``flash_attention`` and ``ssd_scan`` call of the model layers
    inside appends ``(name, args, kwargs, out)`` to ``calls``, copies of
    its inputs and its output."""
    from repro_torch.models import layers
    real = {"flash_attention": layers.flash_attention,
            "ssd_scan": layers.ssd_scan}

    def recorder(name):
        def call(*args, **kwargs):
            out = real[name](*args, **kwargs)
            calls.append((name, tuple(keep(a) for a in args), dict(kwargs),
                          tuple(o.clone() for o in outputs(out))))
            return out
        return call

    layers.flash_attention = recorder("flash_attention")
    layers.ssd_scan = recorder("ssd_scan")
    try:
        yield
    finally:
        layers.flash_attention = real["flash_attention"]
        layers.ssd_scan = real["ssd_scan"]


def recorded_prefill():
    """One full-width ``serve.main`` run without decode steps (``--gen 1``),
    recording the inputs of the first ``flash_attention`` and ``ssd_scan``
    calls of its prefill.  Returns ``{name: (args, kwargs)}`` and the
    launches of that prefill."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    calls = []
    flash_attention.launches = 0
    ssd_scan.launches = 0
    with recording_calls(calls):
        serve.main(serve_argv(1))
    torch.cuda.synchronize()
    seen = {}
    for name, args, kwargs, _ in calls:
        seen.setdefault(name, (args, kwargs))
    return seen, {"flash_attention": flash_attention.launches,
                  "ssd_scan": ssd_scan.launches}


def profile_serve(cfg, dims, params, batch, cache, tokens) -> None:
    """Device busy time and the top kernels of one full-width prefill and
    of one decode step (after three unprofiled ones), from
    ``torch.profiler``."""
    from repro_torch.models import decode_step, prefill
    wall, busy, top, n = device_time_of(
        lambda: prefill(cfg, dims, params, batch, 1056))
    print(f"profiled prefill: wall {wall:.4f} s, device busy {busy:.6f} s "
          f"({100 * busy / wall:.2f}%) in {n} device events, top by device "
          "time:"
          + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top))
    for i in range(3):
        _, cache = decode_step(cfg, dims, params, tokens[:, i:i + 1], cache,
                               1024 + i)
    t0 = time.perf_counter()
    for i in range(3, 8):
        _, cache = decode_step(cfg, dims, params, tokens[:, i:i + 1], cache,
                               1024 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    wall, busy, top, n = device_time_of(lambda: decode_step(
        cfg, dims, params, tokens[:, 8:9], cache, 1032))
    print(f"decode step: {step_ms:.3f} ms unprofiled (mean of 5 after 3); "
          f"profiled wall {wall:.4f} s, device busy {busy:.6f} s "
          f"({100 * busy / wall:.2f}%) in {n} device events, top by device "
          "time:"
          + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top))


def rel_l2(x, ref) -> float:
    return ((x - ref).norm() / ref.norm()).item()


def logit_agreement(lk, lp) -> dict:
    """Kernel-path logits ``lk`` against plain-path logits ``lp`` ([rows,
    vocab], float32): differences, the share of rows whose argmax agrees
    (``top1``), the share that agrees or whose plain row has its two
    largest logits exactly equal and the kernel path picks one of them
    (``top1_or_exact_tie``: such a row has no one greedy token, and argmax
    takes the lower index), and the plain rows' gaps between their two
    largest logits."""
    d = (lk - lp).abs()
    pick = lk.argmax(-1)
    top2 = lp.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = pick == lp.argmax(-1)
    tied = (gap == 0) & (lp.gather(1, pick[:, None])[:, 0] == top2[:, 0])
    return {
        "max_abs": d.max().item(), "max_logit": lp.abs().max().item(),
        "rel_l2": rel_l2(lk, lp),
        "within_2e-2": (d <= 2e-2 + 2e-2 * lp.abs()).float().mean().item(),
        "top1": same.float().mean().item(),
        "top1_or_exact_tie": (same | tied).float().mean().item(),
        "plain_top2_gap": gap.tolist()}


def outputs(out) -> tuple:
    """A kernel call's outputs as a tuple (``ssd_scan`` with ``norm=True``
    returns the scan and its normaliser)."""
    return out if isinstance(out, tuple) else (out,)


def check_calls(calls: list) -> dict:
    """Each recorded call's outputs against its kernel's plain version on
    the same inputs, elementwise at the bf16 tolerance (``kernel_err``);
    per kernel the calls, the largest difference and the least share of
    outputs equal to the plain version's."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    plain = {"flash_attention": attention_plain, "ssd_scan": ssd_scan_plain}
    seen = {}
    for name, args, kwargs, outs in calls:
        refs = outputs(plain[name](*args, **kwargs))
        n, err, same = seen.get(name, (0, 0.0, 1.0))
        for out, ref in zip(outs, refs):
            err = max(err, kernel_err(
                out, ref, out.dtype, f"{name}, call {n} of the bf16 "
                "prefill"))
            same = min(same, (out == ref).float().mean().item())
        seen[name] = (n + 1, err, same)
    return {k: {"calls": n, "max_abs": e, "least_equal_share": sh}
            for k, (n, e, sh) in seen.items()}


def ulp_flips(t, share: float, gen):
    """``t`` with a random ``share`` of its nonzero entries moved one unit
    in the last place (the magnitude up or down at random)."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    bits = t.contiguous().view(ints[t.dtype])
    flip = (torch.rand(t.shape, generator=gen, device=t.device) < share) \
        & (t != 0)
    step = torch.where(torch.rand(t.shape, generator=gen, device=t.device)
                       < 0.5, 1, -1).to(bits.dtype)
    return (bits + flip.to(bits.dtype) * step).view(t.dtype)


@contextlib.contextmanager
def plain_kernels(flash: bool = True, ssd: bool = True,
                  perturb: float = 0.0):
    """The model layers take the named kernels' plain versions inside (on
    the card: the comparison prefills of phases 6, 11 and 12).  With
    ``perturb``, every plain output has that share of its entries moved
    one ulp (``ulp_flips``): the plain path with as many last-bit
    differences as the kernels leave, at random places, a witness of how
    far the model itself carries such differences."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.models import layers
    real = layers.flash_attention, layers.ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(0)

    def perturbed(fn):
        if not perturb:
            return fn

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            outs = tuple(ulp_flips(o, perturb, gen) for o in outputs(out))
            return outs if isinstance(out, tuple) else outs[0]
        return call

    layers.flash_attention = perturbed(attention_plain) if flash \
        else real[0]
    layers.ssd_scan = perturbed(ssd_scan_plain) if ssd else real[1]
    try:
        yield
    finally:
        layers.flash_attention, layers.ssd_scan = real


def new_shapes_phase(g, dev, smi) -> dict:
    """Phase 2e: the kernels at the new models' shapes, random inputs:
    ``ssd_scan`` at xlstm-350m's mLSTM widths with its normaliser in the
    same launch, ``flash_attention`` at head_dim 128 (qwen2-moe-a2.7b's MHA,
    minitron-8b's GQA).  Each output within 2e-2 of the largest plain
    output; times, bounds and, for attention, SDPA on the same inputs."""
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import kernel as flash_mod
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.kernels.ssd_scan import kernel as ssd_mod
    bf = torch.bfloat16
    rec = {}

    def of_max(out, ref, what):
        o, r = out.float(), ref.float()
        check(bool(torch.isfinite(o).all()), f"{what}: output not finite")
        err = (o - r).abs().max().item()
        limit = LM_TOL[bf] * r.abs().max().item()
        check(err <= limit, f"{what}: max |kernel - plain| = {err}, beyond "
              f"2e-2 of max |plain| ({limit})")
        return err

    B, L, H, N, P = XLSTM_SSD
    # the mLSTM's inputs: q / sqrt(P), log sigmoid forget gates
    q = randn((B, L, H, N), g, bf, dev) / 16
    k = randn((B, L, H, N), g, bf, dev)
    v = randn((B, L, H, P), g, bf, dev)
    a = -torch.nn.functional.softplus(-randn((B, L, H), g, torch.float32,
                                             dev))
    ssd_scan.launches = 0
    num, den = ssd_scan(q, k, v, a, chunk=256, norm=True)
    check(ssd_scan.launches == 1, "the scan and its normaliser took "
          f"{ssd_scan.launches} launches, want 1")
    p_num, p_den = ssd_scan_plain(q, k, v, a, chunk=256, norm=True)
    torch.cuda.synchronize()
    err = max(of_max(num, p_num, "ssd_scan at xLSTM's widths"),
              of_max(den, p_den, "ssd_scan's normaliser at xLSTM's widths"))
    kw = dict(chunk=256, norm=True)
    ms = cuda_ms(lambda: ssd_scan(q, k, v, a, **kw))
    plain_ms = cuda_ms(lambda: ssd_scan_plain(q, k, v, a, **kw), reps=5)
    dev_ms, parts = profiled_device_ms(lambda: ssd_scan(q, k, v, a, **kw))
    b_ms, b_by = ssd_bound_ms(q, k, v, 256, norm=True)
    smem = ssd_mod._lib().ssd_scan_smem_bytes(N, P, 256, 1, 1)
    rec["ssd_scan"] = {"xlstm-350m": {
        "shape": [B, L, H, N, P], "chunk": 256, "normaliser": True,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}}
    print(f"ssd_scan q/k/v {tuple(q.shape)} bf16, chunk 256, with the "
          f"normaliser, one launch: max |kernel - plain| {err!r} (output "
          f"and normaliser, each within 2e-2 of max |plain|); per call "
          f"(CUDA events, median): kernel {ms:.6f} ms, plain (two scans) "
          f"{plain_ms:.6f} ms; kernel device time (profiler) {dev_ms!r} ms "
          f"[{show_parts(parts)}]; bound {b_ms:.6f} ms ({b_by}); {smem} B "
          f"of dynamic shared memory a CTA; on {smi}; library: none")
    del q, k, v, a, num, den, p_num, p_den

    rec["flash_attention"] = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for arch, (B, S, Hq, Hkv, D) in ATTN_D128.items():
        q = randn((B, S, Hq, D), g, bf, dev)
        k = randn((B, S, Hkv, D), g, bf, dev)
        v = randn((B, S, Hkv, D), g, bf, dev)
        out = flash_attention(q, k, v, causal=True)
        ref = attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = of_max(out, ref, f"flash_attention at {arch}'s shape")
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True))
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=True),
                           reps=5)
        dev_ms, parts = profiled_device_ms(
            lambda: flash_attention(q, k, v, causal=True))
        b_ms, b_by = flash_bound_ms(q, k, True, 0, S)
        lq, lk, lv = (t.transpose(1, 2) for t in (q, k, v))
        gqa = dict(enable_gqa=True) if Hkv != Hq else {}
        lib = sdpa(lq, lk, lv, is_causal=True, **gqa).transpose(1, 2)
        lib_err = (lib.float() - out.float()).abs().max().item()
        lib_ms = cuda_ms(lambda: sdpa(lq, lk, lv, is_causal=True, **gqa))
        smem = flash_mod._lib().flash_attention_smem_bytes(
            D, flash_mod._DTYPES[bf])
        rec["flash_attention"][arch] = {
            "shape": [B, S, Hq, Hkv, D], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "device_ms": dev_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}
        print(f"flash_attention {arch}: q {tuple(q.shape)} k/v "
              f"{tuple(k.shape)} bf16 causal: max |kernel - plain| {err!r} "
              f"(within 2e-2 of max |plain|); per call (CUDA events, "
              f"median): kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"F.scaled_dot_product_attention {lib_ms:.6f} ms (max |sdpa - "
              f"kernel| {lib_err!r}); kernel device time (profiler) "
              f"{dev_ms!r} ms [{show_parts(parts)}]; bound {b_ms:.6f} ms "
              f"({b_by}); {smem} B of dynamic shared memory a CTA; on {smi}")
        del q, k, v, out, ref, lq, lk, lv, lib
    torch.cuda.empty_cache()
    return rec


def portfolio_phase() -> dict:
    """Phase 10: the portfolio runner on the card against the JAX
    reference's records (``tests/fixtures/torch_portfolio_golden.json``):
    the headline grid inline, then the large-mesh grid under the default
    search and ``beam_jax``, inline and on a spawn pool of
    ``PORTFOLIO_PROCS`` workers sharing the card.  Returns per grid and
    worker count the wall time, the kernel launches (summed over the jobs'
    own counts) and each worker's peak device memory."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_torch_portfolio_golden as pg
    import repro_torch.core.portfolio as TP
    import repro_torch.core.scenarios as TS
    from repro_torch.core.scheduler import clear_caches
    from repro_torch.kernels.scar_eval import scar_eval
    from repro_torch.kernels.scar_search import scar_search
    with open(PORTFOLIO_GOLDEN) as fh:
        fix = json.load(fh)

    def counts():
        return {"scar_eval": scar_eval.launches,
                "scar_search": scar_search.launches}

    def zero():
        clear_caches()
        scar_eval.launches = 0
        scar_search.launches = 0
        torch.cuda.reset_peak_memory_stats()

    zero()
    t0 = time.perf_counter()
    head = pg.headline_record(TP, TS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = sorted(k for k in fix["headline"]["points"]
                 if head["points"].get(k) != fix["headline"]["points"][k])
    check(not bad and head == fix["headline"],
          f"headline grid: {len(bad)} points differ from the reference's "
          f"records ({bad[:5]})")
    print(f"headline grid (10 scenarios x {len(pg.CONFIG_SET)} packages, "
          f"3x3, auto, inline on the card) == the reference's records; "
          f"EDP reductions {head['reductions']}; wall {wall:.3f} s; "
          f"launches {counts()}")
    out = {"headline": {"wall_s": wall, "launches": counts()}}
    for algo, jobs in pg.large_jobs(TP).items():
        runs = {}
        for procs in (1, PORTFOLIO_PROCS):
            zero()
            t0 = time.perf_counter()
            res = TP.run_portfolio(jobs, processes=procs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec = pg.results_record(res)
            want = fix["large_mesh"][algo]
            bad = sorted(k for k in want if rec.get(k) != want[k])
            check(not bad and sorted(rec) == sorted(want),
                  f"large-mesh grid {algo}, {procs} process(es): {bad} "
                  "differ from the reference's records")
            summed = {k: sum(r.launches[k] for r in res) for k in counts()}
            peaks: dict[int, int] = {}
            for r in res:
                peaks[r.pid] = max(peaks.get(r.pid, 0), r.peak_bytes)
            runs[procs] = {"wall_s": wall, "launches": summed,
                           "parent_launches": counts(),
                           "worker_peak_gib": sorted(
                               round(b / 2 ** 30, 4)
                               for b in peaks.values())}
            print(f"large-mesh grid {algo} ({len(jobs)} jobs: "
                  f"{'/'.join(pg.LARGE_SCENARIOS)} x "
                  f"{'/'.join(pg.LARGE_PATTERNS)} x "
                  f"{'/'.join(pg.LARGE_MESHES)}, path_cap 512, seg_cap "
                  f"128), {procs} process(es): == the reference's records; "
                  f"wall {wall:.3f} s; launches summed over the jobs "
                  f"{summed}, counted in this process {counts()}; peak "
                  f"device memory by worker {runs[procs]['worker_peak_gib']}"
                  " GiB")
        one, pool = runs[1], runs[PORTFOLIO_PROCS]
        check(one["launches"] == one["parent_launches"]
              and one["launches"]["scar_eval"] > 0,
              f"{algo} inline: jobs' launches {one['launches']}, process "
              f"{one['parent_launches']} (want equal, scar_eval > 0)")
        check(pool["launches"] == one["launches"]
              and not any(pool["parent_launches"].values()),
              f"{algo}: the pool's workers launched {pool['launches']}, "
              f"inline {one['launches']}; the parent "
              f"{pool['parent_launches']} (want none)")
        out[algo] = runs
    return out


def greedy_tokens(cfg, dims, params, batch, gen):
    """Greedy prefill + ``gen - 1`` decode steps: tokens [B, gen]."""
    from repro_torch.models import decode_step, prefill
    S = batch["tokens"].shape[1]
    logits, cache = prefill(cfg, dims, params, batch, S + gen)
    toks = [logits.argmax(-1)[:, None]]
    for i in range(gen - 1):
        logits, cache = decode_step(cfg, dims, params, toks[-1], cache,
                                    S + i)
        toks.append(logits.argmax(-1)[:, None])
    return torch.cat(toks, 1)


def realized_prefill(pod, pl, reqs, dev) -> dict:
    """One placement of ``pod`` realized alone at full width on the card:
    its launches per prefill, the prefill's time and peak memory, each
    kernel call of one prefill against its plain version, the last-token
    logits against the same prefill with the plain versions (each path
    routing its own tokens) and, as a printed witness, the plain path
    with one-ulp moves at the share of outputs the kernels leave unequal.
    For ``F32_POD_ARCHS`` the same pair of prefills again in float32
    (``realize(dtype="float32")``).  Each model is released on return."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.multimodel import realize
    one = dataclasses.replace(pod, placements=[pl])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (d, prefill_fn), = realize(one, reqs, device=dev,
                               window=pl.window).values()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(d == dev, f"{pl.arch} realized on {d}, want {dev}")
    prefill_fn()                              # warm-up
    flash_attention.launches = 0
    ssd_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last_k, cache = prefill_fn()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}
    check(launches == POD_LAUNCHES[pl.arch],
          f"{pl.arch} prefill launched {launches}, want "
          f"{POD_LAUNCHES[pl.arch]}")
    del cache
    calls = []
    with recording_calls(calls):
        prefill_fn()
    by_call = check_calls(calls)
    del calls
    with plain_kernels():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last_p, cache = prefill_fn()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    del cache
    share = max(1 - v["least_equal_share"] for v in by_call.values())
    with plain_kernels(perturb=share):
        last_f, cache = prefill_fn()
    del cache, prefill_fn
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(torch.isfinite(last_k.float()).all()),
          f"{pl.arch}: prefill logits not finite")
    out = {"window": pl.window, "chips": list(pl.chips),
           "template": pl.template, "build_s": build_s,
           "prefill_s": prefill_s, "plain_prefill_s": plain_s,
           "peak_gib": peak, "launches": launches, "calls": by_call,
           "logits": logit_agreement(last_k.float(), last_p.float()),
           "perturbed_share": share,
           "witness": logit_agreement(last_f.float(), last_p.float())}
    for r in (out["logits"], out["witness"]):
        del r["plain_top2_gap"]
    if pl.arch in F32_POD_ARCHS:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        (_, prefill_fn), = realize(one, reqs, device=dev, window=pl.window,
                                   dtype="float32").values()
        last_k, cache = prefill_fn()
        del cache
        with plain_kernels():
            last_p, cache = prefill_fn()
        del cache, prefill_fn
        f32 = logit_agreement(last_k, last_p)
        del f32["plain_top2_gap"]
        out["float32_logits"] = f32
        out["float32_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        check(bool(torch.isfinite(last_k).all())
              and f32["max_abs"] <= 1e-3 * f32["max_logit"]
              and f32["top1"] == 1.0,
              f"{pl.arch}: float32 full-width prefill, kernels vs plain "
              f"versions: {f32}")
    torch.cuda.empty_cache()
    return out


def multimodel_phase(dev, smi) -> dict:
    """Phase 11: the pod orchestrator on the card.  The 16x16 plan of the
    reference test's requests against the reference's record, then the
    three models planned with requests of batch 4, sequence 1024 and
    realized at full width one at a time (``realized_prefill``)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_torch_portfolio_golden as pg
    from repro_torch.core.scheduler import SearchConfig, clear_caches
    from repro_torch.multimodel import ServeRequest, plan
    with open(PORTFOLIO_GOLDEN) as fh:
        fix = json.load(fh)["pod"]
    clear_caches()
    reqs = [ServeRequest(*r) for r in fix["requests"]]
    t0 = time.perf_counter()
    pod = plan(reqs, rows=fix["rows"], cols=fix["cols"],
               pattern=fix["pattern"], cfg=SearchConfig(metric=fix["metric"]),
               device=dev)
    wall = time.perf_counter() - t0
    rec = pg.pod_record(pod)
    check(rec == {k: fix[k] for k in rec},
          f"16x16 pod plan: {rec} differs from the reference's record")
    print(f"16x16 het_sides pod plan of {fix['requests']}: == the "
          f"reference's record ({len(pod.placements)} placements, EDP "
          f"{rec['edp']}); wall {wall:.3f} s")
    reqs = [ServeRequest(a, batch=4, seq=1024) for a in POD_ARCHS]
    pod = plan(reqs, rows=16, cols=16, pattern="het_sides",
               cfg=SearchConfig(metric="edp"), device=dev)
    print("plan of " + ", ".join(POD_ARCHS) + " at batch 4, sequence 1024: "
          + "; ".join(f"{p.arch} window {p.window} chips {p.chips} "
                      f"{p.template}" for p in pod.placements))
    out = {}
    for arch in POD_ARCHS:
        pl = next(p for p in pod.placements if p.arch == arch)
        out[arch] = realized_prefill(pod, pl, reqs, dev)
        torch.cuda.empty_cache()
        r = out[arch]
        f32 = r.get("float32_logits",
                    "not run (no float32 kernel takes these shapes)")
        print(f"{arch} realized at full width (window {r['window']}, chips "
              f"{r['chips']}, {r['template']}), tp = 1 on the card: build "
              f"{r['build_s']:.3f} s, prefill [4, 1024] {r['prefill_s']:.4f}"
              f" s (plain versions {r['plain_prefill_s']:.4f} s), peak "
              f"{r['peak_gib']:.3f} GiB, launches {r['launches']}; kernel "
              f"calls vs plain (2e-2 elementwise) {r['calls']}; bf16 "
              f"last-token logits vs plain {r['logits']}; witness, the "
              f"plain path with {r['perturbed_share']:.3g} of each plain "
              f"output moved one ulp, vs plain {r['witness']}; float32 "
              f"logits vs plain (1e-3 of the largest) {f32}; on {smi}")
    return out


def serve_phase(dev, smi) -> dict:
    """Phase 12: ``serve.main`` on qwen2-moe-a2.7b and xlstm-350m at full
    width (batch 4, prompt 1024, 32 greedy tokens, bf16): prefill time,
    decode tokens/s, peak memory, launches (all in the prefill), one
    profiled prefill's device busy share, and, printed, the greedy tokens
    beside a run with the kernels' plain versions on the same weights and
    prompt (phase 11 holds these models' logits)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import ModelDims, get_arch, init_params, prefill
    from repro_torch.models.testing import synth_batch
    out = {}
    for arch, want in NEW_SERVE.items():
        torch.cuda.empty_cache()
        flash_attention.launches = 0
        ssd_scan.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = serve.main(["--arch", arch, "--batch", "4", "--prompt-len",
                          "1024", "--gen", "32"])
        torch.cuda.synchronize()
        launches = {"flash_attention": flash_attention.launches,
                    "ssd_scan": ssd_scan.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(launches == want, f"serve {arch} launched {launches}, want "
              f"{want}: one per layer of the kernel's kind in the prefill, "
              "none in decode")
        cfg = get_arch(arch)
        tokens = res["tokens"]
        check(tuple(tokens.shape) == (4, 32) and bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()),
            f"serve {arch} returned tokens {tuple(tokens.shape)}")
        dims = ModelDims.create(cfg)
        with torch.inference_mode():
            params = init_params(cfg, dims, generator=torch.Generator(
                device=dev).manual_seed(0))
            batch = synth_batch(cfg, batch=4, seq=1024, seed=0, device=dev)
            batch.pop("labels")
            wall, busy, top, n = device_time_of(
                lambda: prefill(cfg, dims, params, batch, 1056),
                host_ops=False)
            with plain_kernels():
                plain = greedy_tokens(cfg, dims, params, batch, 32)
        del params
        torch.cuda.empty_cache()
        parted = [None if bool((tokens[r] == plain[r]).all())
                  else int((tokens[r] != plain[r]).nonzero()[0, 0])
                  for r in range(tokens.shape[0])]
        dec_tok_s = 4 * 31 / res["decode_s"]
        out[arch] = {"prefill_s": res["prefill_s"],
                     "decode_s": res["decode_s"],
                     "decode_tok_s": dec_tok_s, "peak_gib": peak,
                     "launches_per_prefill": launches,
                     "profiled_prefill_wall_s": wall,
                     "device_busy_s": busy,
                     "device_idle_share": 1 - busy / wall,
                     "device_events": n,
                     "first_step_parting_plain": parted}
        print(f"serve {arch} (batch 4, prompt 1024, 32 tokens, bf16): "
              f"prefill {res['prefill_s'] * 1e3:.3f} ms, decode "
              f"{res['decode_s'] * 1e3:.3f} ms = {dec_tok_s:.1f} tokens/s, "
              f"peak {peak:.3f} GiB, launches per prefill {launches} (none "
              f"in decode); profiled prefill: wall {wall:.4f} s, device "
              f"busy {busy:.6f} s (idle {100 * (1 - busy / wall):.2f}%) in "
              f"{n} device events, top:"
              + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top)
              + f"; greedy tokens against the plain versions' run, per row "
              f"the first step where they part (None: all 32 equal): "
              f"{parted}; on {smi}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to measure")
    from repro_torch.kernels import build
    from repro_torch.kernels.scar_eval import (scar_eval,
                                               scar_eval_window_plain)
    from repro_torch.kernels.scar_search import (scar_search,
                                                 scar_search_plain)
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
    build.build(["scar_eval", "scar_search", "flash_attention",
                 "ssd_scan"])
    print(f"kernel build {time.perf_counter() - t0:.3f} s "
          f"(nvcc: {build.build_seconds})")
    for name, log in build.build_log.items():
        for line in log.strip().splitlines():
            print(f"  [{name}] {line}")

    phase("2a kernel: scar_eval vs scar_eval_window_plain")
    rng = np.random.default_rng(0)
    worst = 0.0
    n_cases = 0
    for B in SWEEP_B:
        for Lw in SWEEP_LW:
            for S in SWEEP_S:
                for C in SWEEP_C:
                    for n_models in SWEEP_MODELS:
                        batch = random_window(rng, n_models, B, Lw, S, C,
                                              dev)
                        worst = max(worst, same_bits(
                            scar_eval(batch), scar_eval_window_plain(batch),
                            f"scar_eval B={B} Lw={Lw} S={S} C={C} "
                            f"models={n_models}"))
                        n_cases += 1
    print(f"sweep: {n_cases} launches (B {SWEEP_B}, Lw {SWEEP_LW}, S "
          f"{SWEEP_S}, C {SWEEP_C}, models {SWEEP_MODELS}), kernel == plain "
          "bit for bit on all")
    golden = json.loads(GOLDEN.read_text())["cases"]
    cfg16, engine16, windows = production_windows(golden[PROD_KEY], dev)
    for w, (win, _) in enumerate(windows):
        worst = max(worst, same_bits(scar_eval(win[0]),
                                     scar_eval_window_plain(win[0]),
                                     f"scar_eval on 16x16 window {w}"))
    big = max((win[0] for win, _ in windows),
              key=lambda b: b.chips.shape[0])
    B, S = big.chips.shape
    k_ms = cuda_ms(lambda: scar_eval(big))
    p_ms = cuda_ms(lambda: scar_eval_window_plain(big), reps=10)
    dev_ms, dev_parts = profiled_device_ms(lambda: scar_eval(big))
    b_ms, b_by = eval_bound_ms(big)
    print(f"16x16 windows: kernel == plain bit for bit on all "
          f"{len(windows)}; largest window: {len(big.models)} models, B={B} "
          f"(per model {[m.n_cand for m in big.models]}), Lw "
          f"{[m.n_layers for m in big.models]}, S={S}, "
          f"C={big.lat_tab.shape[1]}: per call (CUDA events, median of 25): "
          f"kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms; kernel device time "
          f"(profiler) {dev_ms!r} ms [{show_parts(dev_parts)}]; bound "
          f"{b_ms:.7f} ms ({b_by}) on {smi}")
    for w, (win, _) in enumerate(windows):
        ms = cuda_ms(lambda: scar_eval(win[0]), reps=20)
        d_ms, _ = profiled_device_ms(lambda: scar_eval(win[0]), reps=10)
        print(f"  window {w}: {len(win[0].models)} models, B="
              f"{win[0].chips.shape[0]}: kernel {ms:.6f} ms per call, "
              f"device {d_ms!r} ms, bound {eval_bound_ms(win[0])[0]:.7f} ms")

    n_cases = 0
    noc_names = ("uniform", "het_rows", "narrow")
    for B in SWEEP_B:
        for Lw in SWEEP_LW:
            for S in SWEEP_S:
                n_models = 1 + n_cases % 4
                noc = noc_names[n_cases % 3]
                C = SWEEP_C[(n_cases // 3) % 2]
                batch = random_window(rng, n_models, B, Lw, S, C, dev, noc)
                what = (f"scar_eval congestion ({noc}) B={B} Lw={Lw} S={S} "
                        f"C={C} models={n_models}")
                plain = scar_eval_window_plain(batch)
                worst = max(worst, same_bits(scar_eval(batch), plain, what))
                parts = torch.cat([scar_eval(batch, model=i)
                                   for i in range(n_models)])
                same_bits(parts, plain, what + ", one launch a model")
                n_cases += 1
    print(f"congestion sweep: {n_cases} windows (B {SWEEP_B}, Lw {SWEEP_LW}, "
          f"S {SWEEP_S}, C {SWEEP_C}, 1-4 models, NoC {noc_names}, random "
          "link waits), whole-window and one-model launches == plain bit "
          "for bit on all")
    from repro_torch.core.device_search import congestion_scores
    cfg16c, engine16c, windows_c = production_windows(golden[CONG_KEY], dev)
    costed = []
    for w, ((batch, _, tiers), _) in enumerate(windows_c):
        out, cb = congestion_scores(batch, tiers, metric=cfg16c.metric,
                                    use_kernel=True)
        plain = scar_eval_window_plain(cb)
        worst = max(worst, same_bits(out, plain, f"scar_eval congestion "
                                     f"chain on 16x16 window {w}"))
        same_bits(scar_eval(cb), plain, f"scar_eval congestion whole "
                  f"16x16 window {w}")
        costed.append(cb)
    big_c = max(costed, key=lambda b: b.chips.shape[0])
    cong = {"ms": cuda_ms(lambda: scar_eval(big_c)),
            "plain_ms": cuda_ms(lambda: scar_eval_window_plain(big_c),
                                reps=5)}
    cong["device_ms"], c_parts = profiled_device_ms(lambda: scar_eval(big_c))
    n_big = len(big_c.models)
    cong["chain_ms"] = cuda_ms(lambda: [scar_eval(big_c, model=i)
                                        for i in range(n_big)])
    cong["chain_device_ms"], _ = profiled_device_ms(
        lambda: [scar_eval(big_c, model=i) for i in range(n_big)])
    cong["bound_ms"], cong["bound_by"] = eval_bound_ms(big_c)
    print(f"16x16 narrow congestion windows: chain (one launch a model) and "
          f"whole-window launch == plain bit for bit on all {len(costed)}; "
          f"largest window: {n_big} models, B={big_c.chips.shape[0]}, "
          f"S={big_c.chips.shape[1]}: whole-window launch {cong['ms']:.6f} "
          f"ms per call, device {cong['device_ms']!r} ms "
          f"[{show_parts(c_parts)}]; the chain's {n_big} launches "
          f"{cong['chain_ms']:.6f} ms, device {cong['chain_device_ms']!r} "
          f"ms; plain {cong['plain_ms']:.6f} ms; bound "
          f"{cong['bound_ms']:.7f} ms ({cong['bound_by']}); analytic "
          f"largest window above: device {dev_ms!r} ms, bound {b_ms:.7f} "
          f"ms; on {smi}")

    phase("2b kernel: scar_search vs scar_search_plain")
    n_cases = 0
    for bm in SEARCH_BM:
        for n in SEARCH_N:
            for w in SEARCH_W:
                for dt in (torch.float32, torch.float64):
                    t = random_stage(bm, n, w, dt, n_cases, dev)
                    for keep_n in (1, 48, n):
                        for max_exp in SEARCH_MAX_EXP:
                            kw = dict(keep=keep_n, max_exp=max_exp,
                                      metric="edp")
                            plane, state = scar_search(**t, **kw)
                            want = scar_search_plain(**t, **kw)
                            what = (f"scar_search Bm={bm} N={n} W={w} "
                                    f"keep={keep_n} max_exp={max_exp} {dt}")
                            same_bits(plane, want[0], what)
                            same_bits(state, want[1], what + " (state)")
                            n_cases += 1
    print(f"sweep: {n_cases} cases (Bm {SEARCH_BM}, N {SEARCH_N}, W "
          f"{SEARCH_W}, keep 1, 48, N, max_exp {SEARCH_MAX_EXP}, float32 "
          "and float64), kernel == plain bit for bit (plane and state) on "
          "all")
    stage = largest_screen(golden[PROD_KEY], dev)
    s_times = {}
    for dt in (torch.float32, torch.float64):
        t = {k: (v.to(dt) if k in ("b_lat", "b_e", "c_lat", "c_e") else v)
             for k, v in stage.items()}
        plane, state = scar_search(**t)
        want = scar_search_plain(**t)
        s_err = same_bits(plane, want[0], f"scar_search on the 16x16 "
                          f"stage, {dt}")
        same_bits(state, want[1], f"scar_search state, 16x16 stage, {dt}")
        s_ms = cuda_ms(lambda: scar_search(**t))
        s_p_ms = cuda_ms(lambda: scar_search_plain(**t))
        s_dev_ms, s_dev_parts = profiled_device_ms(lambda: scar_search(**t))
        s_b_ms, s_b_by = screen_bound_ms(t, sm_clock_hz)
        s_times[dt] = (s_ms, s_p_ms, s_dev_ms, s_b_ms, s_b_by)
        print(f"largest 16x16 beam stage Bm={t['beam_words'].shape[0]} "
              f"N={t['cand_words'].shape[0]} W={t['beam_words'].shape[1]} "
              f"keep={t['keep']} live rows {int(t['state'][2])} {dt}: "
              f"kernel == plain (accepted {int(state[0])}); per call (CUDA "
              f"events, median of 25): kernel {s_ms:.6f} ms, plain "
              f"{s_p_ms:.6f} ms; kernel device time (profiler) {s_dev_ms!r} "
              f"ms [{show_parts(s_dev_parts)}]; bound {s_b_ms:.6f} ms "
              f"({s_b_by}) on {smi}")
    s_ms, s_p_ms, s_dev_ms, s_b_ms, s_b_by = s_times[torch.float32]

    phase("2c kernel: flash_attention vs attention_plain")
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator(device=dev).manual_seed(13)
    f_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    flash_cases = []
    for si, S in enumerate(FLASH_S):
        for di, D in enumerate(FLASH_D):
            G = FLASH_G[(si + di) % len(FLASH_G)]
            for causal in (True, False):
                flash_cases.append((2 if S < 1000 else 1, S, S, 8, 8 // G, D,
                                    causal, 0, None))
    for Sq, Skv, off, kvl in FLASH_OFFSET:
        for D, G in ((80, 1), (128, 2), (64, 8)):
            flash_cases.append((2, Sq, Skv, 8, 8 // G, D, True, off, kvl))
    # ragged Sq at zamba2's head count and head_dim
    flash_cases.append((2, 1000, 1000, 32, 32, 80, True, 0, None))
    for B, Sq, Skv, Hq, Hkv, D, causal, off, kvl in flash_cases:
        for dt in (torch.float32, torch.bfloat16):
            q = randn((B, Sq, Hq, D), g, dt, dev)
            k = randn((B, Skv, Hkv, D), g, dt, dev)
            v = randn((B, Skv, Hkv, D), g, dt, dev)
            kw = dict(causal=causal, q_offset=off, kv_len=kvl)
            out = flash_attention(q, k, v, **kw)
            ref = attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            f_err[dt] = max(f_err[dt], kernel_err(
                out, ref, dt, f"flash_attention B={B} Sq={Sq} Skv={Skv} "
                f"Hq={Hq} Hkv={Hkv} D={D} {kw} {dt}"))
            n_cases += 1
    print(f"sweep: {n_cases} cases (Sq == Skv in {FLASH_S}, offset cases "
          f"{FLASH_OFFSET}, D {FLASH_D}, groups {FLASH_G}, causal and not, "
          f"float32 and bf16): max |kernel - plain| float32 "
          f"{f_err[torch.float32]!r}, bf16 {f_err[torch.bfloat16]!r} "
          f"(tolerance rtol = atol = 2e-5 / 2e-2)")
    real, prefill_launches = recorded_prefill()
    (fq, fk, fv), fkw = real["flash_attention"]
    f_out = flash_attention(fq, fk, fv, **fkw)
    f_ref = attention_plain(fq, fk, fv, **fkw)
    torch.cuda.synchronize()
    f_real_err = kernel_err(f_out, f_ref, fq.dtype,
                            "flash_attention on the serve prefill's inputs")
    f_same = (f_out == f_ref).float().mean().item()
    f_max_err = max(f_real_err, *f_err.values())
    f_ms = cuda_ms(lambda: flash_attention(fq, fk, fv, **fkw))
    f_p_ms = cuda_ms(lambda: attention_plain(fq, fk, fv, **fkw), reps=10)
    f_dev_ms, f_dev_parts = profiled_device_ms(
        lambda: flash_attention(fq, fk, fv, **fkw))
    f_b_ms, f_b_by = flash_bound_ms(fq, fk, fkw["causal"], fkw["q_offset"],
                                    fkw["kv_len"])
    from repro_torch.kernels.flash_attention import kernel as flash_mod
    flash_smem = flash_mod._lib().flash_attention_smem_bytes(
        fq.shape[-1], flash_mod._DTYPES[fq.dtype])
    kv_len = fkw["kv_len"]
    lq, lk, lv = (t.transpose(1, 2) for t in (fq, fk[:, :kv_len],
                                               fv[:, :kv_len]))
    f_lib_ref = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True).transpose(1, 2)
    f_lib_err = (f_lib_ref.float() - f_out.float()).abs().max().item()
    f_lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True))
    print(f"serve prefill's first attention: q {tuple(fq.shape)} k/v "
          f"{tuple(fk.shape)} {fq.dtype} {fkw}: max |kernel - plain| = "
          f"{f_real_err!r}, share of outputs equal to the plain version's "
          f"{f_same!r}; per call (CUDA events, median): kernel "
          f"{f_ms:.6f} ms, plain {f_p_ms:.6f} ms, "
          f"F.scaled_dot_product_attention {f_lib_ms:.6f} ms (max |sdpa - "
          f"kernel| = {f_lib_err!r}); kernel device time (profiler) "
          f"{f_dev_ms!r} ms [{show_parts(f_dev_parts)}]; bound "
          f"{f_b_ms:.6f} ms ({f_b_by}); {flash_smem} B of dynamic shared "
          f"memory a CTA; on {smi}")

    phase("2d kernel: ssd_scan vs ssd_scan_plain")
    s_err_by = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for B, L, H, N, P, chunk, shared in SSD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            hq = 1 if shared else H
            q = randn((B, L, hq, N), g, dt, dev).expand(B, L, H, N)
            k = randn((B, L, hq, N), g, dt, dev).expand(B, L, H, N)
            v = randn((B, L, H, P), g, dt, dev)
            a = -torch.nn.functional.softplus(randn((B, L, H), g,
                                                    torch.float32, dev))
            out = ssd_scan(q, k, v, a, chunk=chunk)
            ref = ssd_scan_plain(q, k, v, a, chunk=chunk)
            torch.cuda.synchronize()
            s_err_by[dt] = max(s_err_by[dt], kernel_err(
                out, ref, dt, f"ssd_scan B={B} L={L} H={H} N={N} P={P} "
                f"chunk={chunk} shared q/k={shared} {dt}"))
            n_cases += 1
    slow_f32 = []
    for B, L, H, N, P, chunk, shared in SSD_SLOW_CASES:
        hq = 1 if shared else H
        for dt in (torch.bfloat16, torch.float32):
            q = randn((B, L, hq, N), g, dt, dev).expand(B, L, H, N)
            k = randn((B, L, hq, N), g, dt, dev).expand(B, L, H, N)
            v = randn((B, L, H, P), g, dt, dev)
            a = -0.01 * torch.rand((B, L, H), generator=g, device=dev)
            out = ssd_scan(q, k, v, a, chunk=chunk)
            ref = ssd_scan_plain(q, k, v, a, chunk=chunk)
            torch.cuda.synchronize()
            what = (f"ssd_scan slow decay B={B} L={L} H={H} N={N} P={P} "
                    f"chunk={chunk} shared q/k={shared} {dt}")
            if dt == torch.bfloat16:
                s_err_by[dt] = max(s_err_by[dt], kernel_err(out, ref, dt,
                                                            what))
            else:
                err = kernel_err_of_max(out, ref, what)
                s_err_by[dt] = max(s_err_by[dt], err)
                beyond = int(((out - ref).abs()
                              > 2e-5 + 2e-5 * ref.abs()).sum())
                slow_f32.append((err, beyond, ref.abs().max().item()))
            n_cases += 1
    ones = torch.ones((1, 512, 1, 8), device=dev)
    carry = ssd_scan(ones / 8, ones, ones, torch.zeros((1, 512, 1),
                                                        device=dev), chunk=64)
    check(torch.allclose(carry[0, :, 0, 0].cpu(),
                         torch.arange(1, 513, dtype=torch.float32),
                         rtol=1e-5), "ssd_scan loses the state across chunks")
    # bf16, a = 0, 8 chunks of 256 at N = P = 64, q and k broadcast: with
    # entries in {-1, 0, 1} every product and sum is an integer float32
    # holds exactly (|o| <= 64 * 2048), so each output is the exact causal
    # sum rounded once to bf16, and a state lost or taken twice anywhere in
    # the chain of chunks shows.
    ints = [torch.randint(-1, 2, shape, generator=g, device=dev).to(
        torch.bfloat16) for shape in ((2, 2048, 1, 64), (2, 2048, 1, 64),
                                      (2, 2048, 4, 64))]
    iq, ik = (t.expand(2, 2048, 4, 64) for t in ints[:2])
    exact = torch.einsum(
        "bhij,bjhp->bihp",
        torch.einsum("bihn,bjhn->bhij", iq.double(), ik.double()).tril(),
        ints[2].double())
    run_sum = ssd_scan(iq, ik, ints[2], torch.zeros((2, 2048, 4), device=dev),
                       chunk=256)
    check(torch.equal(run_sum, exact.to(torch.bfloat16)),
          "bf16 ssd_scan with a = 0 is not the exact running sum across 8 "
          f"chunks (max |kernel - exact| "
          f"{(run_sum.double() - exact).abs().max().item()})")
    print(f"sweep: {n_cases} cases {SSD_CASES} and slow decay "
          f"{SSD_SLOW_CASES} in float32 and bf16: max |kernel - plain| "
          f"float32 {s_err_by[torch.float32]!r}, bf16 "
          f"{s_err_by[torch.bfloat16]!r}; slow decay in float32 (max "
          "|kernel - plain|, entries beyond an elementwise rtol = atol = "
          f"2e-5, max |plain|): {slow_f32}; a = 0 gives the running sum "
          "across 8 chunks in float32 and, exactly, in bf16")
    (sq, sk, sv, sa), skw = real["ssd_scan"]
    s_out = ssd_scan(sq, sk, sv, sa, **skw)
    s_ref = ssd_scan_plain(sq, sk, sv, sa, **skw)
    torch.cuda.synchronize()
    s_real_err = kernel_err(s_out, s_ref, sv.dtype,
                            "ssd_scan on the serve prefill's inputs")
    s_same = (s_out == s_ref).float().mean().item()
    ssd_max_err = max(s_real_err, *s_err_by.values())
    ssd_ms = cuda_ms(lambda: ssd_scan(sq, sk, sv, sa, **skw))
    ssd_p_ms = cuda_ms(lambda: ssd_scan_plain(sq, sk, sv, sa, **skw), reps=10)
    ssd_dev_ms, ssd_dev_parts = profiled_device_ms(
        lambda: ssd_scan(sq, sk, sv, sa, **skw))
    ssd_b_ms, ssd_b_by = ssd_bound_ms(sq, sk, sv, skw["chunk"])
    from repro_torch.kernels.ssd_scan import kernel as ssd_mod
    ssd_smem = ssd_mod._lib().ssd_scan_smem_bytes(
        sq.shape[-1], sv.shape[-1], skw["chunk"], ssd_mod._DTYPES[sv.dtype],
        0)
    print(f"serve prefill's first Mamba-2 scan: q/k {tuple(sq.shape)} (head "
          f"stride {sq.stride(2)}), v {tuple(sv.shape)} {sv.dtype}, {skw}: "
          f"max |kernel - plain| = {s_real_err!r}, share of outputs equal to "
          f"the plain version's {s_same!r}; per call (CUDA events, "
          f"median): kernel {ssd_ms:.6f} ms, plain {ssd_p_ms:.6f} ms; kernel "
          f"device time (profiler, every kernel of the call) {ssd_dev_ms!r} "
          f"ms [{show_parts(ssd_dev_parts)}]; bound {ssd_b_ms:.6f} ms "
          f"({ssd_b_by}); {ssd_smem} B of dynamic shared memory a CTA; on "
          f"{smi}; library: none (no one torch call computes it)")
    long_ms = {}
    for L in SSD_LONG:
        q, k = (randn((1, L, 1, 64), g, torch.bfloat16, dev).expand(
            1, L, 80, 64) for _ in range(2))
        v = randn((1, L, 80, 64), g, torch.bfloat16, dev)
        a = -0.01 * torch.rand((1, L, 80), generator=g, device=dev)
        kernel_err(ssd_scan(q, k, v, a, chunk=256),
                   ssd_scan_plain(q, k, v, a, chunk=256), torch.bfloat16,
                   f"ssd_scan slow decay B=1 L={L} H=80 bf16")
        long_ms[L] = cuda_ms(lambda: ssd_scan(q, k, v, a, chunk=256))
    del q, k, v, a
    print("ssd_scan bf16, B 1, H 80, N = P = 64, chunk 256, q/k broadcast, "
          "slow decay, within 2e-2 of the plain version; per call (CUDA "
          "events, median of 25) by prompt length, and per 1024 rows: "
          + "; ".join(f"L {L}: {ms:.6f} ms, {ms * 1024 / L:.6f} ms"
                      for L, ms in long_ms.items()))
    del real, fq, fk, fv, f_out, f_ref, f_lib_ref, lq, lk, lv
    del sq, sk, sv, sa, s_out, s_ref
    torch.cuda.empty_cache()

    phase("2e kernels at the new models' shapes: ssd_scan at xlstm-350m's "
          "N = P = 256 with its normaliser, flash_attention at head_dim 128")
    new_shapes = new_shapes_phase(g, dev, smi)

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
            stages = sum(len(w.plan.plans) for w in out.windows)
            check(launches[algo]["scar_eval"] == len(out.windows),
                  f"{launches[algo]['scar_eval']} scar_eval launches on the "
                  f"16x16 beam_jax run (want one per window: "
                  f"{len(out.windows)})")
            check(launches[algo]["scar_search"] == stages,
                  f"{launches[algo]['scar_search']} scar_search launches on "
                  f"the 16x16 beam_jax run (want one per beam stage: "
                  f"{stages})")
            print(f"beam_jax per 16x16 schedule: {len(out.windows)} windows, "
                  f"{stages} beam stages; scar_eval "
                  f"{launches[algo]['scar_eval']} launches (one a window), "
                  f"scar_search {launches[algo]['scar_search']} (one a "
                  "stage)")
    print(f"16x16 wall: beam {walls['beam']:.3f} s, beam_jax "
          f"{walls['beam_jax']:.3f} s")
    fused_window_without_sync(windows, cfg16, engine16)
    for w, (win, n_pad) in enumerate(windows):
        wall, busy, top, n_ev = device_time_of(
            lambda: window_program(win, n_pad, cfg16, engine16))
        print(f"profiled window {w} program ({len(win[0].models)} models, "
              f"n_pad {n_pad}): {n_ev} device events, device busy "
              f"{busy:.6f} s of {wall:.4f} s wall, top by device time:"
              + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top))
    for algo in ("beam", "beam_jax"):
        cfg = SearchConfig(path_cap=case["path_cap"], algo=algo)
        clear_caches()
        print(f"traced {algo} run, seconds by span (nested spans overlap): "
              + span_totals(lambda: run_case(case, cfg, dev)))
    for algo in ("beam", "beam_jax"):
        cfg = SearchConfig(path_cap=case["path_cap"], algo=algo)
        clear_caches()
        wall, busy, top, n_ev = device_time_of(lambda: run_case(case, cfg,
                                                                dev))
        print(f"profiled {algo} run: wall {wall:.4f} s, device busy "
              f"{busy:.6f} s ({100 * busy / wall:.2f}%) in {n_ev} device "
              "events, top by device time:"
              + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top))

    phase("5 search options: congestion, evolutionary, anneal, refine")
    from repro_torch.core import get_scenario, schedule
    from repro_torch.core.cost import evaluate_schedule
    from repro_torch.core.refine import refine
    from repro_torch.core.scheduler import get_cost_db
    cong_keys = sorted(k for k in golden
                       if k.startswith("het_cross_6x6_congestion_het_rows/"))
    for backend, algo in (("auto", "beam"), ("cuda", "beam"),
                          ("auto", "beam_jax")):
        clear_caches()
        scar_eval.launches = 0
        scar_search.launches = 0
        for key in cong_keys:
            case = golden[key]
            exact = backend == "auto" or \
                case["scenario"] not in F32_TIE_SCENARIOS
            platform.reset_sync_count()
            out, wall = run_case(case, case_config(
                case, eval_backend=backend, algo=algo), dev,
                exact_plans=exact)
            syncs = platform.sync_count()
            if algo == "beam_jax":
                check(syncs == len(out.windows),
                      f"{key}: {syncs} fetches for {len(out.windows)} "
                      "windows")
            print(f"  congestion {algo} {backend} {case['scenario']}: edp "
                  f"{out.edp!r} = golden"
                  f"{'' if exact else ' (plans: known float32 tie)'}, "
                  f"{wall:.3f} s, {syncs} fetches")
        check(scar_eval.launches > 0, f"the congestion {algo} {backend} "
              "runs launched no scar_eval kernel")
        if algo == "beam_jax":
            check(scar_search.launches > 0, "the congestion beam_jax runs "
                  "launched no scar_search kernel")
        print(f"6x6 congestion {algo} {backend}: scar_eval launches "
              f"{scar_eval.launches}, scar_search launches "
              f"{scar_search.launches}")
    case = golden[CONG_KEY]
    for algo in ("beam", "beam_jax"):
        clear_caches()
        platform.reset_sync_count()
        scar_eval.launches = 0
        scar_search.launches = 0
        out, walls[f"{algo}_congestion"] = run_case(
            case, case_config(case, algo=algo), dev)
        launches[f"{algo}_congestion"] = {
            "scar_eval": scar_eval.launches,
            "scar_search": scar_search.launches}
        syncs = platform.sync_count()
        print(f"16x16 narrow congestion {algo}: edp {out.edp!r} = golden; "
              f"wall {walls[f'{algo}_congestion']:.3f} s; launches "
              f"{launches[f'{algo}_congestion']}; fetches {syncs}")
        if algo == "beam_jax":
            stages = sum(len(w.plan.plans) for w in out.windows)
            check(syncs == len(out.windows) == 5,
                  f"{syncs} fetches on the 16x16 congestion beam_jax run")
            check(launches["beam_jax_congestion"]
                  == {"scar_eval": stages, "scar_search": stages},
                  f"16x16 congestion beam_jax launches "
                  f"{launches['beam_jax_congestion']}, want one scar_eval a "
                  f"model and one scar_search a stage ({stages})")
        else:
            check(scar_eval.launches > 0, "the 16x16 congestion beam run "
                  "launched no scar_eval kernel")
    big_w = max(range(len(windows_c)),
                key=lambda i: windows_c[i][0][0].chips.shape[0])
    fused_window_without_sync(windows_c, cfg16c, engine16c, big_w)
    for algo in ("beam", "beam_jax"):
        clear_caches()
        print(f"traced 16x16 congestion {algo} run, seconds by span: "
              + span_totals(lambda: run_case(
                  case, case_config(case, algo=algo), dev)))
    clear_caches()
    wall, busy, top, n_ev = device_time_of(lambda: run_case(
        case, case_config(case, algo="beam_jax"), dev))
    print(f"profiled 16x16 congestion beam_jax run: wall {wall:.4f} s, "
          f"device busy {busy:.6f} s ({100 * busy / wall:.2f}%) in {n_ev} "
          "device events, top by device time:"
          + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top))

    stoch_keys = sorted(k for k, c in golden.items()
                        if c["config"].get("algo") in ("evolutionary",
                                                       "anneal")
                        or c["config"].get("refine_iters"))
    for key in stoch_keys:
        case = golden[key]
        clear_caches()
        scar_eval.launches = 0
        out, wall = run_case(case, case_config(case), dev)
        print(f"  {key}: edp {out.edp!r} = golden, plans = golden; "
              f"{wall:.3f} s; scar_eval launches {scar_eval.launches}")
        if key.startswith("het_cb_16x16"):
            launches["anneal"] = {"scar_eval": scar_eval.launches,
                                  "scar_search": 0}
            walls["anneal"] = wall
            check(scar_eval.launches > 0, "the 16x16 anneal run launched "
                  "no scar_eval kernel")
    case = golden[PROD_KEY]
    sc, mcm = get_scenario(case["scenario"]), golden_mcm(case)
    base, _ = run_case(case, case_config(case, algo="beam"), dev)
    refined = []
    for _ in range(2):
        scar_eval.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refined.append(refine(sc, mcm, base, iters=REFINE_ITERS, seed=0,
                              backend="cuda", device=dev))
        torch.cuda.synchronize()
        walls["refine"] = time.perf_counter() - t0
        launches["refine"] = {"scar_eval": scar_eval.launches,
                              "scar_search": 0}
    r1, r2 = refined
    check(r1.edp <= base.edp * (1 + 1e-12), f"16x16 refine made the "
          f"schedule worse: {r1.edp} > {base.edp}")
    check(golden_record(r1) == golden_record(r2),
          "16x16 refine differs between two runs with one seed")
    db = get_cost_db(sc, mcm)
    res = evaluate_schedule(db, mcm, [w.plan for w in r1.windows],
                            validate=True)
    check(res.edp == r1.edp, "16x16 refined schedule re-evaluates to "
          f"{res.edp}, not {r1.edp}")
    check(launches["refine"]["scar_eval"] > 0, "the 16x16 refine with "
          "eval_backend='cuda' launched no scar_eval kernel")
    print(f"16x16 refine, {REFINE_ITERS} iterations, eval_backend='cuda': "
          f"edp {base.edp!r} -> {r1.edp!r} (never worse, valid, the same "
          f"twice); {walls['refine']:.3f} s; scar_eval launches "
          f"{launches['refine']['scar_eval']} (relocate screens)")
    print("traced 16x16 refine, seconds by span: " + span_totals(
        lambda: refine(sc, mcm, base, iters=REFINE_ITERS, seed=0,
                       backend="cuda", device=dev)))

    phase("6 serve: zamba2-2.7b at full width, batch 4, prompt 1024, "
          "32 tokens, bf16, greedy")
    from repro_torch.launch import serve
    from repro_torch.models import ModelDims, get_arch, init_params, prefill
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.testing import (numpy_tree, reduced, synth_batch,
                                            teacher_forced)
    print(f"prefill only (--gen 1, phase 2c's recorded run): launches "
          f"{prefill_launches}")
    check(prefill_launches == {"flash_attention": 9, "ssd_scan": 45},
          f"one full-width prefill launched {prefill_launches}, want 9 "
          "flash_attention (shared-attention blocks) and 45 ssd_scan "
          "(Mamba-2 blocks)")
    flash_attention.launches = 0
    ssd_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    serve_launches = {"flash_attention": flash_attention.launches,
                      "ssd_scan": ssd_scan.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = res["tokens"]
    cfg = get_arch("zamba2-2.7b")
    check(tuple(tokens.shape) == (4, 32) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab)).all()),
        f"serve returned tokens {tuple(tokens.shape)}")
    check(serve_launches == prefill_launches,
          f"serve with 31 decode steps launched {serve_launches}, its "
          f"prefill alone {prefill_launches}: decode must launch none")
    dec_tok_s = 4 * 31 / res["decode_s"]
    print(f"serve: launches {serve_launches} = the prefill's, so 0 in "
          f"31 decode steps; prefill {res['prefill_s'] * 1e3:.3f} ms, decode "
          f"{res['decode_s'] * 1e3:.3f} ms = {dec_tok_s:.1f} tokens/s "
          f"(batch 4), {res['decode_s'] * 1e3 / 31:.3f} ms per step; peak "
          f"memory {peak_gb:.3f} GiB; on {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    dims = ModelDims.create(cfg)
    batch = synth_batch(cfg, batch=4, seq=1024, seed=0, device=dev)
    batch.pop("labels")
    compared, logits = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        dcfg = dataclasses.replace(cfg, dtype=str(dt).split(".")[-1])
        with torch.inference_mode():
            params = init_params(dcfg, dims, generator=torch.Generator(
                device=dev).manual_seed(0), dtype=dt)
            calls = []
            with (recording_calls(calls) if dt == torch.bfloat16
                  else contextlib.nullcontext()):
                last_k, cache = prefill(dcfg, dims, params, batch, 1056)
            if dt == torch.bfloat16:
                by_call = check_calls(calls)
                del calls
                print(f"every kernel call of the bf16 prefill (54 layers) "
                      "against its plain version on its own inputs, "
                      f"elementwise within rtol = atol = 2e-2: {by_call}")
                check({k: v["calls"] for k, v in by_call.items()}
                      == {"flash_attention": 9, "ssd_scan": 45},
                      f"the recorded bf16 prefill made {by_call} calls")
                profile_serve(cfg, dims, params, batch, cache, tokens)
            del cache
            with plain_kernels():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                last_p, cache = prefill(dcfg, dims, params, batch, 1056)
                torch.cuda.synchronize()
                plain_prefill_s = time.perf_counter() - t0
            del cache
            if dt != torch.bfloat16:
                del params
        torch.cuda.empty_cache()
        if dt == torch.bfloat16:
            check(torch.equal(last_k.argmax(-1), tokens[:, 0]),
                  "the serve run's first tokens are not this prefill's "
                  "argmax")
        lk, lp = last_k.float(), last_p.float()
        check(bool(torch.isfinite(lk).all()), "prefill logits not finite")
        logits[dt] = lk, lp
        compared[dt] = logit_agreement(lk, lp)
        compared[dt]["plain_prefill_ms"] = plain_prefill_s * 1e3
        print(f"last-token logits [4, {cfg.vocab}] of the full-width prefill "
              f"in {dt} (TF32 off), kernels vs plain versions, same weights "
              f"and prompt: {compared[dt]}")
        if dt == torch.bfloat16:
            # which kernel moves the bf16 logits: one kernel at a time
            with torch.inference_mode():
                for name, flash, ssd in (("flash_attention alone", False,
                                          True),
                                         ("ssd_scan alone", True, False)):
                    with plain_kernels(flash=flash, ssd=ssd):
                        one, cache = prefill(dcfg, dims, params, batch, 1056)
                    del cache
                    print(f"  bf16, {name} on the kernel, the other plain: "
                          f"{logit_agreement(one.float(), lp)}")
                del params
            torch.cuda.empty_cache()
    # bf16: both paths round each layer's output to bf16; a one-ulp flip
    # (0.4%) grows through 54 layers of random weights, as the float32 run
    # shows for its own last-bit differences, so each kernel call is held
    # elementwise above and the bf16 logits to the greedy choice: each
    # row's argmax agrees, unless the plain row's two largest logits are
    # exactly equal, when the kernel path must pick one of them; float32
    # to 1e-3 of the largest logit.
    bk, bp = logits[torch.bfloat16]
    f32_logits = logits[torch.float32][0]
    print("bf16 last-token logits against the float32 kernel path's (the "
          "same weights, rounded): rel L2 kernel path "
          f"{rel_l2(bk, f32_logits)!r}, plain path "
          f"{rel_l2(bp, f32_logits)!r}")
    check(compared[torch.bfloat16]["top1_or_exact_tie"] == 1.0,
          "bf16 prefill: the kernels and the plain versions pick different "
          "greedy tokens in a row without an exact tie")
    f32 = compared[torch.float32]
    check(f32["max_abs"] <= 1e-3 * f32["max_logit"] and f32["top1"] == 1.0,
          f"float32 full-width prefill, kernels vs plain versions: {f32}")
    torch.cuda.empty_cache()

    phase("7 reference parity: reduced zamba2, float32, on the card")
    with np.load(LM_GOLDEN) as f:
        fix = {k: f[k] for k in f.files}
    rcfg = dataclasses.replace(reduced(get_arch(str(fix["arch"]))),
                               dtype="float32")
    rparams = params_from_numpy(rcfg, numpy_tree(rcfg,
                                                 int(fix["weight_seed"])),
                                device=dev, dtype=torch.float32)
    flash_attention.launches = 0
    ssd_scan.launches = 0
    with torch.inference_mode():
        out = teacher_forced(rcfg, rparams, torch.tensor(fix["tokens"],
                                                         device=dev),
                             int(fix["prompt_len"]), int(fix["max_len"]))
    torch.cuda.synchronize()
    check(flash_attention.launches > 0 and ssd_scan.launches > 0,
          "the reduced run launched no kernel")
    errs = {}
    for key in ("forward", "prefill_last", "decode"):
        ref = fix[key]
        errs[key] = float(np.abs(out[key].cpu().numpy() - ref).max())
        check(errs[key] <= LM_MODEL_REL * np.abs(ref).max(),
              f"reduced zamba2 {key} logits: max |port - reference| "
              f"{errs[key]} > {LM_MODEL_REL} * {np.abs(ref).max()}")
    print(f"{rcfg.name} float32 (TF32 off) against the JAX reference's "
          f"logits: max |port - reference| {errs} (limit {LM_MODEL_REL} * "
          f"max |reference| = {LM_MODEL_REL * np.abs(fix['forward']).max()}"
          f"); launches flash_attention {flash_attention.launches}, ssd_scan "
          f"{ssd_scan.launches} (forward and prefill; decode is plain)")

    phase("9 online: dc_churn_6x6, dc_churn_8x8_slo, xr8_cadence, the "
          "fleet")
    online = online_phase(dev)

    phase("10 portfolio: the headline grid and the large-mesh grid, inline "
          f"and on {PORTFOLIO_PROCS} spawn workers")
    portfolio = portfolio_phase()

    phase("11 multimodel: the 16x16 pod plan, then minitron-8b, "
          "qwen2-moe-a2.7b and xlstm-350m realized at full width")
    pod = multimodel_phase(dev, smi)

    phase("12 serve: qwen2-moe-a2.7b and xlstm-350m at full width, batch 4, "
          "prompt 1024, 32 tokens, bf16, greedy")
    served = serve_phase(dev, smi)

    phase("13 sync witness: the 16x16 dc4 case under beam auto, beam cuda, "
          "beam_jax and narrow congestion beam_jax, and a warm dc_churn_6x6 "
          "cuda replay, under set_sync_debug_mode('warn')")
    witness = sync_witness_phase(golden, dev, smi)

    phase("8 summary")
    print(json.dumps({"portfolio": portfolio, "multimodel": pod,
                      "serve": served, "sync_witness": witness}))
    print(json.dumps({"kernels": [{
        "name": "scar_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scar_eval.cu",
        "replaces": "src/repro/kernels/scar_eval/kernel.py:64",
        "launches": launches["beam_jax"]["scar_eval"],
        "max_abs_err": worst, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "device_ms": dev_ms,
        "launches_by_path": {**{a: launches[a]["scar_eval"]
                                for a in launches},
                             "online": online["online"]["scar_eval"],
                             "online_cuda": online["online_cuda"],
                             "online_slo": online["online_slo"]["scar_eval"],
                             "portfolio": {
                                 algo: portfolio[algo][1]["launches"][
                                     "scar_eval"]
                                 for algo in ("auto", "beam_jax")}},
        "congestion": cong,
    }, {
        "name": "scar_search", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scar_search.cu",
        "replaces": "src/repro/kernels/scar_search/kernel.py:37",
        "launches": launches["beam_jax"]["scar_search"],
        "max_abs_err": s_err, "ms": s_ms,
        "plain_ms": s_p_ms, "bound_ms": s_b_ms, "bound_by": s_b_by,
        "library_ms": None, "device_ms": s_dev_ms,
        "launches_by_path": {**{a: launches[a]["scar_search"]
                                for a in launches},
                             "online": online["online"]["scar_search"],
                             "online_slo":
                                 online["online_slo"]["scar_search"],
                             "portfolio": {
                                 algo: portfolio[algo][1]["launches"][
                                     "scar_search"]
                                 for algo in ("auto", "beam_jax")}},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": serve_launches["flash_attention"],
        "max_abs_err": f_max_err, "ms": f_ms,
        "plain_ms": f_p_ms, "bound_ms": f_b_ms, "bound_by": f_b_by,
        "library_ms": f_lib_ms, "device_ms": f_dev_ms,
        "launches_by_path": {
            "serve_zamba2": serve_launches["flash_attention"],
            **{f"realize_{a}": pod[a]["launches"]["flash_attention"]
               for a in POD_ARCHS},
            **{f"serve_{a}": served[a]["launches_per_prefill"][
                "flash_attention"] for a in NEW_SERVE}},
        "shapes": new_shapes["flash_attention"],
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:63",
        "launches": serve_launches["ssd_scan"],
        "max_abs_err": ssd_max_err, "ms": ssd_ms,
        "plain_ms": ssd_p_ms, "bound_ms": ssd_b_ms, "bound_by": ssd_b_by,
        "library_ms": None, "device_ms": ssd_dev_ms,
        "launches_by_path": {
            "serve_zamba2": serve_launches["ssd_scan"],
            **{f"realize_{a}": pod[a]["launches"]["ssd_scan"]
               for a in POD_ARCHS},
            **{f"serve_{a}": served[a]["launches_per_prefill"]["ssd_scan"]
               for a in NEW_SERVE}},
        "shapes": new_shapes["ssd_scan"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
