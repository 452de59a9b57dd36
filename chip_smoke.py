#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``src/repro_torch``) on one card.

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain torch version on the card, then drives the scheduler end
to end, with the host beam (``algo="beam"``) and with the fused device
search (``algo="beam_jax"``), and holds its plans and float64 metrics
against the golden file the JAX reference wrote
(``tests/fixtures/torch_port_golden.json``); then serves zamba2-2.7b at
full width and holds reduced zamba2's logits against the reference's
(``tests/fixtures/torch_lm_golden.npz``); then serves the cross-attention
VLM at full width with its depth cut and holds the reduced VLM against the
reference (``tests/fixtures/torch_vlm_golden.npz``); then replays the
online serving
layer's traces on the card; then runs the portfolio sweeps, plans and
realizes three models on a pod, and serves the MoE and xLSTM models at
full width; then trains zamba2-2.7b at full width, with the attention and
SSD backward kernels, xlstm-350m at full width, with the wide scan's
backward and the sLSTM recurrence kernels, and qwen2-moe-a2.7b at its
published widths with the depth cut; then runs the port sharded over two
ranks that share the card.  It imports neither JAX nor the reference
package.  Phases, each printed as it runs:

1. card: ``nvidia-smi`` name, power limit and SM clock, library versions,
   kernel builds (one ``nvcc`` per source, all eight at once)
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
   output, times, bounds, SDPA for attention; then phase 16's shapes of a
   rank, each held the same way: ``flash_attention`` on a tp = 2 rank's
   heads (qwen2-moe-a2.7b [4, 1024, 8, 128] over 8, minitron-8b [4, 1024,
   16, 128] over 4) and ``ssd_scan`` on a dp = 2 rank's two rows of
   xlstm-350m's batch (contiguous and as the mLSTM's strided views)
2f. xLSTM's training kernels: ``ssd_wide_bwd`` (the SSD scan's backward
   for N, P up to 256 and the mLSTM's normaliser; bf16 on ``wgmma``)
   against ``ssd_scan_bwd_plain``, and ``slstm`` / ``slstm_bwd`` (the
   sLSTM recurrence, forward and backward) against ``slstm_scan_plain`` /
   ``slstm_scan_bwd_plain``, over sweeps (float32 and bf16; N and P of 48
   and 80; at xlstm-350m's shape slow decay and the mLSTM's strided
   views; a decode step, a batch over two clusters, one and two full
   tiles of 8 rows, dh 128 and 20, a stage cut at L, gx a column slice
   of a wider projection (the same bits as from a copy), a dp = 2 rank's
   two rows of xlstm-350m's batch, xlstm-350m's training shapes last, the
   sLSTM's also in float32), each output within 2e-2 (bf16) or 2e-5
   (float32) of its
   largest plain entry and a second call the same bits; the bf16 sLSTM
   cell alone (r = 0) with its carries of every position within
   float32's 2e-5 of the largest plain entry; times at
   xlstm-350m's shapes beside the bound and the plain version, device
   times and each launch's part profiled in a new process
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
15. the cross-attention VLM (run after phase 7): ``serve.main`` on
   llama-3.2-vision-90b at its published widths with the depth cut to two
   super-blocks (10 layers, 2 of them cross-attention, over a 4 096-row
   context; batch 4, prompt 1024, 32 tokens, bf16, gates drawn nonzero):
   12 ``flash_attention`` launches per prefill (each layer's
   self-attention, each cross layer's context) and none in decode, each
   call within 2e-2 of its plain version on its own inputs, the cross
   caches bit-unchanged by decode, the first greedy tokens those of the
   plain path but for exact ties and later partings within the first
   token's logit difference, times of the self and cross calls beside
   their bounds and SDPA, prefill, decode, peak memory and a profiled
   prefill's idle share; then the reduced VLM in float32 (float32
   context) against ``tests/fixtures/torch_vlm_golden.npz``
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
   card: launches (xlstm-350m: 12 ``ssd_scan`` and 12 ``slstm``), prefill
   time, peak memory, every kernel call of one prefill against its plain
   version (2e-2); the bf16 last-token logits
   against the plain path's (each routing its own tokens) beside a
   witness, the plain path with one-ulp moves at the share of outputs the
   kernels leave unequal, both printed; for minitron-8b and
   qwen2-moe-a2.7b the same prefill realized in float32, kernels against
   plain versions within 1e-3 of the largest logit (phase 6's check)
12. serving qwen2-moe-a2.7b and xlstm-350m at full width (batch 4, prompt
   1024, 32 tokens): prefill time, decode tokens/s, peak memory, launches
   per prefill and per decode step (xlstm-350m: 12 ``slstm`` in each, the
   cache's carry in and out; no other kernel in decode), a profiled
   prefill's device idle share, and, printed, the step where each row's
   greedy tokens part from the plain versions' run
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
14. training (before the summary): ``flash_attention_bwd`` and
   ``ssd_scan_bwd`` against ``attention_bwd_plain`` / ``ssd_scan_bwd_plain``
   over sweeps (zamba2-2.7b's training shapes, minitron-8b's at tp = 2,
   float32 at small shapes, GQA at head_dim 128, slow-decay SSD; bf16 elementwise within 2e-2,
   float32 within 2e-5 of the largest plain gradient; the bf16 attention
   backward fed the forward kernel's row log-sum-exp), each call repeated
   and held to the same bits, the share of bf16 outputs bit-equal to the
   plain version's; their times at zamba2's shapes beside the bound, each
   kernel of a call's device time, and, for attention, the backward of
   ``F.scaled_dot_product_attention`` (per call and its device time);
   reduced zamba2 in float32 on the
   kernels, three AdamW steps against the JAX reference's
   (``tests/fixtures/torch_train_golden.npz``, the CPU test's limits);
   zamba2-2.7b at full width (bf16, seeded random weights, batch 4 x 1024,
   remat ``nothing``, AdamW with float32 moments): a warm-up step, every
   parameter leaf's gradient nonzero after it, three timed steps (step
   time, tokens/s, peak memory, 6 N T FLOP a step over that time, launches
   a step) and one profiled step; then ``python -m
   repro_torch.launch.train --smoke --device cuda`` crashed at step 12,
   resumed, and its losses ``==`` a clean run's; then (f) reduced xLSTM in
   float32 on the kernels against ``tests/fixtures/
   torch_train_golden_xlstm.npz``, (g) xlstm-350m at full width in the
   same manner (24 / 12 launches of ``ssd_scan`` / ``ssd_wide_bwd`` and of
   ``slstm`` / ``slstm_bwd`` a step; the profiled step in a new process)
   and (h) qwen2-moe-a2.7b at its published widths with the depth cut to
   the first of 3 and 2 layers that fits (attention on
   ``flash_attention`` and its backward at head_dim 128)
16. distributed (after phase 14): two ranks spawned on the card
   (``launch.mesh.spawn``; gloo on CUDA tensors, since NCCL refuses two
   ranks on one device; NCCL where each rank has a card), gloo's CUDA
   probe (``distributed.collectives.probe_gloo_cuda``), then on each rank
   (a) minitron-8b and qwen2-moe-a2.7b served at tp = 2 at full width and
   depth (batch 4, prompt 1024, 32 greedy tokens, bf16; 32 / 24
   ``flash_attention`` launches a prefill on the rank's heads, none in
   decode; the same tokens on both ranks), each then prefilled in float32
   and held within 1e-3 of the largest logit of the one-rank float32
   prefill of the same seeded weights; (b) minitron-8b at its published
   widths cut to 2 layers trained at tp = 2 (every leaf's gradient
   nonzero and finite; the first step's loss within ``DIST_LOSS_REL`` and
   each leaf's gradient norm within ``DIST_LEAF_REL`` of a one-rank
   ``loss_and_grads`` on the same weights, which rank 0 runs after both
   ranks free theirs; three AdamW steps on one batch, losses finite and
   falling); (c) xlstm-350m at full width and depth at dp = 2 with ZeRO-1
   (batch 4 x 1024, three AdamW steps on one batch: each loss within
   ``DIST_LOSS_REL`` and the first grad norm within ``DIST_GNORM_REL`` of
   the one-rank run's, and the loss falling by at least ten times
   ``DIST_LOSS_REL``, so that parameters that do not move, or gradients
   not averaged over the ranks, fail); (d) ``compressed_psum`` of a seeded 2^20-element vector (within
   0.02 of the exact sum, each element within one quantisation step of the
   same call on CPU tensors).  Per rank and part: wall, prefill s, decode
   tokens/s, peak GiB, collectives (calls, bytes, and those staged through
   the host) a prefill, a decode step and a train step; two ranks on one
   card are correctness runs, not scaling figures
17. dry-run tools (after phase 16): the hill-climb's three baseline cells
   (qwen2.5-32b and arctic-480b ``train_4k``, minitron-8b ``decode_32k``),
   minitron-8b ``prefill_32k`` and zamba2-2.7b ``long_500k``, rank 0 of
   the 16x16 mesh traced on ``meta`` over a fake world
   (``launch.dryrun.run_cell``): cost, collectives by group, the roofline
   terms at the H100's figures and the bottleneck, analytic and traced
   memory, trace time; xlstm-350m's ``decode_32k``, ``prefill_32k`` and
   ``long_500k`` on a 1 x 1 mesh, each traced, then run on the card at
   its own shapes with seeded weights where it fits (time, CUDA events,
   median of 3; peak memory; ``slstm`` launches a call) beside its
   roofline time, analytic total and traced peak, else reported as not
   fitting; phase 14's two full-width training steps traced on ``meta``:
   dot FLOPs with the recompute, ``hfu`` and ``mfu`` at phase 14's step
   times.  ``python3 chip_smoke.py --dryrun-phase`` runs it alone
   (training both models itself)
18. sequence parallelism, the model-major experts and gradients through a
   KV-cache mask: (a) two ranks on the card at model = 2 (gloo):
   qwen2.5-32b at its published widths, depth cut (trained at
   ``SP_TRAIN_LAYERS``, served in float32 at ``SP_SERVE_LAYERS``), batch
   4 x 1 024, a train step and a prefill with and without Megatron-SP, the
   SP run held to the other (first loss, grad norm, logits, and the
   summed gradients of the leaves not sharded over 'model' within
   ``SP_LEAF_REL``), and
   minitron-8b (``SP_DECODE_LAYERS`` layers) greedy decode with SP giving
   the tokens without it; (b) arctic-480b at its published widths, 1
   layer, bf16 prefill in the default and the model-major expert layout,
   held to each other (``MM_LOGIT_REL``), each rank's peak memory; (c)
   ``flash_attention_bwd`` under a cache mask (``q_offset`` 768, Sq 256,
   Skv 1 024, ``kv_len`` 900) at zamba2's and qwen2.5-32b's head shapes,
   bf16 and float32, against ``attention_bwd_plain``; its time, bound and
   the backward of ``F.scaled_dot_product_attention`` under the same
   boolean mask; then ``attn_apply`` with a cache at qwen2.5-32b's widths
   differentiated through the kernels (one launch of each), held to the
   plain path.  ``python3 chip_smoke.py --seq-parallel-phase`` runs it
   alone
8. summary: the script's wall time to here and phase 17's, a JSON line
   of the portfolio, multimodel, serving, sync witness, VLM, training,
   distributed and dry-run numbers,
   then one of per-kernel numbers (``launches_by_path`` includes the
   online, portfolio, realized, served, VLM and trained runs and phase
   16's rank 0 and phase 17's card runs; ``shapes``
   the new models' kernel shapes of phase 2e and the VLM's self and cross
   calls of phase 15; the backward kernels' launches, and xLSTM's three
   kernels', are those of the three timed full-width steps of zamba2 and
   of xlstm-350m)
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
import math
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
# phase 16's shapes of a rank: the attention of a tensor-parallel rank at
# tp = 2 (half the query and KV heads; minitron-8b's 16 over 4 is also its
# tp = 2 training shape), the mLSTM scan of a data-parallel rank at dp = 2
# (two of the batch's four rows); and phase 18's: qwen2.5-32b's 20 query
# heads over 4 KV heads (its tp = 2 serving and training shape, bf16 and
# float32, with and without SP) and arctic-480b's 28 over 4 (a GQA group
# of 7, its tp = 2 prefill in both expert layouts)
ATTN_TP2 = {"qwen2-moe-a2.7b": (4, 1024, 8, 8, 128),
            "minitron-8b": (4, 1024, 16, 4, 128),
            "qwen2.5-32b": (4, 1024, 20, 4, 128),
            "arctic-480b": (4, 1024, 28, 4, 128)}
# phase 18's float32 prefill runs qwen2.5-32b's tp = 2 shape in float32
ATTN_TP2_F32 = ("qwen2.5-32b",)
XLSTM_SSD_DP2 = (2, 1024, 4, 256, 256)
# and the attention of an FSDP rank at data = 2 (phase 16 (e)): qwen2.5-32b's
# 40 query heads over 8 KV heads on two of the batch's four rows, its
# serving and its training shape
ATTN_FSDP = {"qwen2.5-32b": (2, 1024, 40, 8, 128)}
# the models served at full width (phases 11 and 12), batch 4, prompt 1024:
# each kernel's launches per prefill (one per layer of its kind)
NEW_SERVE = {"qwen2-moe-a2.7b": {"flash_attention": 24, "ssd_scan": 0,
                                 "slstm": 0},
             "xlstm-350m": {"flash_attention": 0, "ssd_scan": 12,
                            "slstm": 12}}
# and per decode step (only the sLSTM's recurrence runs a kernel there)
NEW_SERVE_DECODE = {"qwen2-moe-a2.7b": {"flash_attention": 0, "ssd_scan": 0,
                                        "slstm": 0},
                    "xlstm-350m": {"flash_attention": 0, "ssd_scan": 0,
                                   "slstm": 12}}
POD_ARCHS = ("minitron-8b", "qwen2-moe-a2.7b", "xlstm-350m")
POD_LAUNCHES = {"minitron-8b": {"flash_attention": 32, "ssd_scan": 0,
                                "slstm": 0},
                **NEW_SERVE}
PORTFOLIO_GOLDEN = (ROOT / "tests" / "fixtures"
                    / "torch_portfolio_golden.json")
# the realized models whose float32 prefill fits on the card and whose
# kernel shapes the float32 kernels take (xlstm-350m's N = P = 256 is above
# the float32 scan's 128): kernel path against plain path, each routing its
# own tokens, within 1e-3 of the largest logit (phase 6's float32 check)
F32_POD_ARCHS = ("minitron-8b", "qwen2-moe-a2.7b")
PROFILER_TRIES = 4              # profiler sessions before giving up
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
    call)``.  The profiler sometimes returns a session without device
    events, or one that lost some (a part counted a fractional number of
    times a call): such a session is taken again, up to
    ``PROFILER_TRIES`` sessions.  ``(None, [])`` (not measured) when none
    recorded every event, rather than an undercount."""
    for _ in range(PROFILER_TRIES):
        ms, parts = _profiled_device_ms(fn, reps)
        if parts and all(float(n).is_integer() for _, n, _ in parts):
            return ms, parts
        if parts:
            print(f"  (profiler session lost device events: "
                  f"{show_parts(parts)})")
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


def device_time_of(run, host_ops: bool = True, top: int = 5
                   ) -> tuple[float, float, list, int]:
    """``(wall s, device-busy s, top kernels, device events)`` of one
    ``run()`` under ``torch.profiler``: the sum of the device's own events
    (kernels, copies, memsets), the ``top`` largest by total time (all
    with ``top=None``), and their number.  The profiler slows the host, so the wall time here is longer
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
    return wall, sum(r[2] for r in rows), rows[:top], sum(r[1] for r in rows)


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


def kernel_err_of_max(out, ref, what: str,
                      dtype: torch.dtype = torch.float32) -> float:
    """``max |out - ref|``; raises unless it is at most ``LM_TOL[dtype]``
    (float32 2e-5, bf16 2e-2) of ``max |ref|``."""
    o, r = out.float(), ref.float()
    check(bool(torch.isfinite(o).all()), f"{what}: output not finite")
    err = (o - r).abs().max().item()
    limit = LM_TOL[dtype] * r.abs().max().item()
    check(err <= limit, f"{what}: max |kernel - plain| = {err}, beyond "
          f"{LM_TOL[dtype]} of max |plain| ({limit})")
    return err


def repeat_bits(fn, got, what):
    """A second call's outputs, held to the first's bits."""
    again = fn()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{what}: a second call on the same inputs gave other bits")


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


def keep_arg(a):
    """A copy of a recorded call's argument (the sLSTM's carry a tuple)."""
    return tuple(t.clone() for t in a) if isinstance(a, tuple) else keep(a)


@contextlib.contextmanager
def recording_calls(calls: list):
    """Every ``flash_attention``, ``ssd_scan`` and ``slstm`` call of the
    model layers inside appends ``(name, args, kwargs, out)`` to
    ``calls``, copies of its inputs and its outputs."""
    from repro_torch.models import blocks, layers
    real = {"flash_attention": layers.flash_attention,
            "ssd_scan": layers.ssd_scan, "slstm": blocks.slstm_scan}

    def recorder(name):
        def call(*args, **kwargs):
            out = real[name](*args, **kwargs)
            calls.append((name, tuple(keep_arg(a) for a in args),
                          dict(kwargs),
                          tuple(o.clone() for o in outputs(out))))
            return out
        return call

    layers.flash_attention = recorder("flash_attention")
    layers.ssd_scan = recorder("ssd_scan")
    blocks.slstm_scan = recorder("slstm")
    try:
        yield
    finally:
        layers.flash_attention = real["flash_attention"]
        layers.ssd_scan = real["ssd_scan"]
        blocks.slstm_scan = real["slstm"]


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
    """A kernel call's outputs as a flat tuple (``ssd_scan`` with
    ``norm=True`` returns the scan and its normaliser, ``slstm`` ys and
    the carry)."""
    if not isinstance(out, tuple):
        return (out,)
    return tuple(t for o in out for t in outputs(o))


def check_calls(calls: list) -> dict:
    """Each recorded call's outputs against its kernel's plain version on
    the same inputs, elementwise at the bf16 tolerance (``kernel_err``);
    per kernel the calls, the largest difference and the least share of
    outputs equal to the plain version's."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.slstm import slstm_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    plain = {"flash_attention": attention_plain, "ssd_scan": ssd_scan_plain,
             "slstm": slstm_scan_plain}
    seen = {}
    for name, args, kwargs, outs in calls:
        refs = outputs(plain[name](*args, **kwargs))
        n, err, same = seen.get(name, (0, 0.0, 1.0))
        for out, ref in zip(outs, refs):
            # the sLSTM's float32 carry is as exact as its bf16 ys, and
            # only the bf16 outputs count toward the bit-equal share
            err = max(err, kernel_err(
                out, ref, outs[0].dtype, f"{name}, call {n} of the bf16 "
                "prefill"))
            if out.dtype == outs[0].dtype:
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
    """The model layers take the named kernels' plain versions inside, and
    the sLSTM's plain loop always (on the card: the comparison prefills of
    phases 6, 11 and 12).  With ``perturb``, every plain output has that
    share of its entries moved one ulp (``ulp_flips``): the plain path
    with as many last-bit differences as the kernels leave, at random
    places, a witness of how far the model itself carries such
    differences (the sLSTM's ys only: its carry stays as computed)."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.slstm import slstm_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.models import blocks, layers
    real = layers.flash_attention, layers.ssd_scan, blocks.slstm_scan
    gen = torch.Generator(device="cuda").manual_seed(0)

    def perturbed(fn):
        if not perturb:
            return fn

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            outs = tuple(ulp_flips(o, perturb, gen) for o in outputs(out))
            return outs if isinstance(out, tuple) else outs[0]
        return call

    def plain_slstm(gx, r, carry):
        ys, carry = slstm_scan_plain(gx, r, carry)
        if perturb:
            ys = ulp_flips(ys, perturb, gen)
        return ys, carry

    layers.flash_attention = perturbed(attention_plain) if flash \
        else real[0]
    layers.ssd_scan = perturbed(ssd_scan_plain) if ssd else real[1]
    blocks.slstm_scan = plain_slstm
    try:
        yield
    finally:
        layers.flash_attention, layers.ssd_scan, blocks.slstm_scan = real


def new_shapes_phase(g, dev, smi) -> dict:
    """Phase 2e: the kernels at the new models' shapes, random inputs:
    ``ssd_scan`` at xlstm-350m's mLSTM widths with its normaliser in the
    same launch, ``flash_attention`` at head_dim 128 (qwen2-moe-a2.7b's MHA,
    minitron-8b's GQA; the tensor-parallel ranks' shapes of phases 16
    and 18, qwen2.5-32b's also in float32, and the FSDP rank's).  Each
    bf16 output within 2e-2 of the largest plain output, float32
    elementwise within 2e-5; times, bounds and, for attention, SDPA on
    the same inputs."""
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
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
    for arch, (B, S, Hq, Hkv, D) in ATTN_D128.items():
        q = randn((B, S, Hq, D), g, bf, dev)
        k = randn((B, S, Hkv, D), g, bf, dev)
        v = randn((B, S, Hkv, D), g, bf, dev)
        out = flash_attention(q, k, v, causal=True)
        ref = attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = of_max(out, ref, f"flash_attention at {arch}'s shape")
        print(f"flash_attention {arch}: max |kernel - plain| {err!r} "
              "(within 2e-2 of max |plain|)")
        rec["flash_attention"][arch] = {
            "max_abs_err": err, **flash_call_record(
                q, k, v, {"causal": True}, profiled_device_ms(
                    lambda: flash_attention(q, k, v, causal=True)),
                smi, f"{arch}'s shape")}
        del q, k, v, out, ref
    rec["flash_attention_tp2"] = {}
    for arch, (B, S, Hq, Hkv, D) in ATTN_TP2.items():
        q = randn((B, S, Hq, D), g, bf, dev)
        k = randn((B, S, Hkv, D), g, bf, dev)
        v = randn((B, S, Hkv, D), g, bf, dev)
        out = flash_attention(q, k, v, causal=True)
        ref = attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = of_max(out, ref, f"flash_attention at {arch}'s tp = 2 shape")
        rec["flash_attention_tp2"][arch] = {"shape": [B, S, Hq, Hkv, D],
                                            "max_abs_err": err}
        print(f"flash_attention {arch} at a tp = 2 rank's heads "
              f"q {(B, S, Hq, D)} over {Hkv} KV heads: max |kernel - "
              f"plain| {err!r} (within 2e-2 of max |plain|)")
        del q, k, v, out, ref
        if arch not in ATTN_TP2_F32:
            continue
        f32 = torch.float32
        q, k, v = (randn((B, S, h, D), g, f32, dev) for h in (Hq, Hkv, Hkv))
        out = flash_attention(q, k, v, causal=True)
        ref = attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = kernel_err(out, ref, f32, f"flash_attention at {arch}'s tp = "
                         "2 shape, float32")
        rec["flash_attention_tp2"][arch]["max_abs_err_float32"] = err
        print(f"flash_attention {arch} at a tp = 2 rank's heads, float32: "
              f"max |kernel - plain| {err!r} (rtol = atol = 2e-5)")
        del q, k, v, out, ref
    rec["flash_attention_fsdp"] = {}
    for arch, (B, S, Hq, Hkv, D) in ATTN_FSDP.items():
        q = randn((B, S, Hq, D), g, bf, dev)
        k = randn((B, S, Hkv, D), g, bf, dev)
        v = randn((B, S, Hkv, D), g, bf, dev)
        out = flash_attention(q, k, v, causal=True)
        ref = attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = of_max(out, ref, f"flash_attention at {arch}'s data = 2 shape")
        print(f"flash_attention {arch} at a data = 2 rank's rows q "
              f"{(B, S, Hq, D)} over {Hkv} KV heads: max |kernel - plain| "
              f"{err!r} (within 2e-2 of max |plain|)")
        rec["flash_attention_fsdp"][arch] = {
            "shape": [B, S, Hq, Hkv, D], "max_abs_err": err,
            **flash_call_record(q, k, v, {"causal": True},
                                profiled_device_ms(lambda: flash_attention(
                                    q, k, v, causal=True)),
                                smi, f"{arch}'s data = 2 shape")}
        del q, k, v, out, ref
    B, L, H, N, P = XLSTM_SSD_DP2
    rec["ssd_scan_dp2"] = {}
    for kind in ("", "views"):
        q, k, v, a, _, _ = wide_bwd_inputs(g, dev, B, L, H, N, P, False, bf,
                                           kind)
        num, den = ssd_scan(q, k, v, a, chunk=256, norm=True)
        p_num, p_den = ssd_scan_plain(q, k, v, a, chunk=256, norm=True)
        torch.cuda.synchronize()
        what = f"ssd_scan at a dp = 2 rank's batch {(B, L, H, N, P)}" + (
            f" ({kind})" if kind else "")
        err = max(of_max(num, p_num, what),
                  of_max(den, p_den, f"{what}, the normaliser"))
        rec["ssd_scan_dp2"][kind or "contiguous"] = err
        print(f"{what}, chunk 256, with the normaliser: max |kernel - "
              f"plain| {err!r} (output and normaliser, each within 2e-2 of "
              "max |plain|)")
        del q, k, v, a, num, den, p_num, p_den
    torch.cuda.empty_cache()
    return rec


# xLSTM's kernels (phase 2f): ssd_wide_bwd cases (B, L, H, N, P, chunk,
# normaliser, bf16?, inputs: "" the mLSTM's, "slow" its slow decay a =
# -0.01 U[0, 1), "views" q, k and v as column slices of one projection and
# dO head-major) and slstm cases (B, L, H, dh, bf16?); the last of each is
# xlstm-350m's training shape (its mLSTM's scan with the normaliser; its
# sLSTM over batch 4 x 1024), the L = 1 cases are decode steps (B = 1 and
# 128: xlstm-350m's long_500k and decode_32k steps, phase 17), 9 batch rows
# take two clusters a head, 8 and 16 rows one and two full tiles of the
# tensor-core product's N = 8, dh 128 a cluster of 4, dh 20 (float32) a
# unit tile cut at dh and L = 40 a stream stage cut at L, and xlstm-350m's
# shape also in float32, "views" gx a column slice of a wider projection
# (strides the kernel's TMA reads as they are); N and P of 48 and 80 are
# multiples of 16 but
# not of the bf16 kernels' 64-column boxes; the B = 2 cases are a dp = 2
# rank's half of xlstm-350m's training batch (phase 16)
WIDE_BWD_CASES = ((1, 64, 2, 16, 16, 16, True, False, ""),
                  (2, 256, 3, 128, 96, 128, True, False, ""),
                  (1, 512, 2, 128, 64, 256, False, True, ""),
                  (2, 256, 3, 256, 256, 256, True, True, ""),
                  (2, 256, 3, 48, 80, 128, True, True, ""),
                  (2, 1024, 4, 256, 256, 256, True, True, "views"),
                  (2, 1024, 4, 256, 256, 256, True, True, ""),
                  (4, 1024, 4, 256, 256, 256, True, True, "slow"),
                  (4, 1024, 4, 256, 256, 256, True, True, "views"),
                  (4, 1024, 4, 256, 256, 256, True, True, ""))
SLSTM_CASES = ((2, 16, 4, 16, False), (3, 64, 2, 256, False),
               (9, 32, 2, 64, True), (4, 1, 4, 256, True),
               (1, 1, 4, 256, True), (128, 1, 4, 256, True),
               (8, 64, 2, 256, True), (16, 48, 2, 256, True),
               (4, 96, 4, 128, True), (2, 40, 2, 20, False),
               (4, 64, 4, 256, True, "views"),
               (4, 1024, 4, 256, False), (2, 1024, 4, 256, True),
               (4, 1024, 4, 256, True))
# The bf16 cell's carries against the plain version's at float32's
# tolerance (LM_TOL[float32] of the largest plain entry): at r = 0 h r is
# exactly 0 and the gate inputs are gx itself, so c, n and m after every
# position depend on the cell alone (xlstm-350m's shape)
SLSTM_CELL_CASE = (4, 1024, 4, 256)
PROFILE_XLSTM_ARG = "--profile-xlstm-kernels"


def of_largest(got, ref, dtype, what: str) -> float:
    """``max |got - ref|`` over a tuple of outputs, each of the plain
    version's type and shape and within ``LM_TOL[dtype]`` of its largest
    plain entry (``kernel_err_of_max``)."""
    for i, (o, r) in enumerate(zip(got, ref)):
        check(o.shape == r.shape and o.dtype == r.dtype,
              f"{what} output {i}: {o.dtype} {tuple(o.shape)}, plain "
              f"{r.dtype} {tuple(r.shape)}")
    return max(kernel_err_of_max(o, r, f"{what} output {i}", dtype)
               for i, (o, r) in enumerate(zip(got, ref)))


def wide_bwd_inputs(g, dev, B, L, H, N, P, norm, dt, kind=""):
    """The mLSTM's scan inputs (q / sqrt(P), log sigmoid forget gates, or
    with ``kind`` "slow" a = -0.01 U[0, 1)) and random output gradients;
    with "views" q, k and v are column slices of one [B, L, H, 2 N + P]
    projection and dO is head-major ([B, H, L, P] transposed)."""
    q = randn((B, L, H, N), g, dt, dev) / math.sqrt(P)
    k, v = randn((B, L, H, N), g, dt, dev), randn((B, L, H, P), g, dt, dev)
    if kind == "slow":
        a = -0.01 * torch.rand((B, L, H), generator=g, device=dev)
    else:
        a = -torch.nn.functional.softplus(-randn((B, L, H), g,
                                                 torch.float32, dev))
    do = randn((B, L, H, P), g, dt, dev)
    dden = randn((B, L, H), g, dt, dev) if norm else None
    if kind == "views":
        proj = torch.cat([q, k, v], dim=-1)
        q, k, v = proj[..., :N], proj[..., N:2 * N], proj[..., 2 * N:]
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
    return q, k, v, a, do, dden


def slstm_inputs(g, dev, B, L, H, dh, dt, kind=""):
    """sLSTM inputs as the model makes them (r / sqrt(dh), a carry from
    earlier positions) and random gradients of ys and of the carry out;
    with ``kind`` "views" gx is columns [64, 64 + 4 dh) of a [B, L, H,
    4 dh + 128] projection."""
    if kind == "views":
        gx = randn((B, L, H, 4 * dh + 128), g, dt, dev)[..., 64:64 + 4 * dh]
    else:
        gx = randn((B, L, H, 4 * dh), g, dt, dev)
    r = (randn((H, dh, 4 * dh), g, torch.float32, dev)
         / math.sqrt(dh)).to(dt)
    f32 = torch.float32
    carry = (randn((B, H, dh), g, f32, dev),
             randn((B, H, dh), g, f32, dev).abs() + 0.5,
             randn((B, H, dh), g, dt, dev), randn((B, H, dh), g, f32, dev))
    dys = randn((B, L, H, dh), g, dt, dev)
    dcarry = (randn((B, H, dh), g, f32, dev), randn((B, H, dh), g, f32, dev),
              randn((B, H, dh), g, dt, dev), randn((B, H, dh), g, f32, dev))
    return gx, r, carry, dys, dcarry


def slstm_bound_ms(gx, backward: bool) -> tuple[float, str]:
    """The sLSTM recurrence's least time, forward (gx and r read, ys
    written, the carry read and written; the gate products, 2 B L H dh
    4 dh FLOP) or the backward call (the saved gate inputs, c, n, m, ys
    and dys read, dgx, dr and the carry's gradients written; dg r^T and
    the dr product, twice the forward's FLOP), at the peak rate of gx's
    type."""
    B, L, H, four_dh = gx.shape
    dh, es = four_dh // 4, gx.element_size()
    carry = B * H * dh * (12 + es)
    if backward:
        nbytes = (es * (2 * B * L * H * four_dh + 2 * B * L * H * dh
                        + 2 * H * dh * four_dh) + 12 * B * L * H * dh
                  + 2 * carry)
    else:
        nbytes = (es * (B * L * H * four_dh + B * L * H * dh
                        + H * dh * four_dh) + 2 * carry)
    flops = (4 if backward else 2) * B * L * H * dh * four_dh
    peak = BF16_FLOP_PER_S if gx.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_xlstm_kernels() -> None:
    """The child of ``device_ms_in_child(PROFILE_XLSTM_ARG)``: seeded
    inputs at xlstm-350m's training shapes, the three kernels' profiled
    device times as JSON."""
    from repro_torch.kernels.slstm import slstm_scan, slstm_scan_bwd
    from repro_torch.kernels.ssd_scan import ssd_wide_bwd
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    B, L, H, N, P, c, norm, _, _ = WIDE_BWD_CASES[-1]
    q, k, v, a, do, dden = wide_bwd_inputs(g, dev, B, L, H, N, P, norm, bf)
    out = {"ssd_wide_bwd": profiled_device_ms(
        lambda: ssd_wide_bwd(q, k, v, a, do, chunk=c, dden=dden), reps=10)}
    del q, k, v, a, do, dden
    B, L, H, dh, _ = SLSTM_CASES[-1]
    gx, r, carry, dys, dcarry = slstm_inputs(g, dev, B, L, H, dh, bf)
    out["slstm"] = profiled_device_ms(lambda: slstm_scan(gx, r, carry),
                                      reps=10)
    ys, _, saved = slstm_scan(gx, r, carry, save=True)
    out["slstm_bwd"] = profiled_device_ms(
        lambda: slstm_scan_bwd(saved[0], r, carry, saved[1:], ys, dys,
                               dcarry), reps=10)
    print(json.dumps(out))


def slstm_cell_check(g, dev) -> dict:
    """``SLSTM_CELL_CASE`` in bf16 at r = 0: the forward's saved c, n, m of
    every position and its carry out, each within ``LM_TOL[float32]`` of
    its largest plain entry; the largest error of each over that entry,
    and the largest elementwise relative error over the entries above 1e-3
    of it."""
    from repro_torch.kernels.slstm import slstm_scan, slstm_scan_plain
    B, L, H, dh = SLSTM_CELL_CASE
    bf, f32 = torch.bfloat16, torch.float32
    gx = randn((B, L, H, 4 * dh), g, bf, dev)
    r = torch.zeros((H, dh, 4 * dh), dtype=bf, device=dev)
    carry = (randn((B, H, dh), g, f32, dev),
             randn((B, H, dh), g, f32, dev).abs() + 0.5,
             randn((B, H, dh), g, bf, dev), randn((B, H, dh), g, f32, dev))
    _, c1, saved = slstm_scan(gx, r, carry, save=True)
    _, p_c1, p_saved = slstm_scan_plain(gx, r, carry, save=True)
    out = {}
    pairs = [(w, saved[i], p_saved[i]) for i, w in ((1, "c"), (2, "n"),
                                                     (3, "m"))]
    pairs += [(w, c1[i], p_c1[i]) for i, w in ((0, "c'"), (1, "n'"),
                                               (3, "m'"))]
    for name, k, p in pairs:
        what = f"slstm cell {SLSTM_CELL_CASE} bf16 r = 0, {name}"
        err = kernel_err_of_max(k, p, what, f32)
        big = p.abs().max()
        keep = p.abs() > 1e-3 * big
        out[name] = {"of_largest": err / big.item(), "elementwise": (
            (k - p).abs()[keep] / p.abs()[keep]).max().item()}
    print(f"slstm cell {SLSTM_CELL_CASE} bf16 at r = 0 (the cell alone), "
          f"the carries of every position against the plain version's, "
          f"each within {LM_TOL[f32]} of its largest plain entry: {out}")
    return out


def xlstm_kernels_phase(g, dev, smi) -> dict:
    """Phase 2f: xLSTM's training kernels against their plain versions
    over the sweeps (each call repeated and held to the same bits), then
    their times at xlstm-350m's training shapes beside the bound and the
    plain version, each kernel's device time profiled in a new process.
    No single PyTorch call computes any of the three."""
    from repro_torch.kernels.slstm import (slstm_scan, slstm_scan_bwd,
                                           slstm_scan_bwd_plain,
                                           slstm_scan_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain, ssd_wide_bwd

    rec = {}
    for B, L, H, N, P, c, norm, bf, kind in WIDE_BWD_CASES:
        dt = torch.bfloat16 if bf else torch.float32
        q, k, v, a, do, dden = wide_bwd_inputs(g, dev, B, L, H, N, P, norm,
                                               dt, kind)
        what = (f"ssd_wide_bwd {(B, L, H, N, P, c)} norm={norm} {dt}"
                + (f" ({kind})" if kind else ""))

        def call():
            return ssd_wide_bwd(q, k, v, a, do, chunk=c, dden=dden)
        got = call()
        ref = ssd_scan_bwd_plain(q, k, v, a, do, chunk=c, dden=dden)
        err = of_largest(got, ref, dt, what)
        repeat_bits(call, got, what)
        print(f"{what}: max |kernel - plain| {err!r} (dq, dk, dv, da each "
              f"within {LM_TOL[dt]} of its largest plain entry), a second "
              "call the same bits")
    rec["ssd_wide_bwd"] = {"max_abs_err": err}
    b_ms, b_by = ssd_bwd_bound_ms(q, k, v, c, norm)
    rec["ssd_wide_bwd"].update(
        ms=cuda_ms(call), plain_ms=cuda_ms(lambda: ssd_scan_bwd_plain(
            q, k, v, a, do, chunk=c, dden=dden), reps=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del q, k, v, a, do, dden, got, ref
    from repro_torch.kernels.slstm.kernel import _tma_ready
    for B, L, H, dh, bf, *kind in SLSTM_CASES:
        dt = torch.bfloat16 if bf else torch.float32
        kind = kind[0] if kind else ""
        gx, r, carry, dys, dcarry = slstm_inputs(g, dev, B, L, H, dh, dt,
                                                 kind)
        what = f"slstm {(B, L, H, dh)} {dt}" + (f" ({kind})" if kind else "")
        check(kind != "views" or (not gx.is_contiguous()
                                  and _tma_ready(gx) is gx),
              f"{what}: gx is not a strided view that TMA reads as it is")

        def fwd():
            ys, c1, saved = slstm_scan(gx, r, carry, save=True)
            return (ys, *c1, *saved)
        got = fwd()
        ys, saved = got[0], got[5:]
        p_ys, p_c1 = slstm_scan_plain(gx, r, carry)
        err_f = of_largest(got[:5], (p_ys, *p_c1), dt, what)
        repeat_bits(fwd, got, what)
        if kind == "views":             # the same bits from a copy of gx
            ys2, c2, s2 = slstm_scan(gx.contiguous(), r, carry, save=True)
            check(all(torch.equal(x, y) for x, y in zip(got, (
                ys2, *c2, *s2))), f"{what}: other bits than from a "
                  "contiguous gx")

        def bwd(fn=slstm_scan_bwd):
            dgx, dr, dc = fn(saved[0], r, carry, saved[1:], ys, dys, dcarry)
            return (dgx, dr, *dc)
        got = bwd()
        err_b = of_largest(got, bwd(slstm_scan_bwd_plain), dt,
                           f"{what} backward")
        repeat_bits(bwd, got, f"{what} backward")
        print(f"{what}: forward (ys, c, n, h, m) max |kernel - plain| "
              f"{err_f!r}, backward (dgx, dr, dc, dn, dh, dm, both fed the "
              f"kernel's saved values) {err_b!r}, each within {LM_TOL[dt]} "
              "of its largest plain entry; a second call of each the same "
              "bits")
    rec["slstm"] = {"max_abs_err": err_f}
    rec["slstm_bwd"] = {"max_abs_err": err_b}
    rec["slstm"]["cell_f32_err"] = slstm_cell_check(g, dev)
    for name, fn, plain, back in (
            ("slstm", lambda: slstm_scan(gx, r, carry),
             lambda: slstm_scan_plain(gx, r, carry), False),
            ("slstm_bwd", bwd, lambda: bwd(slstm_scan_bwd_plain), True)):
        b_ms, b_by = slstm_bound_ms(gx, back)
        rec[name].update(ms=cuda_ms(fn), plain_ms=cuda_ms(plain, reps=3),
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del gx, r, carry, dys, dcarry, ys, saved, got, p_ys, p_c1
    torch.cuda.empty_cache()
    dev_ms = device_ms_in_child(PROFILE_XLSTM_ARG)
    shapes = {"ssd_wide_bwd": "q, k, v, dO [4, 1024, 4, 256] bf16, chunk "
              "256, the normaliser",
              "slstm": "gx [4, 1024, 4, 1024] bf16, r [4, 256, 1024]",
              "slstm_bwd": "gx [4, 1024, 4, 1024] bf16, r [4, 256, 1024], "
              "the kernel and the dr product"}
    for name, r_ in rec.items():
        r_["device_ms"], r_["parts"] = dev_ms[name]
        print(f"{name} at xlstm-350m's training shape ({shapes[name]}): per "
              f"call (CUDA events, median) kernel {r_['ms']:.6f} ms, plain "
              f"{r_['plain_ms']:.6f} ms; device time (profiler, a new "
              f"process) {r_['device_ms']!r} ms [{show_parts(r_['parts'])}]"
              f"; bound {r_['bound_ms']:.6f} ms ({r_['bound_by']}); no "
              f"library call computes it; on {smi}")
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
    """Greedy prefill + ``gen - 1`` decode steps: tokens [B, gen] and each
    step's logits [gen, B, vocab] (float32)."""
    from repro_torch.models import decode_step, prefill
    S = batch["tokens"].shape[1]
    logits, cache = prefill(cfg, dims, params, batch, S + gen)
    toks, seen = [logits.argmax(-1)[:, None]], [logits.float()]
    for i in range(gen - 1):
        logits, cache = decode_step(cfg, dims, params, toks[-1], cache,
                                    S + i, cross_ctx=batch.get("cross_ctx"))
        toks.append(logits.argmax(-1)[:, None])
        seen.append(logits.float())
    return torch.cat(toks, 1), torch.stack(seen)


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
    from repro_torch.kernels.slstm import slstm_scan
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
    slstm_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last_k, cache = prefill_fn()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches,
                "slstm": slstm_scan.launches}
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


@contextlib.contextmanager
def launches_by_step(kernels: dict, seen: dict):
    """``serve.main`` inside records each kernel's launches in its prefill
    (``seen["prefill"]``) and in each decode step (``seen["decode"]``, one
    dict a step): every count is set to 0 before the step and read after
    it, on the host, where the wrappers count."""
    from repro_torch.launch import serve
    real = serve.make_prefill_step, serve.make_decode_step

    def counted(make, record):
        def maker(*args, **kwargs):
            step = make(*args, **kwargs)

            def call(*a, **kw):
                for fn in kernels.values():
                    fn.launches = 0
                res = step(*a, **kw)
                record({k: fn.launches for k, fn in kernels.items()})
                return res
            return call
        return maker

    seen["decode"] = []
    serve.make_prefill_step = counted(
        real[0], lambda n: seen.__setitem__("prefill", n))
    serve.make_decode_step = counted(real[1], seen["decode"].append)
    try:
        yield
    finally:
        serve.make_prefill_step, serve.make_decode_step = real


def serve_phase(dev, smi) -> dict:
    """Phase 12: ``serve.main`` on qwen2-moe-a2.7b and xlstm-350m at full
    width (batch 4, prompt 1024, 32 greedy tokens, bf16): prefill time,
    decode tokens/s, peak memory, launches (counted in the prefill and in
    each decode step on its own), one profiled prefill's device busy
    share, and, printed, the greedy tokens beside a run with the kernels'
    plain versions on the same weights and prompt (phase 11 holds these
    models' logits)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.slstm import slstm_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import ModelDims, get_arch, init_params, prefill
    from repro_torch.models.testing import synth_batch
    kernels = {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
               "slstm": slstm_scan}
    out = {}
    for arch, want in NEW_SERVE.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seen = {}
        with launches_by_step(kernels, seen):
            res = serve.main(["--arch", arch, "--batch", "4",
                              "--prompt-len", "1024", "--gen", "32"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_prefill, steps = seen["prefill"], seen["decode"]
        check(per_prefill == want, f"serve {arch} launched {per_prefill} in "
              f"its prefill, want {want}: one per layer of the kernel's kind")
        want_step = NEW_SERVE_DECODE[arch]
        odd = [(i, n) for i, n in enumerate(steps) if n != want_step]
        check(len(steps) == 31 and not odd, f"serve {arch} ran {len(steps)} "
              f"decode steps, want 31, each launching {want_step}; the "
              f"steps that did not: {odd}")
        per_step = steps[0]
        launches = {k: per_prefill[k] + sum(n[k] for n in steps)
                    for k in kernels}
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
                plain, _ = greedy_tokens(cfg, dims, params, batch, 32)
        del params
        torch.cuda.empty_cache()
        parted = [None if bool((tokens[r] == plain[r]).all())
                  else int((tokens[r] != plain[r]).nonzero()[0, 0])
                  for r in range(tokens.shape[0])]
        dec_tok_s = 4 * 31 / res["decode_s"]
        out[arch] = {"prefill_s": res["prefill_s"],
                     "decode_s": res["decode_s"],
                     "decode_tok_s": dec_tok_s, "peak_gib": peak,
                     "launches_per_prefill": per_prefill,
                     "launches_per_decode_step": per_step,
                     "launches_32_tokens": launches,
                     "profiled_prefill_wall_s": wall,
                     "device_busy_s": busy,
                     "device_idle_share": 1 - busy / wall,
                     "device_events": n,
                     "first_step_parting_plain": parted}
        print(f"serve {arch} (batch 4, prompt 1024, 32 tokens, bf16): "
              f"prefill {res['prefill_s'] * 1e3:.3f} ms, decode "
              f"{res['decode_s'] * 1e3:.3f} ms = {dec_tok_s:.1f} tokens/s, "
              f"peak {peak:.3f} GiB, launches per prefill {per_prefill}, per "
              f"decode step {per_step} (all 32 tokens: {launches}); "
              f"profiled prefill: wall {wall:.4f} s, device "
              f"busy {busy:.6f} s (idle {100 * (1 - busy / wall):.2f}%) in "
              f"{n} device events, top:"
              + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top)
              + f"; greedy tokens against the plain versions' run, per row "
              f"the first step where they part (None: all 32 equal): "
              f"{parted}; on {smi}")
    return out


# the VLM (phase 15): llama-3.2-vision-90b at its published widths (d_model
# 8 192, 64 query heads over 8 kv heads, d_ff 28 672, vocab 128 256, a
# context of 4 096 rows) with the depth cut to two super-blocks: 8 attention
# and 2 cross-attention layers, 8.86 B block parameters and 2.10 B of
# embeddings and head (the 100-layer model's 181 GB of bf16 weights fit no
# one card).  Served through serve.main, batch 4, prompt 1024, 32 tokens.
# Every layer runs its causal self-attention and each cross-attention
# layer then attends over the context: 12 flash_attention launches in the
# prefill (10 self, 2 cross), none in decode.
VLM_ARCH = "llama-3.2-vision-90b"
VLM_SUPER_BLOCKS = 2
VLM_GOLDEN = ROOT / "tests" / "fixtures" / "torch_vlm_golden.npz"


@contextlib.contextmanager
def cut_vlm_serving(cfg, seen: dict):
    """``serve.main`` inside serves ``cfg`` whatever ``--arch`` names (the
    driver has no flag for a cut depth), with each cross block's gate
    drawn from U[0.5, 1) by the serve generator (``init_params`` leaves it
    at 0, the reference's initial value, where the branch adds nothing);
    its prefill records in ``seen`` the parameters, batch, cache, last
    logits, launches so far and a copy of every ``cache["cross"]``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models.config import BlockKind
    real = serve.get_arch, serve.init_params, serve.make_prefill_step
    pi = cfg.block_pattern.index(BlockKind.CROSS_ATTN)

    def init(cfg_, dims, generator):
        params = real[1](cfg_, dims, generator=generator)
        for layer in params["layers"]:
            layer[pi]["xgate"] = 0.5 + 0.5 * torch.rand(
                (), generator=generator, device=generator.device)
        return params

    def make_prefill(*args, **kwargs):
        step = real[2](*args, **kwargs)

        def run(params, batch):
            logits, cache = step(params, batch)
            seen.update(params=params, batch=batch, cache=cache,
                        last=logits.float(),
                        prefill_launches=flash_attention.launches,
                        cross=[{k: t.clone() for k, t in
                                layer[pi]["cross"].items()}
                               for layer in cache])
            return logits, cache
        return run

    serve.get_arch = lambda name: cfg
    serve.init_params, serve.make_prefill_step = init, make_prefill
    try:
        yield
    finally:
        serve.get_arch, serve.init_params, serve.make_prefill_step = real


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def flash_call_record(q, k, v, kw, profiled, smi, what) -> dict:
    """One ``flash_attention`` call (``kw`` its keywords) timed: kernel
    (CUDA events; ``profiled`` its profiler device time and parts), plain
    version, the bound, and ``F.scaled_dot_product_attention``
    (``enable_gqa``) on the same inputs (the kv rows the mask lets
    through)."""
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import kernel as flash_mod
    sdpa = torch.nn.functional.scaled_dot_product_attention
    causal = kw["causal"]
    kv_len = kw.get("kv_len") or k.shape[1]
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, **kw), reps=5)
    dev_ms, parts = profiled
    b_ms, b_by = flash_bound_ms(q, k, causal, kw.get("q_offset", 0), kv_len)
    smem = flash_mod._lib().flash_attention_smem_bytes(
        q.shape[-1], flash_mod._DTYPES[q.dtype])
    lq, lk, lv = (t.transpose(1, 2) for t in (q, k[:, :kv_len],
                                                 v[:, :kv_len]))
    lib_ms = cuda_ms(lambda: sdpa(lq, lk, lv, is_causal=causal,
                                  enable_gqa=True))
    print(f"flash_attention {what}: q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)} (kv_len {kv_len}) {q.dtype}, causal {causal}: "
          f"per call (CUDA events, median): kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, F.scaled_dot_product_attention (enable_gqa) "
          f"{lib_ms:.6f} ms; kernel device time (profiler) {dev_ms!r} ms "
          f"[{show_parts(parts)}]; bound {b_ms:.6f} ms ({b_by}); {smem} B "
          f"of dynamic shared memory a CTA; on {smi}")
    return {"q": list(q.shape), "kv": list(k.shape), "causal": causal,
            "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def profile_vlm_attention() -> None:
    """The child of ``device_ms_in_child(PROFILE_VLM_ARG)``: seeded bf16
    inputs at the shapes of phase 15's two ``flash_attention`` calls
    (``self``: the prefill's 1 024 queries over a 1 056-row cache, causal,
    ``kv_len`` 1 024; ``cross``: over the 4 096-row context), the
    profiled device times as JSON."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import get_arch
    cfg = get_arch(VLM_ARCH)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, hd = 4, 1024, cfg.hd
    q = randn((B, S, cfg.n_heads, hd), g, torch.bfloat16, "cuda")
    out = {}
    for name, rows, kw in (("self", S + 32, {"causal": True, "kv_len": S}),
                           ("cross", cfg.cross_ctx_len, {"causal": False})):
        k, v = (randn((B, rows, cfg.n_kv_heads, hd), g, torch.bfloat16,
                      "cuda") for _ in range(2))
        out[name] = profiled_device_ms(
            lambda: flash_attention(q, k, v, **kw), reps=10)
    print(json.dumps(out))


def vlm_phase(dev, smi) -> dict:
    """Phase 15: the cross-attention VLM.  (a) ``serve.main`` on
    llama-3.2-vision-90b at full width, depth cut to ``VLM_SUPER_BLOCKS``
    (batch 4, prompt 1024, 32 greedy tokens, bf16, gates nonzero): a
    ``flash_attention`` launch for each layer's self-attention and one more for
    each cross layer's context in the prefill, none in decode, each call within
    2e-2 of its plain version on its own inputs, the cross cache bit-unchanged
    by decode, the greedy tokens against the plain versions' run (the first as
    phase 6 holds it; a row may part later only where the plain path's logits
    put the kernel path's token below their maximum by no more than the first
    token's largest logit difference or one bf16 step), times of the self- and
    cross-attention calls, prefill and decode times, peak memory and a profiled
    prefill's idle share.  (b) the reduced VLM in float32 on the card against
    ``tests/fixtures/torch_vlm_golden.npz``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import ModelDims, get_arch, prefill
    from repro_torch.models.config import BlockKind
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.testing import (numpy_tree, reduced,
                                            teacher_forced)
    t_phase = time.perf_counter()
    full = get_arch(VLM_ARCH)
    cfg = dataclasses.replace(
        full, n_layers=len(full.block_pattern) * VLM_SUPER_BLOCKS)
    dims = ModelDims.create(cfg)
    n_cross = cfg.n_super_blocks * cfg.block_pattern.count(
        BlockKind.CROSS_ATTN)
    want = cfg.n_layers + n_cross
    seen, calls = {}, []
    torch.cuda.empty_cache()
    flash_attention.launches = 0
    ssd_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with cut_vlm_serving(cfg, seen), recording_calls(calls):
        res = serve.main(["--arch", VLM_ARCH, "--batch", "4", "--prompt-len",
                          "1024", "--gen", "32"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}
    check(seen["prefill_launches"] == want and launches == {
        "flash_attention": want, "ssd_scan": 0},
        f"the cut VLM's prefill launched {seen['prefill_launches']} "
        f"flash_attention, the whole serve run {launches}: want {want} in "
        f"the prefill ({cfg.n_layers} layers' self-attention, {n_cross} "
        "cross) and none in decode")
    T = cfg.cross_ctx_len
    cross_calls = [c for c in calls if c[1][1].shape[1] == T]
    self_calls = [c for c in calls if c[1][1].shape[1] != T]
    check(len(cross_calls) == n_cross
          and not any(c[2]["causal"] for c in cross_calls)
          and len(self_calls) == cfg.n_layers
          and all(c[2]["causal"] for c in self_calls),
          f"the prefill's attention calls: {len(cross_calls)} over the "
          f"{T}-row context (want {n_cross}, non-causal), "
          f"{len(self_calls)} causal self-attention calls (want "
          f"{cfg.n_layers})")
    by_call = check_calls(calls)
    print(f"every flash_attention call of the bf16 prefill ({len(calls)} "
          "layers) against its plain version on its own inputs, "
          f"elementwise within rtol = atol = 2e-2: {by_call}")
    profiled = device_ms_in_child(PROFILE_VLM_ARG)
    rec = {"self": flash_call_record(*self_calls[0][1], self_calls[0][2],
                                     profiled["self"], smi,
                                     "VLM self-attention (group 8)"),
           "cross": flash_call_record(*cross_calls[0][1],
                                      cross_calls[0][2], profiled["cross"],
                                      smi, f"VLM cross-attention ({T}-row "
                                      "context, group 8)")}
    del calls, cross_calls, self_calls
    torch.cuda.empty_cache()
    cache, unchanged = seen.pop("cache"), True
    pi = cfg.block_pattern.index(BlockKind.CROSS_ATTN)
    for layer, before in zip(cache, seen.pop("cross")):
        unchanged &= all(torch.equal(layer[pi]["cross"][k], t)
                         for k, t in before.items())
    check(unchanged, "decode changed a cross-attention cache entry")
    del cache
    tokens = res["tokens"]
    check(tuple(tokens.shape) == (4, 32) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab)).all()),
        f"serve returned tokens {tuple(tokens.shape)}")
    params, batch = seen.pop("params"), seen.pop("batch")
    check(torch.equal(seen["last"].argmax(-1), tokens[:, 0]),
          "the serve run's first tokens are not its prefill's argmax")
    with torch.inference_mode():
        wall, busy, top, n = device_time_of(
            lambda: prefill(cfg, dims, params, batch, 1056), host_ops=False)
        with plain_kernels():
            plain, plain_logits = greedy_tokens(cfg, dims, params, batch, 32)
    del params
    torch.cuda.empty_cache()
    first = logit_agreement(seen.pop("last"), plain_logits[0])
    check(first["top1_or_exact_tie"] == 1.0,
          "VLM prefill: the kernels and the plain versions pick different "
          f"first tokens in a row without an exact tie: {first}")
    parted = []
    for r in range(tokens.shape[0]):
        diff = (tokens[r] != plain[r]).nonzero()
        if not len(diff):
            parted.append(None)
            continue
        t = int(diff[0, 0])
        lp = plain_logits[t, r]
        best = lp.max().item()
        gap = best - lp[tokens[r, t]].item()
        # the two paths' logits differ by up to first["max_abs"] (the
        # kernels' last-bit differences carried through the layers), so a
        # plain gap within that, or within one bf16 step, can go either way
        limit = max(first["max_abs"], bf16_step(best))
        parted.append({"step": t, "plain_gap": gap, "limit": limit})
        check(gap <= limit, f"VLM row {r} parts from the plain path at step "
              f"{t}, where the plain logits rank its token {gap} below their "
              f"maximum {best}: more than {limit}, the larger of the first "
              "token's largest logit difference and one bf16 step")
    del plain_logits
    dec_ms = res["decode_s"] / 31 * 1e3
    print(f"serve {VLM_ARCH}, depth cut to {cfg.n_layers} layers "
          f"({cfg.param_count() / 1e9:.2f} B parameters; batch 4, prompt "
          f"1024, context {T}, 32 tokens, bf16): prefill "
          f"{res['prefill_s'] * 1e3:.3f} ms, decode {dec_ms:.3f} ms a step "
          f"({4 * 31 / res['decode_s']:.1f} tokens/s), peak {peak:.3f} GiB, "
          f"launches {launches} (prefill {seen['prefill_launches']}, decode "
          f"0); cross caches unchanged by 31 decode steps; profiled "
          f"prefill: wall {wall:.4f} s, device busy {busy:.6f} s (idle "
          f"{100 * (1 - busy / wall):.2f}%) in {n} device events, top:"
          + "; ".join(f" {k} x{c} {t:.6f} s" for k, c, t in top)
          + f"; first tokens against the plain path: {first}; rows parting "
          f"from the plain path (None: all 32 equal): {parted}; on {smi}")

    torch.backends.cuda.matmul.allow_tf32 = False     # full float32 products
    with np.load(VLM_GOLDEN) as f:
        fix = {k: f[k] for k in f.files}
    rcfg = dataclasses.replace(reduced(get_arch(str(fix["arch"]))),
                               dtype="float32")
    rparams = params_from_numpy(rcfg, numpy_tree(rcfg,
                                                 int(fix["weight_seed"])),
                                device=dev, dtype=torch.float32)
    flash_attention.launches = 0
    with torch.inference_mode():
        out = teacher_forced(rcfg, rparams,
                             torch.tensor(fix["tokens"], device=dev),
                             int(fix["prompt_len"]), int(fix["max_len"]),
                             torch.tensor(fix["cross_ctx"], device=dev))
    torch.cuda.synchronize()
    reduced_launches = flash_attention.launches
    r_want = 2 * (rcfg.n_layers + rcfg.n_super_blocks
                  * rcfg.block_pattern.count(BlockKind.CROSS_ATTN))
    check(reduced_launches == r_want,
          f"the reduced VLM launched {reduced_launches} flash_attention, "
          f"want {r_want} (each layer's self-attention and each cross "
          "layer's context, in forward and in prefill; none in decode)")
    errs = {}
    for key in ("forward", "prefill_last", "decode"):
        ref = fix[key]
        errs[key] = float(np.abs(out[key].cpu().numpy() - ref).max())
        check(errs[key] <= LM_MODEL_REL * np.abs(ref).max(),
              f"reduced VLM {key} logits: max |port - reference| "
              f"{errs[key]} > {LM_MODEL_REL} * {np.abs(ref).max()}")
    print(f"{rcfg.name} float32 (TF32 off), float32 context, against the "
          f"JAX reference's logits: max |port - reference| {errs} (limit "
          f"{LM_MODEL_REL} * max |reference| = "
          f"{LM_MODEL_REL * np.abs(fix['forward']).max()}); flash_attention "
          f"launches {reduced_launches}")
    out = {"layers": cfg.n_layers, "params_b": cfg.param_count() / 1e9,
           "prefill_s": res["prefill_s"], "decode_ms_per_step": dec_ms,
           "peak_gib": peak, "launches": launches,
           "prefill_launches": seen["prefill_launches"],
           "calls_vs_plain": by_call, "profiled_prefill_wall_s": wall,
           "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
           "first_tokens": first, "parted_from_plain": parted,
           "reduced_f32_errors": errs,
           "reduced_f32_launches": reduced_launches, "kernels": rec,
           "phase_s": time.perf_counter() - t_phase}
    print(f"phase 15 took {out['phase_s']:.1f} s")
    return out


# training (phase 14): the backward kernels' sweeps, each case (B, S, Hq,
# Hkv, D, causal, bf16?) and (B, L, H, N, P, chunk, q and k broadcast,
# slow decay, bf16?); the first of each is zamba2-2.7b's training shape
# (its shared attention; its Mamba-2 scan), the slow-decay SSD cases are
# phase 2d's; float32 at small shapes, GQA at head_dim 128; the second
# flash case is minitron-8b's training shape at tp = 2 (a rank's 16 query
# heads over 4 KV heads, phase 16); the third is qwen2.5-32b's training
# shape at data = 2 (a rank's two of four rows, 40 query heads over 8 KV
# heads, phase 16 (e)); the fourth qwen2.5-32b's training shape at tp = 2
# (a rank's 20 query heads over 4 KV heads, phase 18 (a), with and without
# SP)
FLASH_BWD_CASES = ((4, 1024, 32, 32, 80, True, True),
                   (4, 1024, 16, 4, 128, True, True),
                   (2, 1024, 40, 8, 128, True, True),
                   (4, 1024, 20, 4, 128, True, True),
                   (2, 256, 8, 2, 128, True, True),
                   (2, 256, 8, 2, 128, True, False),
                   (2, 100, 4, 4, 64, False, False),
                   (1, 130, 4, 1, 16, True, True),
                   (2, 64, 4, 4, 80, True, False))
SSD_BWD_CASES = ((4, 1024, 80, 64, 64, 256, True, False, True),
                 (2, 64, 8, 16, 16, 16, True, False, False),
                 (1, 512, 4, 64, 64, 128, False, False, False),
                 (2, 256, 4, 32, 48, 64, False, False, True),
                 (1, 1024, 8, 64, 64, 256, True, True, False),
                 (4, 1024, 80, 64, 64, 256, True, True, True))
TRAIN_GOLDEN = ROOT / "tests" / "fixtures" / "torch_train_golden.npz"
TRAIN_ARCH = "zamba2-2.7b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 4, 1024, 3
# kernel launches of one full-width zamba2 training step (remat "nothing"):
# each of the 9 attention and 45 Mamba-2 layers runs its forward kernel in
# the forward pass and again when the backward recomputes its super-block,
# then its backward kernel once
NO_LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
               "ssd_scan": 0, "ssd_scan_bwd": 0, "ssd_wide_bwd": 0,
               "slstm": 0, "slstm_bwd": 0}
TRAIN_LAUNCHES = {**NO_LAUNCHES, "flash_attention": 18,
                  "flash_attention_bwd": 9, "ssd_scan": 90,
                  "ssd_scan_bwd": 45}
# xlstm-350m at full width (24 layers, d_model 1 024, 4 heads of 256):
# each of its 12 mLSTM and 12 sLSTM layers runs its forward kernel twice
# (the forward pass, and the backward's recomputation under remat
# "nothing") and its backward kernel once
TRAIN_GOLDEN_XLSTM = (ROOT / "tests" / "fixtures"
                      / "torch_train_golden_xlstm.npz")
XLSTM_ARCH = "xlstm-350m"
XLSTM_TRAIN_LAUNCHES = {**NO_LAUNCHES, "ssd_scan": 24, "ssd_wide_bwd": 12,
                        "slstm": 24, "slstm_bwd": 12}
PROFILE_XLSTM_STEP_ARG = "--profile-xlstm-step"
# qwen2-moe-a2.7b at its published widths (d_model 2 048, 16 heads of 128,
# 60 routed experts of width 1 408, top-4, 4 shared) with the depth cut:
# its 24 layers are 14.3 B parameters, more than one card trains; 3
# layers (2.33 B) fit at 58.7 GiB (NVIDIA H100, chip_smoke.py phase 14)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_DEPTH = 3
# the profiled step's device time by kind, by kernel name
TRAIN_OP_KINDS = (("LM kernels", ("attn_bwd", "ssd_bwd", "flash_", "ssd_",
                                  "slstm")),
                  ("GEMMs", ("gemm", "sm90_", "cutlass", "xmma", "nvjet")),
                  ("elementwise", ("elementwise", "reduce", "index",
                                   "scatter", "gather")))
TRAIN_DRIVER_ARGV = ["--arch", TRAIN_ARCH, "--smoke", "--device", "cuda",
                     "--batch", "2", "--seq", "16", "--steps", "20",
                     "--ckpt-every", "10", "--log-every", "100"]


def lm_kernels() -> dict:
    """The LM kernels' wrappers by name (their ``launches`` counts)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.slstm import slstm_scan, slstm_scan_bwd
    from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                              ssd_wide_bwd)
    return {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd,
            "ssd_wide_bwd": ssd_wide_bwd, "slstm": slstm_scan,
            "slstm_bwd": slstm_scan_bwd}


def zero_lm_counts() -> None:
    for fn in lm_kernels().values():
        fn.launches = 0


def lm_counts() -> dict:
    return {name: fn.launches for name, fn in lm_kernels().items()}


def flash_bwd_bound_ms(q, k, causal, q_offset: int = 0,
                       kv_len=None) -> tuple[float, str]:
    """``flash_attention_bwd``'s least time: q, o and dO read and dQ
    written once, the k and v rows the mask lets any query see read once,
    dK and dV written once; five products of the visible (query, key)
    pairs (S, dP, dV, dQ, dK), two operations a multiply-add, at the peak
    rate of the inputs' type."""
    B, S, Hq, D = q.shape
    Skv, Hkv = k.shape[1:3]
    kv_end = Skv if kv_len is None else min(Skv, kv_len)
    if causal:
        pairs = int(np.minimum(kv_end, np.arange(S) + q_offset + 1).sum())
        kv_rows = min(kv_end, S + q_offset)
    else:
        pairs, kv_rows = S * kv_end, kv_end
    es = q.element_size()
    nbytes = es * (4 * B * S * Hq * D + 2 * B * (kv_rows + Skv) * Hkv * D)
    flops = 10 * B * Hq * D * pairs
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_bwd_bound_ms(q, k, v, chunk, norm: bool = False
                     ) -> tuple[float, str]:
    """``ssd_scan_bwd``'s least time: q and k read and their gradients
    written once at their own widths (once per batch row when broadcast
    over heads), v and dO read and dv written, a read and da written;
    per (batch, head) the in-chunk causal pairs times 3 N + 2 P
    multiply-adds (q k^T, dO v^T, dq, dk, dv) plus 5 N P a position (the
    forward and backward states and their terms in dq, dk, dv).  With
    ``norm`` (``ssd_wide_bwd``) the normaliser is one more column of v and
    dO in the products, and its dden is read."""
    B, L, H, N = q.shape
    P = v.shape[-1]
    Pe = P + (1 if norm else 0)
    c = min(chunk, L)
    es = v.element_size()
    heads_q = 1 if q.stride(2) == 0 else H
    heads_k = 1 if k.stride(2) == 0 else H
    nbytes = (es * (2 * B * L * (heads_q + heads_k) * N + 3 * B * L * H * P
                    + (B * L * H if norm else 0)) + 8 * B * L * H)
    flops = B * H * (L * (c + 1) * (3 * N + 2 * Pe) + 10 * L * N * Pe)
    peak = BF16_FLOP_PER_S if v.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold_grads(got, ref, dtype, what: str) -> float:
    """Each gradient of a backward kernel against its plain version:
    bf16 elementwise within 2e-2 (rtol and atol), float32 within 2e-5 of
    the largest plain entry; the largest error."""
    hold = kernel_err if dtype == torch.bfloat16 else (
        lambda o, r, _dt, w: kernel_err_of_max(o, r, w))
    return max(hold(o, r, dtype, f"{what} d{name}")
               for o, r, name in zip(got, ref, "qkva"))


PROFILE_BWD_ARG = "--profile-backward-kernels"
PROFILE_VLM_ARG = "--profile-vlm-attention"


def device_ms_in_child(arg: str) -> dict:
    """The profiler's device times ``{name: (ms, parts)}`` that
    ``python3 chip_smoke.py arg`` takes in a new process: in this script's
    process, after its earlier profiles (phase 6's prefill and decode
    step, phase 12's 3.6e5-event xLSTM prefill), the profiler drops whole
    calls' events in every session, while a new process records them
    all."""
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), arg],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(proc.returncode == 0, f"profiling in a new process ({arg}) "
          f"failed: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def profile_backward_kernels() -> None:
    """The child of ``device_ms_in_child(PROFILE_BWD_ARG)``: seeded inputs
    at the sweeps' first (zamba2) shapes, the profiled device times as
    JSON."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     lse_buffer)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    B, S, Hq, Hkv, D, causal, _ = FLASH_BWD_CASES[0]
    q, do = rn(B, S, Hq, D), rn(B, S, Hq, D)
    k, v = rn(B, S, Hkv, D), rn(B, S, Hkv, D)
    lse = lse_buffer(q)
    o = flash_attention(q, k, v, causal=causal, lse=lse)
    out = {"flash_attention_bwd": profiled_device_ms(
        lambda: flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse),
        reps=10)}
    lq, lk, lv = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))
    lout = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, is_causal=causal)
    out["sdpa_backward"] = profiled_device_ms(
        lambda: torch.autograd.grad(lout, (lq, lk, lv), do.transpose(1, 2),
                                    retain_graph=True), reps=10)
    del lout
    B, L, H, N, P, c, _, _, _ = SSD_BWD_CASES[0]
    q, k = (rn(B, L, 1, N).expand(B, L, H, N) for _ in range(2))
    v, do = rn(B, L, H, P), rn(B, L, H, P)
    a = -torch.nn.functional.softplus(rn(B, L, H, dtype=torch.float32))
    out["ssd_scan_bwd"] = profiled_device_ms(
        lambda: ssd_scan_bwd(q, k, v, a, do, chunk=c), reps=10)
    print(json.dumps(out))


def fsdp_bwd_record(q, k, v, o, do, lse, err, smi) -> dict:
    """``flash_attention_bwd`` at an FSDP rank's training shape timed:
    kernel and plain per call (CUDA events), the bound, and the backward
    of ``F.scaled_dot_product_attention`` (``enable_gqa``) on the same
    inputs."""
    from repro_torch.kernels.flash_attention import (attention_bwd_plain,
                                                     flash_attention_bwd)
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse=lse))
    plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, o, do), reps=5)
    b_ms, b_by = flash_bwd_bound_ms(q, k, True)
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    lout = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, is_causal=True, enable_gqa=True)
    ldo = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lout, (lq, lk, lv), ldo, retain_graph=True))
    del lout
    print(f"flash_attention_bwd at qwen2.5-32b's data = 2 training shape "
          f"(q {tuple(q.shape)} over k/v {tuple(k.shape)} bf16, causal): "
          f"per call (CUDA events, median of 25) kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms; bound {b_ms:.6f} ms ({b_by}); the backward "
          f"of F.scaled_dot_product_attention (enable_gqa) {lib_ms:.6f} ms; "
          f"on {smi}")
    return {"shape": list(q.shape[:3]) + [k.shape[2], q.shape[3]],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def backward_kernels_phase(g, dev, smi) -> dict:
    """Phase 14a-b: both backward kernels against their plain versions over
    the sweeps, then times at zamba2-2.7b's training shapes."""
    from repro_torch.kernels.flash_attention import (attention_bwd_plain,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     lse_buffer)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_plain

    def equal_share(got, ref) -> float:
        return float(sum((x == y).sum().item() for x, y in zip(got, ref))
                     / sum(x.numel() for x in got))
    out = {}
    for B, S, Hq, Hkv, D, causal, bf in FLASH_BWD_CASES:
        dt = torch.bfloat16 if bf else torch.float32
        q, do = randn((B, S, Hq, D), g, dt, dev), randn((B, S, Hq, D), g, dt,
                                                         dev)
        k, v = randn((B, S, Hkv, D), g, dt, dev), randn((B, S, Hkv, D), g,
                                                         dt, dev)
        lse = lse_buffer(q)
        o = flash_attention(q, k, v, causal=causal, lse=lse)
        what = f"flash_attention_bwd {(B, S, Hq, Hkv, D)} causal={causal} {dt}"

        def call():
            return flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       lse=lse)
        got = call()
        ref = attention_bwd_plain(q, k, v, o, do, causal=causal)
        err = hold_grads(got, ref, dt, what)
        repeat_bits(call, got, what)
        share = equal_share(got, ref)
        print(f"flash_attention_bwd B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
              f"causal={causal} {dt}: max |kernel - plain| {err!r}, "
              f"{100 * share:.2f}% of outputs bit-equal to the plain "
              "version's, a second call the same bits")
        if (B, S, Hq, D, bf) == (4, 1024, 32, 80, True):
            out["flash_attention_bwd"] = {"args": (q, k, v, o, do, lse),
                                          "max_abs_err": err,
                                          "bit_equal_share": share}
        if (B, S, Hq, Hkv, D) in ATTN_FSDP.values() and bf:
            out["flash_attention_bwd_fsdp"] = fsdp_bwd_record(
                q, k, v, o, do, lse, err, smi)
    for B, L, H, N, P, c, bc, slow, bf in SSD_BWD_CASES:
        dt = torch.bfloat16 if bf else torch.float32
        hq = 1 if bc else H
        q = randn((B, L, hq, N), g, dt, dev).expand(B, L, H, N)
        k = randn((B, L, hq, N), g, dt, dev).expand(B, L, H, N)
        v, do = randn((B, L, H, P), g, dt, dev), randn((B, L, H, P), g, dt,
                                                        dev)
        if slow:
            a = -0.01 * torch.rand((B, L, H), generator=g, device=dev)
        else:
            a = -torch.nn.functional.softplus(
                torch.randn((B, L, H), generator=g, device=dev))
        what = f"ssd_scan_bwd {(B, L, H, N, P, c)} slow={slow} {dt}"

        def call():
            return ssd_scan_bwd(q, k, v, a, do, chunk=c)
        got = call()
        ref = ssd_scan_bwd_plain(q, k, v, a, do, chunk=c)
        # da is float32 on both sides: held to 2e-5 of its largest entry
        err = max(hold_grads(got[:3], ref[:3], dt, what),
                  kernel_err_of_max(got[3], ref[3], f"{what} da"))
        repeat_bits(call, got, what)
        share = equal_share(got[:3], ref[:3])
        print(f"ssd_scan_bwd B={B} L={L} H={H} N={N} P={P} chunk={c} "
              f"broadcast={bc} slow={slow} {dt}: max |kernel - plain| "
              f"{err!r}, {100 * share:.2f}% of dq, dk, dv bit-equal to the "
              "plain version's, a second call the same bits")
        if (B, L, H, bf, slow) == (4, 1024, 80, True, False):
            out["ssd_scan_bwd"] = {"args": (q, k, v, a, do, c),
                                   "max_abs_err": err,
                                   "bit_equal_share": share}
    # times at zamba2-2.7b's shapes
    q, k, v, o, do, lse = out["flash_attention_bwd"].pop("args")
    f_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse=lse))
    f_p_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, o, do), reps=5)
    dev_ms = device_ms_in_child(PROFILE_BWD_ARG)
    f_dev, f_parts = dev_ms["flash_attention_bwd"]
    f_b, f_by = flash_bwd_bound_ms(q, k, True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    lout = sdpa(lq, lk, lv, is_causal=True)
    ldo = do.transpose(1, 2)
    lib = torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True)
    lib_err = max((x.transpose(1, 2).float() - y.float()).abs().max().item()
                  for x, y in zip(lib, attention_bwd_plain(q, k, v, o, do)))
    f_lib = cuda_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), ldo,
                                                retain_graph=True))
    del lib, lout
    l_dev, l_parts = dev_ms["sdpa_backward"]
    out["flash_attention_bwd"].update(
        ms=f_ms, plain_ms=f_p_ms, device_ms=f_dev, bound_ms=f_b,
        bound_by=f_by, library_ms=f_lib, library_device_ms=l_dev,
        parts=f_parts)
    print(f"flash_attention_bwd at zamba2-2.7b's training shape (q, k, v "
          f"[4, 1024, 32, 80] bf16, causal, the forward's lse): per call "
          f"(CUDA events, median of 25) kernel {f_ms:.6f} ms, plain "
          f"{f_p_ms:.6f} ms; device time (profiler, a new process) "
          f"{f_dev!r} ms [{show_parts(f_parts)}]; bound {f_b:.6f} ms "
          f"({f_by}); torch.autograd.grad of F.scaled_dot_product_attention "
          f"{f_lib:.6f} ms a call, device time {l_dev!r} ms "
          f"[{show_parts(l_parts)}] (max |sdpa - plain| {lib_err:.4g}); on "
          f"{smi}")
    q, k, v, a, do, c = out["ssd_scan_bwd"].pop("args")
    s_ms = cuda_ms(lambda: ssd_scan_bwd(q, k, v, a, do, chunk=c))
    s_p_ms = cuda_ms(lambda: ssd_scan_bwd_plain(q, k, v, a, do, chunk=c),
                     reps=5)
    s_dev, s_parts = dev_ms["ssd_scan_bwd"]
    s_b, s_by = ssd_bwd_bound_ms(q, k, v, c)
    out["ssd_scan_bwd"].update(
        ms=s_ms, plain_ms=s_p_ms, device_ms=s_dev, bound_ms=s_b,
        bound_by=s_by, library_ms=None, parts=s_parts)
    print(f"ssd_scan_bwd at zamba2-2.7b's training shape (q, k [4, 1024, "
          f"80, 64] broadcast over heads, v [4, 1024, 80, 64] bf16, chunk "
          f"256): per call (CUDA events, median of 25) kernel {s_ms:.6f} "
          f"ms, plain {s_p_ms:.6f} ms; device time (profiler, a new process) "
          f"{s_dev!r} ms [{show_parts(s_parts)}]; bound {s_b:.6f} ms "
          f"({s_by}); no "
          f"library call computes it; on {smi}")
    torch.cuda.empty_cache()
    return out


def reduced_training(path, dev, kernels: tuple) -> dict:
    """A reduced float32 config's three AdamW steps on the card's kernels
    (forward and backward) against the reference's fixture at ``path``,
    within the CPU test's limits (``models.testing.TRAIN_TOL``); every
    kernel named in ``kernels`` must launch."""
    from repro_torch.models.testing import (TRAIN_TOL, _fixture_config,
                                            train_fixture_errors,
                                            train_steps)
    with np.load(path) as f:
        fix = {k: f[k] for k in f.files}
    zero_lm_counts()
    run = train_steps(_fixture_config(fix), fix, dev)
    counts = lm_counts()
    check(all(counts[k] for k in kernels), f"the reduced float32 training "
          f"of {fix['arch']} launched {counts}: each of {kernels} must run")
    errs = train_fixture_errors(fix, run)
    for key, tol in TRAIN_TOL.items():
        check(errs[key] <= tol, f"reduced {fix['arch']} float32 training on "
              f"the card: {key} error {errs[key]} beyond {tol} (the CPU "
              "test's limit)")
    print(f"reduced {fix['arch']} float32 (TF32 off), 3 AdamW steps against "
          f"the JAX reference's: errors {errs} (limits {TRAIN_TOL}); losses "
          f"{run['loss'].tolist()} (reference {fix['loss'].tolist()}); "
          f"launches {counts}")
    return {"errors": errs, "launches": counts,
            "loss": run["loss"].tolist(),
            "grad_norm": run["grad_norm"].tolist()}


def step_profile(rows, wall, busy, n_ev) -> dict:
    """A profiled step's record: idle share, device time by kind, top."""
    by_kind = collections.Counter()
    for name, _, sec in rows:
        by_kind[next((kind for kind, keys in TRAIN_OP_KINDS
                      if any(key in name for key in keys)), "other")] += sec
    return {"profiled_step_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall, "device_events": n_ev,
            "device_s_by_kind": dict(by_kind),
            "top_device_ops": [tuple(r) for r in rows[:8]]}


def training_setup(cfg, dev):
    """``cfg`` at full width with seeded bf16 weights, AdamW (float32
    moments), its remat-"nothing" step and ``SyntheticLM`` batches (batch
    4 x 1024)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import ModelDims, init_params
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw
    dims = ModelDims.create(cfg)
    params = init_params(cfg, dims, generator=torch.Generator(
        device=dev).manual_seed(0))
    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100)
    state = adamw.init_state(opt, params)
    step = make_train_step(cfg, dims, opt, remat=True,
                           remat_policy="nothing", device=dev)
    return params, state, step, SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                            seed=0)


def profile_xlstm_step() -> None:
    """The child of ``PROFILE_XLSTM_STEP_ARG``: one full-width xlstm-350m
    training step after a warm-up, profiled in a process whose profiler
    has recorded nothing before; the record as JSON."""
    from repro_torch.models import get_arch
    dev = torch.device("cuda", 0)
    params, state, step, data = training_setup(get_arch(XLSTM_ARCH), dev)
    params, state, _ = step(params, state, data.batch_at(0))
    wall, busy, rows, n_ev = device_time_of(
        lambda: step(params, state, data.batch_at(1)), host_ops=False,
        top=None)
    print(json.dumps(step_profile(rows, wall, busy, n_ev)))


def full_width_training(name, cfg, setup, want, dev, smi,
                        profile) -> dict:
    """A model trained at full width on the card: ``setup()`` gives the
    parameters (seeded, bf16), the AdamW state (float32 moments), the
    remat-"nothing" step and the batches (batch 4 x 1024).  A warm-up step
    (its launches == ``want``), every parameter leaf's gradient nonzero and
    finite after it (``loss_and_grads``), three timed steps (step time,
    tokens/s, peak memory, 6 N T FLOP a step over that time) and, with
    ``profile``, one profiled step (``profile(step, params, state,
    batch)`` gives ``step_profile``'s record)."""
    from repro_torch.launch.platform import device_fetch
    from repro_torch.models import ModelDims
    from repro_torch.models.steps import batch_to_device, loss_and_grads
    from repro_torch.optim.tree import tree_flatten_with_paths, tree_leaves
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state, step, data = setup()
    dims = ModelDims.create(cfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    zero_lm_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step(params, state, data.batch_at(0))
    warm_loss, warm_norm = device_fetch(m["loss"], m["grad_norm"])
    warm_s = time.perf_counter() - t0
    step_counts = lm_counts()
    check(step_counts == want, f"one full-width {name} training step "
          f"launched {step_counts}, want {want}")
    # the guard against a silent detach: every leaf's gradient after step 1
    zero_lm_counts()
    loss1, grads = loss_and_grads(cfg, dims, params, batch_to_device(
        data.batch_at(1), dev))
    check(lm_counts() == want, f"{name} loss_and_grads launched "
          f"{lm_counts()}, want {want}")
    named = list(tree_flatten_with_paths(grads))
    nonzero = torch.stack([torch.count_nonzero(t) for _, t in named])
    finite = torch.stack([torch.isfinite(t).all() for _, t in named])
    nonzero, finite = device_fetch(nonzero, finite)
    dead = [p for (p, _), n in zip(named, nonzero) if n == 0]
    check(not dead, f"{name}: parameter leaves with an all-zero gradient "
          f"after step 1: {dead}")
    check(bool(finite.all()), f"{name}: a gradient leaf is not finite")
    del grads
    zero_lm_counts()
    times, losses, norms = [], [float(warm_loss[()])], [float(warm_norm[()])]
    for s in range(1, 1 + TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, data.batch_at(s))
        loss, norm = device_fetch(m["loss"], m["grad_norm"])
        times.append(time.perf_counter() - t0)
        losses.append(float(loss[()]))
        norms.append(float(norm[()]))
    timed_counts = lm_counts()
    check(timed_counts == {k: TRAIN_TIMED * v for k, v in want.items()},
          f"{name}: {TRAIN_TIMED} training steps launched {timed_counts}")
    check(bool(np.isfinite(losses).all() and np.isfinite(norms).all()),
          f"{name}: full-width losses {losses}, grad norms {norms}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = float(np.median(times))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    prof = profile(step, params, state, data.batch_at(1 + TRAIN_TIMED)) \
        if profile else {}
    del params, state, step
    torch.cuda.empty_cache()
    rec = {
        "params": n_params, "param_count": cfg.param_count(),
        "n_layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "losses": losses, "grad_norms": norms, "warmup_step_s": warm_s,
        "step_s": times, "median_step_s": step_s,
        "tokens_per_s": tokens / step_s, "peak_gib": peak,
        "model_flops_per_step": flops,
        "model_flops_per_s": flops / step_s,
        "model_flops_share_of_bf16_peak": flops / step_s / BF16_FLOP_PER_S,
        "launches_per_step": step_counts,
        "launches_timed_steps": timed_counts, "leaves": len(named), **prof}
    shown = {k: v for k, v in step_counts.items() if v}
    print(f"{name} training at full width ({n_params} parameters, "
          f"param_count {cfg.param_count()}, {cfg.n_layers} layers, bf16, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat 'nothing', AdamW "
          f"float32 moments): losses {losses}, grad norms {norms}; every "
          f"one of {len(named)} parameter leaves has a nonzero gradient "
          f"after step 1; warm-up step {warm_s:.3f} s, steps {times} s, "
          f"median {step_s:.4f} s = {tokens / step_s:.1f} tokens/s, peak "
          f"{peak:.3f} GiB, 6 N T = {flops:.4g} FLOP a step = "
          f"{flops / step_s / 1e12:.2f} TFLOP/s "
          f"({100 * flops / step_s / BF16_FLOP_PER_S:.2f}% of 989); "
          f"launches per step {shown}"
          + (f"; profiled step: wall {prof['profiled_step_wall_s']:.4f} s, "
             f"device busy {prof['device_busy_s']:.6f} s (idle "
             f"{100 * prof['device_idle_share']:.2f}%) in "
             f"{prof['device_events']} device events, by kind (s) "
             f"{prof['device_s_by_kind']}, top:"
             + "; ".join(f" {k} x{c} {t:.6f} s"
                         for k, c, t in prof["top_device_ops"])
             if prof else "") + f"; on {smi}")
    return rec


def moe_cut_training(dev, smi) -> dict:
    """qwen2-moe-a2.7b trained at its published widths (attention at head
    dim 128 on ``flash_attention`` and its backward, the GShard dispatch
    differentiated by autograd) with the depth cut to ``MOE_DEPTH``."""
    from repro_torch.models import get_arch
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_DEPTH)
    want = {**NO_LAUNCHES, "flash_attention": 2 * MOE_DEPTH,
            "flash_attention_bwd": MOE_DEPTH}
    return full_width_training(
        f"{MOE_ARCH} cut to {MOE_DEPTH} layers", cfg,
        lambda: training_setup(cfg, dev), want, dev, smi, None)


def training_phase(dev, smi) -> dict:
    """Phase 14: training.  (a) the backward kernels were built in phase 1;
    (b) each held against its plain version, timed; (c) reduced zamba2 in
    float32 on the kernels against the reference's three training steps
    (``tests/fixtures/torch_train_golden.npz``); (d) zamba2-2.7b trained
    at full width; (e) the train driver's crash and resume; (f) reduced
    xLSTM in float32 on the kernels against its fixture
    (``tests/fixtures/torch_train_golden_xlstm.npz``); (g) xlstm-350m
    trained at full width, its step profiled in a new process; (h)
    qwen2-moe-a2.7b trained at its published widths with the depth cut."""
    import shutil
    import tempfile
    from repro_torch.launch import train
    from repro_torch.models import get_arch
    g = torch.Generator(device=dev).manual_seed(14)
    t_phase = time.perf_counter()
    out = {"kernels": backward_kernels_phase(g, dev, smi)}

    # (c) reduced zamba2, float32, kernels forward and backward
    out["reduced_f32"] = reduced_training(
        TRAIN_GOLDEN, dev, ("flash_attention", "flash_attention_bwd",
                            "ssd_scan", "ssd_scan_bwd"))

    def setup(cfg):
        return lambda: training_setup(cfg, dev)

    def in_process(step, params, state, batch):
        wall, busy, rows, n_ev = device_time_of(
            lambda: step(params, state, batch), host_ops=False, top=None)
        return step_profile(rows, wall, busy, n_ev)

    # (d) zamba2-2.7b at full width, bf16, seeded random weights
    cfg = get_arch(TRAIN_ARCH)
    out["zamba2_full_width"] = full_width_training(
        TRAIN_ARCH, cfg, setup(cfg), TRAIN_LAUNCHES, dev, smi, in_process)

    # (e) the driver: a crash at step 12, a resume, and a clean run
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_train_", dir=scratch))
    try:
        zero_lm_counts()
        crashed = False
        try:
            train.main(TRAIN_DRIVER_ARGV + ["--ckpt-dir", str(tmp / "a"),
                                            "--fail-at-step", "12"])
        except RuntimeError as exc:
            crashed = "simulated failure" in str(exc)
        check(crashed, "the driver did not stop at step 12")
        resumed = train.main(TRAIN_DRIVER_ARGV + ["--ckpt-dir",
                                                  str(tmp / "a")])
        clean = train.main(TRAIN_DRIVER_ARGV + ["--ckpt-dir", str(tmp / "b")])
        driver_counts = lm_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(resumed["losses"] == clean["losses"][10:],
          f"resumed losses {resumed['losses']} != the clean run's "
          f"{clean['losses'][10:]}")
    check(all(driver_counts[k] for k, n in TRAIN_LAUNCHES.items() if n),
          f"the driver runs launched {driver_counts}")
    out["driver"] = {"resumed_losses": resumed["losses"],
                     "final_loss": clean["final_loss"],
                     "launches": driver_counts}
    print(f"train driver (reduced zamba2, bf16, on the card): crashed at "
          f"step 12, resumed from step 10; its losses == the clean run's "
          f"steps 10-19 {clean['losses'][10:]}; launches over the three "
          f"runs {driver_counts}")

    # (f) reduced xLSTM, float32, kernels forward and backward
    out["xlstm_reduced_f32"] = reduced_training(
        TRAIN_GOLDEN_XLSTM, dev, ("ssd_scan", "ssd_wide_bwd", "slstm",
                                  "slstm_bwd"))

    # (g) xlstm-350m at full width, its profiled step in a new process
    out["xlstm_full_width"] = full_width_training(
        XLSTM_ARCH, get_arch(XLSTM_ARCH), setup(get_arch(XLSTM_ARCH)),
        XLSTM_TRAIN_LAUNCHES, dev, smi,
        lambda *_: device_ms_in_child(PROFILE_XLSTM_STEP_ARG))

    # (h) qwen2-moe-a2.7b at its published widths, the depth cut to fit
    out["moe_cut_depth"] = moe_cut_training(dev, smi)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: tensor / data parallel execution, two ranks on the one card
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_SERVE = {"minitron-8b": 32, "qwen2-moe-a2.7b": 24}   # flash a prefill
DIST_GEN = 32
DIST_TP_TRAIN_ARCH = "minitron-8b"
# the published widths, the depth cut to what fits two ranks on one card:
# AdamW's functional update holds the old and new parameters and moments
# and a leaf's float32 temporaries (the 2 GiB embedding's), so 8 layers
# (1.75 B parameters a rank) and 4 (1.40 B) ran out of memory with 37.0
# and 35.6 GiB allocated on a rank; 2 layers are 1.23 B a rank
DIST_TP_TRAIN_LAYERS = 2
# a sharded training run against the one-rank run of the same weights
# (bf16): each loss, relative; the first step's gradient norm of each leaf
# (tp = 2) and its global norm (dp = 2), relative.  A gradient
# scaled by tp, or not averaged over the data ranks, is off by tens of
# percent
DIST_LOSS_REL = 1e-3
DIST_LEAF_REL = 2e-2
DIST_GNORM_REL = 1e-2
DIST_PSUM_N = 2 ** 20
DIST_WALL_S = 900
# (e) qwen2.5-32b at its published widths on a 2 x 1 mesh (data 2, model
# 1: only FSDP shards it).  Gloo stages each gather through the host at
# about 0.5 GiB/s (tp = 2 prefills above, on an H100 80GB) and a bf16
# layer is 0.98 GB, so a forward costs about a second a layer: serving (a
# bf16 prefill, FSDP_GEN - 1 decode steps, a float32 prefill) is cut to
# FSDP_SERVE_LAYERS of 64 layers; training to FSDP_TRAIN_LAYERS, the most
# that fits two ranks' AdamW state beside the whole embedding and head
# each rank keeps at model = 1 (1.56 B parameters): 2 layers took 36.0 GiB
# a rank, which fit two ranks alone (scripts/dist_phase_check.py) but ran
# out of memory beside this script's own process, 78.45 of 79.18 GiB in
# use on an H100 80GB
FSDP_ARCH = "qwen2.5-32b"
FSDP_SERVE_LAYERS = 6
FSDP_TRAIN_LAYERS = 1
FSDP_GEN = 4
FSDP_LOGIT_REL = 5e-5


def _dist_sync(dev) -> None:
    torch.cuda.synchronize(dev)
    torch.distributed.barrier()


def _coll_delta(fn):
    """``fn()``'s result and the collectives it made (calls, bytes,
    staged through the host, by operation)."""
    from repro_torch.distributed import collectives as coll
    coll.reset_stats()
    out = fn()
    return out, coll.stats()


def _dist_parallel(cfg, shape, batch):
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.launch.mesh import RankMesh, make_mesh
    return tpl.make_parallel(cfg, RankMesh(make_mesh(
        shape, ("data", "model"))), batch)


def _dist_params(cfg, dims, par, dev, dtype):
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.models import init_params
    return init_params(
        cfg, dims, generator=torch.Generator(device=dev).manual_seed(0),
        dtype=dtype, shard=None if par is None else (
            lambda path, tree: tpl.shard_params(cfg, tree, par, path)))


def dist_serve(arch: str, dev) -> dict:
    """(a) ``arch`` at full width and depth at tp = 2: bf16 prefill and 31
    greedy decode steps (launches, times, peak memory, collectives a
    prefill and a decode step), then a float32 prefill of the same seeded
    weights; rank 0 then runs the one-rank float32 prefill of those
    weights alone (the other rank waits) and holds the two."""
    from repro_torch.models import ModelDims, get_arch
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.testing import synth_batch
    cfg = get_arch(arch)
    dims = ModelDims.create(cfg, 2)
    check(dims == dataclasses.replace(ModelDims.create(cfg), tp=2),
          f"{arch} pads at tp = 2: {dims}")
    par = _dist_parallel(cfg, (1, DIST_WORLD), 4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_all = time.perf_counter()
    out = {}
    with torch.inference_mode():
        params = _dist_params(cfg, dims, par, dev, torch.bfloat16)
        batch = synth_batch(cfg, batch=4, seq=1024, seed=0, device=dev)
        batch.pop("labels")
        prefill = make_prefill_step(cfg, dims, 1024 + DIST_GEN, par=par)
        decode = make_decode_step(cfg, dims, par=par)
        zero_lm_counts()
        _dist_sync(dev)
        t0 = time.perf_counter()
        (logits, cache), out["coll_prefill"] = _coll_delta(
            lambda: prefill(params, batch))
        _dist_sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        out["launches_prefill"] = lm_counts()
        check(out["launches_prefill"]["flash_attention"] == DIST_SERVE[arch],
              f"{arch} tp = 2 prefill: {out['launches_prefill']}")
        tokens = [logits.argmax(-1)[:, None]]
        zero_lm_counts()
        t0 = time.perf_counter()
        for i in range(DIST_GEN - 1):
            (lg, cache), stats = _coll_delta(lambda: decode(
                params, tokens[-1], cache, 1024 + i))
            tokens.append(lg.argmax(-1)[:, None])
            if i == 0:
                out["coll_decode_step"] = stats
        _dist_sync(dev)
        out["decode_tok_s"] = 4 * (DIST_GEN - 1) / (time.perf_counter() - t0)
        out["launches_decode"] = lm_counts()
        check(not any(out["launches_decode"].values()),
              f"{arch} decode launched {out['launches_decode']}")
        out["tokens"] = torch.cat(tokens, 1).tolist()
        out["peak_gib_bf16"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        del params, cache, logits
        torch.cuda.empty_cache()
        f32 = dataclasses.replace(cfg, dtype="float32")
        params = _dist_params(f32, dims, par, dev, torch.float32)
        last, cache = make_prefill_step(f32, dims, 1024, par=par)(params,
                                                                  batch)
        last = last.float().cpu()
        del params, cache
        torch.cuda.empty_cache()
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if torch.distributed.get_rank() == 0:
            one = ModelDims.create(f32)
            params = _dist_params(f32, one, None, dev, torch.float32)
            ref, cache = make_prefill_step(f32, one, 1024)(params, batch)
            ref = ref.float().cpu()
            del params, cache
            torch.cuda.empty_cache()
            agree = logit_agreement(last, ref)
            del agree["plain_top2_gap"]
            out["float32_vs_one_rank"] = agree
            check(agree["max_abs"] <= 1e-3 * agree["max_logit"]
                  and agree["top1"] == 1.0,
                  f"{arch} tp = 2 float32 prefill against one rank: {agree}")
    _dist_sync(dev)
    out["wall_s"] = time.perf_counter() - t_all
    return out


def _leaf_grad_norms(grads, par) -> dict:
    """Each leaf's whole gradient norm ``{path: float}`` from the rank's
    shards (squares summed over the tensor-parallel axis where the leaf's
    spec shards it; a replicated leaf's own norm)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd
    from repro_torch.optim.tree import tree_flatten_with_paths

    if par is None:
        return {p: float(torch.linalg.vector_norm(g.float()))
                for p, g in tree_flatten_with_paths(grads)}

    def norm(g, spec):
        sq = torch.sum(torch.square(g.float()))
        if any(par.axis_for(e).size > 1 for e in spec if e is not None):
            coll.all_reduce(sq, par.tp.group)
        return torch.sqrt(sq)
    return {p: float(t) for p, t in tree_flatten_with_paths(
        shd.tree_map_specs(norm, grads, shd.param_specs(par.cfg, grads)))}


def dist_train_tp(dev) -> dict:
    """(b) minitron-8b at its published widths, depth cut to
    ``DIST_TP_TRAIN_LAYERS``, tp = 2: every leaf's gradient nonzero and
    finite, then three AdamW steps on one batch (losses finite and
    falling), step time, peak memory, collectives and launches a step;
    last, rank 0 runs ``loss_and_grads`` on one rank with the same seeded
    weights of the model padded to tp = 2 (the other rank has freed its
    memory and waits) and holds the first step's loss and each leaf's
    gradient norm against it."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.models import ModelDims, get_arch
    from repro_torch.models.steps import (batch_to_device, loss_and_grads,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.tree import tree_flatten_with_paths
    cfg = dataclasses.replace(get_arch(DIST_TP_TRAIN_ARCH),
                              n_layers=DIST_TP_TRAIN_LAYERS)
    dims = ModelDims.create(cfg, 2)
    par = _dist_parallel(cfg, (1, DIST_WORLD), TRAIN_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_all = time.perf_counter()
    params = _dist_params(cfg, dims, par, dev, torch.bfloat16)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    state, _ = tpl.init_opt_state(opt, params, par)
    batch = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0)
    loss0, grads = loss_and_grads(cfg, dims, params,
                                  batch_to_device(batch, dev), remat=True,
                                  par=par)
    bad = [p for p, g in tree_flatten_with_paths(grads)
           if not (bool(torch.isfinite(g.float()).all())
                   and bool((g != 0).any()))]
    check(not bad, f"tp = 2 training: zero or non-finite gradients {bad}")
    loss0, norms = float(loss0), _leaf_grad_norms(grads, par)
    del grads
    step = make_train_step(cfg, dims, opt, remat=True, device=dev, par=par)
    out = {"layers": DIST_TP_TRAIN_LAYERS, "losses": [], "grad_norms": [],
           "step_s": []}
    for i in range(TRAIN_TIMED):
        zero_lm_counts()
        _dist_sync(dev)
        t0 = time.perf_counter()
        (params, state, m), stats = _coll_delta(
            lambda: step(params, state, batch))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["step_s"].append(time.perf_counter() - t0)
        out["coll_train_step"] = stats
        out["launches_step"] = lm_counts()
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"tp = 2 training losses {losses}")
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    check(all(out["launches_step"][k] == v for k, v in want.items()),
          f"tp = 2 training launches {out['launches_step']}")
    out["params_per_rank"] = sum(
        t.numel() for _, t in tree_flatten_with_paths(params))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del params, state
    torch.cuda.empty_cache()
    _dist_sync(dev)
    out["wall_s"] = time.perf_counter() - t_all
    if torch.distributed.get_rank() == 0:
        params = _dist_params(cfg, dims, None, dev, torch.bfloat16)
        ref_loss, grads = loss_and_grads(cfg, dims, params,
                                         batch_to_device(batch, dev),
                                         remat=True)
        ref = _leaf_grad_norms(grads, None)
        del params, grads
        torch.cuda.empty_cache()
        check(ref.keys() == norms.keys(),
              f"tp = 2 gradient leaves {sorted(norms)} against one rank's "
              f"{sorted(ref)}")
        leaf_rel = {k: abs(norms[k] - ref[k]) / ref[k] for k in ref}
        worst = max(leaf_rel, key=leaf_rel.get)
        out["one_rank"] = {"loss": float(ref_loss),
                           "loss_rel": abs(loss0 - float(ref_loss))
                           / abs(float(ref_loss)),
                           "leaf_norm_rel_max": leaf_rel[worst],
                           "leaf_norm_rel_worst": worst}
        check(out["one_rank"]["loss_rel"] <= DIST_LOSS_REL
              and leaf_rel[worst] <= DIST_LEAF_REL,
              f"tp = 2 first step (loss {loss0}) against one rank: "
              f"{out['one_rank']}; leaf norms {norms} against {ref}")
    _dist_sync(dev)
    return out


def _xlstm_losses(cfg, dims, par, dev, batch) -> tuple[list, list, dict,
                                                        dict]:
    """Three AdamW steps of xlstm-350m on ``batch`` (lr 3e-3 from the
    first step, so that the loss moves: at 1e-3 it fell 0.97% in three
    steps on the card): losses, grad norms, the last step's collectives
    and launches."""
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw
    opt = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=100)
    params = _dist_params(cfg, dims, par, dev, torch.bfloat16)
    state = (adamw.init_state(opt, params) if par is None
             else tpl.init_opt_state(opt, params, par)[0])
    step = make_train_step(cfg, dims, opt, remat=True, device=dev, par=par)
    losses, gnorms, stats, launches = [], [], {}, {}
    for _ in range(TRAIN_TIMED):
        zero_lm_counts()
        (params, state, m), stats = _coll_delta(
            lambda: step(params, state, batch))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        launches = lm_counts()
    del params, state
    torch.cuda.empty_cache()
    return losses, gnorms, stats, launches


def dist_train_dp(dev) -> dict:
    """(c) xlstm-350m at full width and depth, dp = 2 with ZeRO-1 (batch
    4 x 1024, two rows a rank), three steps on one batch: each loss within
    ``DIST_LOSS_REL`` and the first step's grad norm within
    ``DIST_GNORM_REL`` of the one-rank run's (rank 0 runs it after, the
    other rank waits), and the loss falling by at least ten times
    ``DIST_LOSS_REL``.  Later grad norms are printed, not held: bf16
    parameters that AdamW has moved part on rounding (a 1.0 norm scale
    does not take a 1e-3 step), which moves the norm far more than the
    loss."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import ModelDims, get_arch
    cfg = get_arch(XLSTM_ARCH)
    dims = ModelDims.create(cfg)
    par = _dist_parallel(cfg, (DIST_WORLD, 1), TRAIN_BATCH)
    batch = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses, gnorms, stats, launches = _xlstm_losses(cfg, dims, par, dev,
                                                    batch)
    _dist_sync(dev)
    out = {"losses": losses, "grad_norms": gnorms, "coll_train_step": stats,
           "launches_step": launches, "wall_s": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    check(all(launches[k] > 0 for k in ("ssd_scan", "ssd_wide_bwd", "slstm",
                                        "slstm_bwd")),
          f"dp = 2 xLSTM step launches {launches}")
    fall = (losses[0] - losses[-1]) / losses[0]
    out["loss_fall_rel"] = fall
    check(fall >= 10 * DIST_LOSS_REL,
          f"dp = 2 losses {losses} fell {fall} relative, want at least "
          f"{10 * DIST_LOSS_REL}")
    if torch.distributed.get_rank() == 0:
        one, one_g, _, _ = _xlstm_losses(cfg, dims, None, dev, batch)
        out["one_rank_losses"], out["one_rank_grad_norms"] = one, one_g
        out["max_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses, one))
        out["grad_norm_first_rel"] = abs(gnorms[0] - one_g[0]) / one_g[0]
        check(out["max_rel"] <= DIST_LOSS_REL
              and out["grad_norm_first_rel"] <= DIST_GNORM_REL,
              f"dp = 2 losses {losses}, grad norms {gnorms} against one "
              f"rank's {one}, {one_g}")
    _dist_sync(dev)
    return out


def dist_psum(dev) -> dict:
    """(d) ``compressed_psum`` of a seeded 2^20-element float32 vector over
    the two ranks on the card: within 0.02 of the exact sum, and each
    element within one quantisation step of the same call on CPU tensors
    (the chunk's largest entry over 127)."""
    from repro_torch.distributed.compress import compressed_psum
    from repro_torch.launch.mesh import RankMesh, make_mesh
    mesh = RankMesh(make_mesh((DIST_WORLD,), ("pod",)))
    x = np.random.default_rng(0).standard_normal(DIST_PSUM_N).astype(
        np.float32)
    _dist_sync(dev)
    t0 = time.perf_counter()
    (got, stats) = _coll_delta(lambda: compressed_psum(
        torch.from_numpy(x).to(dev), mesh))
    got = got.cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    host = compressed_psum(torch.from_numpy(x), mesh).numpy()
    exact = x.astype(np.float64) * DIST_WORLD
    rel = float(np.abs(got - exact).max() / np.abs(exact).max())
    chunks = np.abs(host.reshape(DIST_WORLD, -1)).max(axis=1) / 127.0
    step = np.repeat(chunks, DIST_PSUM_N // DIST_WORLD)
    off = float((np.abs(got - host) / step).max())
    check(rel < 0.02 and off <= 1.0 + 1e-6,
          f"compressed_psum on the card: {rel} of exact, {off} steps off "
          "the CPU run")
    return {"rel_to_exact": rel, "steps_off_cpu": off,
            "bit_equal_share_cpu": float((got == host).mean()), "ms": ms,
            "coll": stats}


def _fsdp_want(params, pspecs, par) -> dict:
    """The FSDP all-gathers one forward makes, as the code predicts them:
    one a layer leaf whose spec shards it over 'data', of its block's
    bytes."""
    from repro_torch.distributed import sharding as shd
    want = {"calls": 0, "bytes": 0}

    def one(t, s):
        if par.fsdp_leaf(s):
            want["calls"] += 1
            want["bytes"] += t.numel() * t.element_size()
    shd.tree_map_specs(one, params["layers"], pspecs["layers"])
    return want


def _held_bytes(tree, pspecs, par) -> dict:
    """Bytes of ``tree`` (parameters or a moment, like them) this rank
    holds: its layer leaves sharded over 'data' beside what the rank
    would hold of them without FSDP, its other layer leaves, and the rest
    (embedding, head, final norm)."""
    from repro_torch.distributed import sharding as shd
    out = {"layers_fsdp": 0, "layers_fsdp_unsharded": 0, "layers_other": 0,
           "rest": 0}

    def layer(t, s):
        n = t.numel() * t.element_size()
        if par.fsdp_leaf(s):
            out["layers_fsdp"] += n
            out["layers_fsdp_unsharded"] += n * par.fsdp.size
        else:
            out["layers_other"] += n

    def rest(t, s):
        out["rest"] += t.numel() * t.element_size()
    shd.tree_map_specs(layer, tree["layers"], pspecs["layers"])
    shd.tree_map_specs(rest, {k: v for k, v in tree.items()
                              if k != "layers"},
                       {k: v for k, v in pspecs.items() if k != "layers"})
    return out


def _fsdp_calls(stats: dict, want: dict, passes: int, what: str) -> dict:
    """The FSDP all-gathers and reduce-scatters of a run against
    ``passes`` times the predicted gathers (a training step gathers in
    the forward and again in the backward's recomputation, and reduces
    each gradient once)."""
    got = {op: stats.get(f"fsdp_{op}", {}).get("calls", 0)
           for op in ("all_gather", "all_reduce")}
    check(got["all_gather"] == passes * want["calls"],
          f"{what}: {got['all_gather']} FSDP all-gathers, the code predicts "
          f"{passes} x {want['calls']}")
    if passes > 1:
        check(got["all_reduce"] == want["calls"],
              f"{what}: {got['all_reduce']} FSDP reduce-scatters, want "
              f"{want['calls']}")
    return {"calls": got, "gather_bytes": stats.get(
        "fsdp_all_gather", {}).get("bytes", 0),
        "predicted_gathers": passes * want["calls"],
        "predicted_gather_bytes": passes * want["bytes"]}


def _top2(logits) -> list:
    """Each row's two largest logits (exact ties show as equal pairs)."""
    return logits.float().topk(2, dim=-1).values.cpu().tolist()


def _greedy(prefill, decode, params, batch, gen: int):
    """Greedy tokens ``[B, gen]`` and each step's rows' top two logits,
    with the collectives of the prefill and of the first decode step."""
    (logits, cache), c_pre = _coll_delta(lambda: prefill(params, batch))
    tokens, top2, c_dec = [logits.argmax(-1)[:, None]], [_top2(logits)], {}
    for i in range(gen - 1):
        (lg, cache), stats = _coll_delta(lambda: decode(
            params, tokens[-1], cache, batch["tokens"].shape[1] + i))
        tokens.append(lg.argmax(-1)[:, None])
        top2.append(_top2(lg))
        c_dec = c_dec or stats
    return torch.cat(tokens, 1).tolist(), top2, c_pre, c_dec


def _tokens_agree(got, want, top2_got, top2_want) -> dict:
    """Rows whose greedy tokens part, and whether each parts first at a
    step where either run's top two logits of that row are exactly
    equal."""
    parted = {}
    for b, (x, y) in enumerate(zip(got, want)):
        if x != y:
            t = next(i for i, (u, w) in enumerate(zip(x, y)) if u != w)
            parted[b] = {"step": t, "tied": top2_got[t][b][0] == top2_got[
                t][b][1] or top2_want[t][b][0] == top2_want[t][b][1]}
    return parted


def dist_fsdp_serve(dev) -> dict:
    """(e) qwen2.5-32b at its published widths, ``FSDP_SERVE_LAYERS``
    layers, on data = 2: bf16 prefill of batch 4 x 1 024 (two rows a rank)
    and ``FSDP_GEN`` greedy tokens, then a float32 prefill of the same
    seeded weights; each rank's held bytes, peak memory and FSDP gathers
    against the predicted count.  Rank 0 then runs the same cut model on
    one rank, unsharded (the other rank has freed its memory and waits):
    float32 logits within ``FSDP_LOGIT_REL`` of their largest, bf16
    tokens equal except on an exactly tied row."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import ModelDims, get_arch
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.testing import synth_batch
    cfg = dataclasses.replace(get_arch(FSDP_ARCH),
                              n_layers=FSDP_SERVE_LAYERS)
    dims = ModelDims.create(cfg)
    par = _dist_parallel(cfg, (DIST_WORLD, 1), 4)
    check(par.fsdp.size == DIST_WORLD and par.tp.size == 1
          and par.dp.size == DIST_WORLD,
          f"{FSDP_ARCH} on {DIST_WORLD} x 1: fsdp {par.fsdp.size}, tp "
          f"{par.tp.size}, batch axes {par.dp_names}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_all = time.perf_counter()
    out = {"layers": FSDP_SERVE_LAYERS}
    with torch.inference_mode():
        params = _dist_params(cfg, dims, par, dev, torch.bfloat16)
        pspecs = shd.param_specs(cfg, params)
        want = _fsdp_want(params, pspecs, par)
        out["held"] = held = _held_bytes(params, pspecs, par)
        embed = params["embed"]
        check(held["layers_fsdp"] * DIST_WORLD
              == held["layers_fsdp_unsharded"]
              and tuple(embed.shape) == (dims.vocab_pad, cfg.d_model),
              f"{FSDP_ARCH} held: {held}, embedding {tuple(embed.shape)}")
        batch = synth_batch(cfg, batch=4, seq=1024, seed=0, device=dev)
        batch.pop("labels")
        prefill = make_prefill_step(cfg, dims, 1024 + FSDP_GEN, par=par)
        decode = make_decode_step(cfg, dims, par=par)
        zero_lm_counts()
        _dist_sync(dev)
        t0 = time.perf_counter()
        tokens, top2, c_pre, c_dec = _greedy(prefill, decode, params, batch,
                                             FSDP_GEN)
        _dist_sync(dev)
        out["serve_s"] = time.perf_counter() - t0
        out["launches_serve"] = lm_counts()
        check(out["launches_serve"]["flash_attention"] == cfg.n_layers,
              f"{FSDP_ARCH} data = 2 serving: {out['launches_serve']}, "
              f"want one flash_attention a layer")
        out["gathers_prefill"] = _fsdp_calls(c_pre, want, 1, "prefill")
        out["gathers_decode_step"] = _fsdp_calls(c_dec, want, 1,
                                                 "decode step")
        out["coll_prefill"], out["coll_decode_step"] = c_pre, c_dec
        out["tokens"] = tokens
        out["peak_gib_bf16"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        del params, prefill, decode
        torch.cuda.empty_cache()
        f32 = dataclasses.replace(cfg, dtype="float32")
        params = _dist_params(f32, dims, par, dev, torch.float32)
        t0 = time.perf_counter()
        last, cache = make_prefill_step(f32, dims, 1024, par=par)(params,
                                                                  batch)
        last = last.float().cpu()
        out["prefill_f32_s"] = time.perf_counter() - t0
        del params, cache
        torch.cuda.empty_cache()
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        _dist_sync(dev)
        if torch.distributed.get_rank() == 0:
            params = _dist_params(cfg, dims, None, dev, torch.bfloat16)
            one_tokens, one_top2, _, _ = _greedy(
                make_prefill_step(cfg, dims, 1024 + FSDP_GEN),
                make_decode_step(cfg, dims), params, batch, FSDP_GEN)
            del params
            torch.cuda.empty_cache()
            parted = _tokens_agree(tokens, one_tokens, top2, one_top2)
            out["bf16_vs_one_rank"] = {"tokens": one_tokens,
                                       "parted": parted}
            check(all(p["tied"] for p in parted.values()),
                  f"{FSDP_ARCH} data = 2 bf16 tokens {tokens} against one "
                  f"rank's {one_tokens}: rows {parted} part off a tie")
            params = _dist_params(f32, dims, None, dev, torch.float32)
            ref, cache = make_prefill_step(f32, dims, 1024)(params, batch)
            ref = ref.float().cpu()
            del params, cache
            torch.cuda.empty_cache()
            agree = logit_agreement(last, ref)
            del agree["plain_top2_gap"]
            out["float32_vs_one_rank"] = agree
            check(agree["max_abs"] <= FSDP_LOGIT_REL * agree["max_logit"],
                  f"{FSDP_ARCH} data = 2 float32 prefill against one rank: "
                  f"{agree}")
    _dist_sync(dev)
    out["wall_s"] = time.perf_counter() - t_all
    return out


def dist_fsdp_train(dev) -> dict:
    """(e) qwen2.5-32b at its published widths, ``FSDP_TRAIN_LAYERS``
    layers, on data = 2, batch 4 x 1 024 (two rows a rank): every leaf's
    gradient nonzero and finite, then one bf16 AdamW step (time, peak
    memory, held bytes of parameters and moments, FSDP gathers and
    reduce-scatters against the predicted counts, launches); rank 0 then
    runs ``loss_and_grads`` on one rank with the same seeded weights (the
    other rank waits) and holds the step's loss within ``DIST_LOSS_REL``
    and its grad norm within ``DIST_GNORM_REL``."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.models import ModelDims, get_arch
    from repro_torch.models.steps import (batch_to_device, loss_and_grads,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.optim.tree import tree_flatten_with_paths
    cfg = dataclasses.replace(get_arch(FSDP_ARCH),
                              n_layers=FSDP_TRAIN_LAYERS)
    dims = ModelDims.create(cfg)
    par = _dist_parallel(cfg, (DIST_WORLD, 1), TRAIN_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_all = time.perf_counter()
    params = _dist_params(cfg, dims, par, dev, torch.bfloat16)
    pspecs = shd.param_specs(cfg, params)
    want = _fsdp_want(params, pspecs, par)
    batch = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0)
    rows = batch_to_device({k: tpl.local_rows(v, par)
                            for k, v in batch.items()}, dev)
    (_, grads), c_grads = _coll_delta(lambda: loss_and_grads(
        cfg, dims, params, rows, remat=True, par=par))
    bad = [p for p, g in tree_flatten_with_paths(grads)
           if not (bool(torch.isfinite(g.float()).all())
                   and bool((g != 0).any()))]
    check(not bad, f"data = 2 training: zero or non-finite gradients {bad}")
    out = {"layers": FSDP_TRAIN_LAYERS,
           "gathers_grads": _fsdp_calls(c_grads, want, 2, "loss_and_grads")}
    del grads, rows
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    state, _ = tpl.init_opt_state(opt, params, par)
    step = make_train_step(cfg, dims, opt, remat=True, device=dev, par=par)
    zero_lm_counts()
    _dist_sync(dev)
    t0 = time.perf_counter()
    (params, state, m), c_step = _coll_delta(lambda: step(params, state,
                                                          batch))
    out["loss"], out["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    _dist_sync(dev)
    out["step_s"] = time.perf_counter() - t0
    out["launches_step"] = lm_counts()
    check(out["launches_step"]["flash_attention"] == 2 * cfg.n_layers
          and out["launches_step"]["flash_attention_bwd"] == cfg.n_layers,
          f"data = 2 training launches {out['launches_step']}")
    out["gathers_step"] = _fsdp_calls(c_step, want, 2, "train step")
    out["coll_train_step"] = c_step
    out["held"] = _held_bytes(params, pspecs, par)
    out["held_moments"] = {k: _held_bytes(state[k], pspecs, par)
                           for k in ("mu", "nu")}
    # each FSDP leaf's moments are its parameter block's shape, no less
    cut = []
    shd.tree_map_specs(lambda p, s, mu, nu: cut.append(
        tuple(p.shape) != tuple(mu.shape) or tuple(p.shape) != tuple(
            nu.shape)) if par.fsdp_leaf(s) else None,
        params, pspecs, state["mu"], state["nu"])
    check(len(cut) == want["calls"] and not any(cut),
          f"data = 2 training: {sum(cut)} of {len(cut)} FSDP leaves' "
          "moments are not their parameter block's shape")
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del params, state, m, step
    torch.cuda.empty_cache()
    _dist_sync(dev)
    out["wall_s"] = time.perf_counter() - t_all
    if torch.distributed.get_rank() == 0:
        params = _dist_params(cfg, dims, None, dev, torch.bfloat16)
        ref_loss, grads = loss_and_grads(cfg, dims, params,
                                         batch_to_device(batch, dev),
                                         remat=True)
        ref_loss, ref_norm = float(ref_loss), float(adamw.global_norm(grads))
        del params, grads
        torch.cuda.empty_cache()
        out["one_rank"] = {
            "loss": ref_loss, "grad_norm": ref_norm,
            "loss_rel": abs(out["loss"] - ref_loss) / abs(ref_loss),
            "grad_norm_rel": abs(out["grad_norm"] - ref_norm) / ref_norm}
        check(out["one_rank"]["loss_rel"] <= DIST_LOSS_REL
              and out["one_rank"]["grad_norm_rel"] <= DIST_GNORM_REL,
              f"data = 2 first step (loss {out['loss']}, grad norm "
              f"{out['grad_norm']}) against one rank: {out['one_rank']}")
    _dist_sync(dev)
    return out


def dist_rank(rank: int, parts: str = "abcde") -> dict:
    """Phase 16's rank (a ``launch.mesh.spawn`` process): the backend and
    gloo's CUDA probe, then (a) to (d), each part's numbers with its wall
    time."""
    from repro_torch.distributed import collectives as coll
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "backend": coll.backend(),
           "gloo_cuda_ops": sorted(coll.GLOO_CUDA_OPS)}
    if out["backend"] == "gloo":
        out["gloo_cuda_probe"] = coll.probe_gloo_cuda(dev)
    if "a" in parts:
        for arch in DIST_SERVE:
            out[f"serve {arch} tp2"] = dist_serve(arch, dev)
    if "b" in parts:
        out["train minitron tp2"] = dist_train_tp(dev)
    if "c" in parts:
        out["train xlstm dp2"] = dist_train_dp(dev)
    if "d" in parts:
        out["compressed_psum"] = dist_psum(dev)
    if "e" in parts:
        out[f"serve {FSDP_ARCH} data2"] = dist_fsdp_serve(dev)
        out[f"train {FSDP_ARCH} data2"] = dist_fsdp_train(dev)
    return out


def dist_launches(dist: dict, name: str) -> dict:
    """Phase 16's launches of LM kernel ``name`` on rank 0, by path (none
    for the scheduler's kernels, which phase 16 does not run)."""
    if name not in lm_counts():
        return {}
    r = dist["ranks"][0]
    out = {}
    for arch in DIST_SERVE:
        part = r.get(f"serve {arch} tp2")
        if part:
            out[f"serve_{arch}_tp2_prefill_rank0"] = part[
                "launches_prefill"][name]
            out[f"serve_{arch}_tp2_decode_31_steps_rank0"] = part[
                "launches_decode"][name]
    if "train minitron tp2" in r:
        out[f"train_{DIST_TP_TRAIN_ARCH}_{DIST_TP_TRAIN_LAYERS}_layers_tp2_"
            "step_rank0"] = r["train minitron tp2"]["launches_step"][name]
    if "train xlstm dp2" in r:
        out["train_xlstm-350m_dp2_step_rank0"] = r["train xlstm dp2"][
            "launches_step"][name]
    if f"serve {FSDP_ARCH} data2" in r:
        out[f"serve_{FSDP_ARCH}_{FSDP_SERVE_LAYERS}_layers_data2_prefill_"
            f"and_{FSDP_GEN - 1}_decode_steps_rank0"] = r[
            f"serve {FSDP_ARCH} data2"]["launches_serve"][name]
        out[f"train_{FSDP_ARCH}_{FSDP_TRAIN_LAYERS}_layers_data2_step_"
            "rank0"] = r[f"train {FSDP_ARCH} data2"]["launches_step"][name]
    return {k: v for k, v in out.items() if v}


def distributed_phase(smi: str, parts: str = "abcde") -> dict:
    """Phase 16: ``DIST_WORLD`` spawned ranks on the card (gloo: NCCL
    refuses two ranks on one device; NCCL where each rank has a card),
    ``parts`` of (a)-(e) on each; the parent checks that every rank ended
    with the same tokens, losses and grad norms and prints each rank's
    numbers.  Correctness runs of two ranks sharing one card, not scaling
    figures."""
    from repro_torch.launch.mesh import backend_for, spawn
    torch.cuda.empty_cache()
    gib = 2 ** 30
    print(f"  this process holds {torch.cuda.memory_allocated() / gib:.3f} "
          f"GiB allocated, {torch.cuda.memory_reserved() / gib:.3f} GiB "
          "reserved of the card while the ranks run")
    backend = backend_for(torch.device("cuda"), DIST_WORLD)
    t0 = time.perf_counter()
    ranks = spawn(dist_rank, DIST_WORLD, parts, timeout_s=DIST_WALL_S,
                  backend=backend)
    wall = time.perf_counter() - t0
    for key in [f"serve {a} tp2" for a in DIST_SERVE] + [
            f"serve {FSDP_ARCH} data2"]:
        if key in ranks[0]:
            check(all(r[key]["tokens"] == ranks[0][key]["tokens"]
                      for r in ranks), f"{key}: ranks' tokens differ")
    # a gradient not summed over the ranks shows as grad norms that differ
    for key, ms in (("train minitron tp2", ("losses", "grad_norms")),
                    ("train xlstm dp2", ("losses", "grad_norms")),
                    (f"train {FSDP_ARCH} data2", ("loss", "grad_norm"))):
        for m in ms if key in ranks[0] else ():
            check(all(r[key][m] == ranks[0][key][m] for r in ranks),
                  f"{key}: ranks' {m} differ "
                  f"{[r[key][m] for r in ranks]}")
    staged = collections.Counter()
    for r in ranks:
        for part in r.values():
            for key, st in (part.items() if isinstance(part, dict) else ()):
                if key.startswith("coll"):
                    staged.update({op: v["staged"] for op, v in st.items()
                                   if v.get("staged")})
    staged = dict(staged)
    print(f"  {smi}; {DIST_WORLD} ranks share the card "
          f"(correctness runs, not scaling figures); backend "
          f"{ranks[0]['backend']}, gloo CUDA probe "
          f"{ranks[0].get('gloo_cuda_probe')}; staged through the host: "
          f"{staged or 'nothing'}; phase wall {wall:.1f} s")
    for r in ranks:
        print(f"  rank {r['rank']}: " + json.dumps(
            {k: v for k, v in r.items() if k not in ("rank",)}))
    return {"backend": ranks[0]["backend"], "wall_s": wall,
            "ranks": ranks, "staged": staged}


# ---------------------------------------------------------------------------
# phase 17: the dry-run tools (launch.cells, launch.dryrun, analysis.
# roofline) on meta, and the cells the card can run
# ---------------------------------------------------------------------------

DRYRUN_ARG = "--dryrun-phase"
# (a): the hill-climb's three baseline cells, one prefill_32k cell and one
# long_500k cell, rank 0 of the 16x16 mesh traced on meta
DRYRUN_CELLS = (("qwen2.5-32b", "train_4k"), ("arctic-480b", "train_4k"),
                ("minitron-8b", "decode_32k"), ("minitron-8b", "prefill_32k"),
                ("zamba2-2.7b", "long_500k"))
# (b): xlstm-350m's cells on a 1 x 1 mesh, run on the card where they fit
DRYRUN_CARD_SHAPES = ("decode_32k", "prefill_32k", "long_500k")
DRYRUN_REPS = 3


def _dryrun_card_cell(cell, rec, dev, smi) -> dict:
    """A cell of (b) run on the card at its own shapes with seeded bf16
    weights through the kernels: ``cuda_ms``' median of ``DRYRUN_REPS``
    calls (after its three warm-up calls), the card's peak memory over
    them above what the process held before the cell, the LM kernels'
    launches a call; each figure beside the record's roofline time,
    analytic total and traced peak."""
    from repro_torch.analysis import roofline
    from repro_torch.launch.platform import device_fetch
    from repro_torch.models import ModelDims, get_arch, init_params
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import init_cache
    cfg = get_arch(cell.arch)
    dims = ModelDims.create(cfg)
    g = torch.Generator(device=dev).manual_seed(17)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()    # the earlier phases' tensors
    params = init_params(cfg, dims, generator=g)
    B, S = cell.batch, cell.seq
    if cell.kind == "decode":
        cache = init_cache(cfg, dims, B, S, torch.bfloat16, dev)
        tokens = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev)
        step = make_decode_step(cfg, dims)

        def call():
            return step(params, tokens, cache, S - 1)[0]
    else:
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
        step = make_prefill_step(cfg, dims, S)

        def call():
            return step(params, {"tokens": tokens})[0]
    calls = 3 + DRYRUN_REPS          # cuda_ms' warm-up calls and its own
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_lm_counts()
        ms = cuda_ms(call, DRYRUN_REPS)
        counts = {k: v // calls for k, v in lm_counts().items() if v}
        logits = call()
    peak = torch.cuda.max_memory_allocated() - held
    finite, = device_fetch(torch.isfinite(logits.float()).all())
    check(tuple(logits.shape) == (B, dims.vocab_pad) and bool(finite),
          f"{cell.arch} {cell.shape} on the card: logits "
          f"{tuple(logits.shape)}, finite {bool(finite)}")
    check(dev.type != "cuda" or counts.get("slstm") == cfg.n_super_blocks,
          f"{cell.arch} {cell.shape}: launches a call {counts}, want "
          f"{cfg.n_super_blocks} slstm")
    del params, logits
    torch.cuda.empty_cache()
    roof_s = roofline.terms(rec)["roofline_s"]
    analytic = rec["analytic_memory"]["total"]
    traced = rec["memory"]["peak_per_device"]
    out = {"median_ms": ms, "peak_bytes": peak,
           "roofline_s": roof_s, "over_roofline": ms / 1e3 / roof_s,
           "analytic_total": analytic, "peak_over_analytic": peak / analytic,
           "traced_peak": traced, "peak_over_traced": peak / traced,
           "launches_per_call": counts}
    print(f"17b {cell.arch} x {cell.shape} (batch {B}, {S} positions, bf16, "
          f"seeded weights, 1 x 1) on the card: median {ms:.4f} ms of "
          f"{DRYRUN_REPS} calls (CUDA events) = "
          f"{out['over_roofline']:.2f} x the roofline's {roof_s * 1e3:.4f} "
          f"ms; peak {peak / 2**30:.3f} GiB = {out['peak_over_analytic']:.3f}"
          f" x the analytic {analytic / 2**30:.3f} GiB and "
          f"{out['peak_over_traced']:.3f} x the traced {traced / 2**30:.3f} "
          f"GiB; launches a call {counts}; on {smi}")
    return out


def _train_trace(name: str) -> dict:
    """Phase 14's full-width training step (seeded bf16 weights, AdamW with
    float32 moments, remat "nothing", batch 4 x 1024) traced on meta:
    its dot FLOPs, recompute included, and its parameter count."""
    from repro_torch.launch import cells, dryrun
    from repro_torch.models import ModelDims, get_arch, make_train_step
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.optim.tree import tree_leaves
    cfg = get_arch(name)
    dims = ModelDims.create(cfg)
    params = cells.param_shapes(cfg, dims)
    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100)
    step = make_train_step(cfg, dims, opt, remat=True,
                           remat_policy="nothing", device=cells.META)
    batch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64,
                            device=cells.META) for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    cost, _ = dryrun.trace(step, (params, adamw.init_state(opt, params),
                                  batch))
    return {"dot_flops": cost.dot_flops, "flops": cost.flops,
            "params": sum(p.numel() for p in tree_leaves(params)),
            "trace_s": time.perf_counter() - t0}


def dryrun_phase(dev, smi, trained=None) -> dict:
    """Phase 17: (a) ``DRYRUN_CELLS`` traced on meta as rank 0 of the
    16x16 mesh (``launch.dryrun.run_cell``): cost, collectives by group,
    the roofline terms at the card's figures, analytic memory, trace time;
    (b) xlstm-350m's ``DRYRUN_CARD_SHAPES`` on a 1 x 1 mesh, each traced,
    then run on the card at its own shapes where its traced peak and
    analytic total fit the card (``_dryrun_card_cell``), else reported as
    not fitting; (c) phase 14's two full-width training steps traced on
    meta: their dot FLOPs, ``hfu`` (those FLOPs, recompute included, over
    the step time at the bf16 peak) and ``mfu`` (6 N T over the same), at
    phase 14's measured step time (``trained``; without it, as when the
    phase runs alone, both steps are trained here as phase 14 trains
    them)."""
    from repro_torch.analysis import roofline
    from repro_torch.launch import cells, dryrun
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models import get_arch
    t_phase = time.perf_counter()
    out = {"cells": {}, "card": {}, "training": {}, "launches": {}}
    mesh = make_production_mesh()
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(cells.Cell(arch, shape), mesh,
                              "single_pod_16x16")
        terms = roofline.terms(rec)
        check(rec["cost"]["dot_flops"] > 0 and terms["roofline_s"] > 0
              and rec["memory"]["peak_per_device"] > 0
              and math.isfinite(terms["roofline_s"]),
              f"17a {arch} x {shape}: record {rec['cost']}, {terms}")
        # a batch of one over replicated weights (zamba2's long_500k)
        # needs none
        check(rec["collectives"]["by_group"] != {} or cells.Cell(
            arch, shape).batch == 1, f"17a {arch} x {shape}: no collective "
            "on the 16x16 mesh")
        out["cells"][f"{arch} {shape}"] = {
            "cost": rec["cost"], "by_group": rec["collectives"]["by_group"],
            "terms": terms, "analytic_memory": rec["analytic_memory"],
            "memory": rec["memory"], "trace_s": rec["trace_s"]}
        print(f"17a {arch} x {shape}, rank 0 of 16x16 traced on meta (the "
              f"plain path): cost {rec['cost']}; collectives by group "
              f"{rec['collectives']['by_group']}; roofline at the card's "
              f"figures: compute {terms['compute_s']:.6g} s, memory "
              f"{terms['memory_s']:.6g} s, collective "
              f"{terms['collective_s']:.6g} s, bound by "
              f"{terms['bottleneck']}; analytic memory "
              f"{rec['analytic_memory']}; traced memory {rec['memory']}; "
              f"trace {rec['trace_s']} s; figures of {smi}")
    one = make_mesh((1, 1), ("data", "model"))
    for shape in DRYRUN_CARD_SHAPES:
        cell = cells.Cell(XLSTM_ARCH, shape)
        rec = dryrun.run_cell(cell, one, "1x1")
        am, traced = rec["analytic_memory"], rec["memory"]["peak_per_device"]
        fits = am[dryrun.FIT_KEY] and traced < dryrun.CARD_MEMORY_BYTES
        if not fits:
            out["card"][shape] = {"fits": False, "analytic_total": am[
                "total"], "traced_peak": traced}
            print(f"17b {XLSTM_ARCH} x {shape} (1 x 1) does not fit the "
                  f"card: traced peak {traced / 2**30:.3f} GiB, analytic "
                  f"{am['total'] / 2**30:.3f} GiB, against "
                  f"{dryrun.CARD_MEMORY_BYTES / 2**30:.3f} GiB; not run")
            continue
        out["card"][shape] = {"fits": True, **_dryrun_card_cell(
            cell, rec, dev, smi)}
        out["launches"][f"dryrun_{XLSTM_ARCH}_{shape}"] = out["card"][
            shape]["launches_per_call"]
    check(any(r["fits"] for r in out["card"].values()),
          "17b: no xlstm-350m cell fits the card")
    for name, key in ((TRAIN_ARCH, "zamba2_full_width"),
                      (XLSTM_ARCH, "xlstm_full_width")):
        if trained is None:
            cfg = get_arch(name)
            measured = full_width_training(
                name, cfg, lambda cfg=cfg: training_setup(cfg, dev),
                TRAIN_LAUNCHES if name == TRAIN_ARCH
                else XLSTM_TRAIN_LAUNCHES, dev, smi, None)
        else:
            measured = trained[key]
        step_s = measured["median_step_s"]
        t = _train_trace(name)
        check(t["params"] == measured["params"],
              f"{name}: traced {t['params']} parameters, trained "
              f"{measured['params']}")
        six_nt = 6 * t["params"] * TRAIN_BATCH * TRAIN_SEQ
        rec = {**t, "step_s": step_s, "six_nt": six_nt,
               "hfu": t["dot_flops"] / (step_s * roofline.PEAK_FLOPS),
               "mfu": six_nt / (step_s * roofline.PEAK_FLOPS)}
        out["training"][name] = rec
        print(f"17c {name} training step (batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, remat 'nothing', phase 14's): traced dot FLOPs "
              f"{t['dot_flops']:.6g} (recompute included; {t['flops']:.6g} "
              f"FLOP in all), 6 N T {six_nt:.6g}; step {step_s:.4f} s: hfu "
              f"{100 * rec['hfu']:.2f}%, mfu {100 * rec['mfu']:.2f}% of "
              f"{roofline.PEAK_FLOPS / 1e12:.1f} TFLOP/s; trace "
              f"{t['trace_s']:.1f} s; on {smi}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 17 took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: Megatron sequence parallelism, the model-major expert layout and
# gradients through a KV-cache mask
# ---------------------------------------------------------------------------

SP_ARG = "--seq-parallel-phase"
SP_ARCH = "qwen2.5-32b"
SP_TRAIN_LAYERS = 1          # AdamW's 22 B a parameter, two ranks a card
SP_SERVE_LAYERS = 2
SP_DECODE_ARCH = "minitron-8b"
SP_DECODE_LAYERS = 8
SP_GEN = 8
MM_ARCH = "arctic-480b"
MM_LAYERS = 1
# the default and the model-major layouts' bf16 logits: max |mm - default|
# <= MM_LOGIT_REL * max |default| (each rounds the experts' sums to bf16
# at another point: the default layout adds two bf16 halves of d_ff)
MM_LOGIT_REL = 2e-2
# SP against the same run without it: float32 logits relative to the
# largest, as phase 16 holds tp = 2 against one rank
SP_LOGIT_REL = 1e-3
# and the summed bf16 gradient of each leaf that no spec shards over
# 'model' (the norm scales): |sp - tp| / |tp| in L2.  SP sums the two
# ranks' blocks where tp = 2 sums the whole sequence on each rank, a bf16
# rounding apart (2^-8 of an entry at most); a rank's block alone, not
# summed over 'model', is about half the sum (off by 0.5 or more)
SP_LEAF_REL = 1e-2
# (B, Sq, Skv, Hq, Hkv, D): zamba2-2.7b's and qwen2.5-32b's heads
CACHE_BWD_SHAPES = {"zamba2-2.7b": (4, 256, 1024, 32, 32, 80),
                    SP_ARCH: (4, 256, 1024, 40, 8, 128)}
CACHE_MASK = {"q_offset": 768, "kv_len": 900}


def _sp_par(cfg, mesh, batch, **kw):
    from repro_torch.distributed import tensor_parallel as tpl
    return tpl.make_parallel(cfg, mesh, batch, **kw)


def _drawn_shards(cfg, dims, par, dev, dtype, seed) -> dict:
    """Seeded weights of the rank's shards drawn where they live, a leaf
    (an expert at a time) after another: arctic's layer would need its
    26.8 GB of bf16 experts, and more in float32, drawn whole on each rank
    before its cut.  Norm scales 1, biases 0, the embedding N(0, 0.02),
    every other leaf N(0, 1 / rows).  Both layouts of (b) run on these."""
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.launch.cells import param_shapes
    from repro_torch.optim.tree import tree_flatten_with_paths, \
        tree_unflatten
    shapes = param_shapes(cfg, dims, dtype, lambda path, tree:
                          tpl.shard_params(cfg, tree, par, path))
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = []
    for path, t in tree_flatten_with_paths(shapes):
        name = path.split("/")[-1]
        out = torch.empty(t.shape, dtype=t.dtype, device=dev)
        if name == "scale":
            out.fill_(1.0)
        elif name == "b" or out.numel() == 0:
            out.zero_()
        else:
            scale = 0.02 if name == "embed" else 1 / math.sqrt(
                max(t.shape[-2] if t.dim() > 1 else 1, 1))
            for part in (out if out.dim() == 3 else (out,)):
                part.copy_(torch.randn(part.shape, generator=g, device=dev)
                           * scale)
        leaves.append(out)
    return tree_unflatten(shapes, leaves)


def _replicated_grads(cfg, dims, params, batch, par, dev) -> dict:
    """The gradients of the leaves that no spec shards over 'model' (the
    norm scales), summed over the ranks as the train step sums them
    (``loss_and_grads``, then ``reduce_grads``): ``{path: float32 on the
    host}``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.models.steps import batch_to_device, loss_and_grads
    from repro_torch.optim.tree import tree_flatten_with_paths, tree_leaves
    _, grads = loss_and_grads(cfg, dims, params, batch_to_device(batch, dev),
                              remat=True, par=par)
    specs = shd.param_specs(cfg, grads)
    grads = tpl.reduce_grads(grads, specs, par)
    keep = tree_leaves(shd.tree_map_specs(
        lambda g, s: "model" not in shd.P(*s).axes(), grads, specs))
    return {p: g.float().cpu() for (p, g), k in zip(
        tree_flatten_with_paths(grads), keep) if k}


def _replicated_agree(got: dict, want: dict) -> dict:
    """SP's replicated gradients against tp = 2's: each leaf's relative L2
    difference (the worst) and the norm of all of them on each side."""
    check(want and got.keys() == want.keys(), f"replicated gradient "
          f"leaves {sorted(got)} against {sorted(want)}")
    norm = {p: float(torch.linalg.vector_norm(g)) for p, g in want.items()}
    check(all(n > 0 for n in norm.values()), f"a replicated gradient is "
          f"zero under tp = 2: {norm}")
    rel = {p: float(torch.linalg.vector_norm(got[p] - want[p])) / norm[p]
           for p in want}
    worst = max(rel, key=rel.get)

    def total(tree):
        return math.sqrt(sum(float(torch.sum(torch.square(g)))
                             for g in tree.values()))
    return {"leaves": len(rel), "rel_max": rel[worst], "worst": worst,
            "norm_sp": total(got), "norm_tp": total(want),
            "bit_equal": all(torch.equal(got[p], want[p]) for p in want)}


def sp_train(dev) -> dict:
    """(a) qwen2.5-32b, ``SP_TRAIN_LAYERS`` layers at published widths, tp
    = 2: one bf16 AdamW step without and with sequence parallelism on the
    same seeded weights and batch (loss, grad norm, time, peak memory,
    launches, collectives); SP's loss and grad norm held to the other's,
    and before the step each run's summed gradients of the replicated
    leaves (``_replicated_grads``) held to each other within
    ``SP_LEAF_REL``."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.launch.mesh import RankMesh, make_mesh
    from repro_torch.models import ModelDims, get_arch
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_arch(SP_ARCH), n_layers=SP_TRAIN_LAYERS)
    dims = ModelDims.create(cfg, DIST_WORLD)
    mesh = RankMesh(make_mesh((1, DIST_WORLD), ("data", "model")))
    batch = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    out = {"layers": SP_TRAIN_LAYERS}
    replicated = {}
    for sp in (False, True):
        par = _sp_par(cfg, mesh, TRAIN_BATCH, seq_parallel=sp)
        check(par.sp == sp, f"{SP_ARCH} 1 x 2 seq_parallel={sp}: par.sp "
              f"{par.sp}")
        torch.cuda.empty_cache()
        params = _dist_params(cfg, dims, par, dev, torch.bfloat16)
        replicated[sp] = _replicated_grads(cfg, dims, params, batch, par,
                                           dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state, _ = tpl.init_opt_state(opt, params, par)
        step = make_train_step(cfg, dims, opt, remat=True, device=dev,
                               par=par)
        zero_lm_counts()
        _dist_sync(dev)
        t0 = time.perf_counter()
        (params, state, m), stats = _coll_delta(
            lambda: step(params, state, batch))
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        _dist_sync(dev)
        rec["step_s"] = time.perf_counter() - t0
        rec["launches_step"] = lm_counts()
        rec["coll_train_step"] = stats
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        check(rec["launches_step"]["flash_attention"] == 2 * cfg.n_layers
              and rec["launches_step"]["flash_attention_bwd"]
              == cfg.n_layers, f"{SP_ARCH} sp={sp} training launches "
              f"{rec['launches_step']}")
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"{SP_ARCH} sp={sp} step: {rec}")
        out["sp" if sp else "tp"] = rec
        del params, state, m, step
        torch.cuda.empty_cache()
    sp, tp = out["sp"], out["tp"]
    check("sp_reduce_scatter" in sp["coll_train_step"]
          and "sp_reduce_scatter" not in tp["coll_train_step"],
          f"SP collectives {sorted(sp['coll_train_step'])}")
    out["loss_rel"] = abs(sp["loss"] - tp["loss"]) / abs(tp["loss"])
    out["grad_norm_rel"] = abs(sp["grad_norm"] - tp["grad_norm"]) / \
        tp["grad_norm"]
    check(out["loss_rel"] <= DIST_LOSS_REL
          and out["grad_norm_rel"] <= DIST_GNORM_REL,
          f"{SP_ARCH} SP step against tp = 2 alone: {out}")
    out["replicated_grads"] = _replicated_agree(replicated[True],
                                                replicated[False])
    check(out["replicated_grads"]["rel_max"] <= SP_LEAF_REL,
          f"{SP_ARCH} SP's summed gradients of the replicated leaves "
          f"against tp = 2's: {out['replicated_grads']}")
    _dist_sync(dev)
    return out


def sp_serve(dev) -> dict:
    """(a) qwen2.5-32b, ``SP_SERVE_LAYERS`` layers, float32 prefill of batch
    4 x 1 024 without and with SP (logits held); minitron-8b,
    ``SP_DECODE_LAYERS`` layers, bf16 prefill and ``SP_GEN`` greedy tokens
    without and with SP (the same tokens but on an exactly tied row)."""
    from repro_torch.launch.mesh import RankMesh, make_mesh
    from repro_torch.models import ModelDims, get_arch
    from repro_torch.models.steps import make_decode_step, make_prefill_step
    from repro_torch.models.testing import synth_batch
    mesh = RankMesh(make_mesh((1, DIST_WORLD), ("data", "model")))
    out = {}
    cfg = dataclasses.replace(get_arch(SP_ARCH), n_layers=SP_SERVE_LAYERS,
                              dtype="float32")
    dims = ModelDims.create(cfg, DIST_WORLD)
    batch = synth_batch(cfg, batch=4, seq=1024, seed=0, device=dev)
    batch.pop("labels")
    logits = {}
    with torch.inference_mode():
        for sp in (False, True):
            par = _sp_par(cfg, mesh, 4, seq_parallel=sp)
            params = _dist_params(cfg, dims, par, dev, torch.float32)
            zero_lm_counts()
            _dist_sync(dev)
            t0 = time.perf_counter()
            (last, _), stats = _coll_delta(lambda: make_prefill_step(
                cfg, dims, 1024, par=par)(params, batch))
            _dist_sync(dev)
            key = "sp" if sp else "tp"
            out[f"prefill_{key}"] = {
                "s": time.perf_counter() - t0, "launches": lm_counts(),
                "coll": stats}
            check(out[f"prefill_{key}"]["launches"]["flash_attention"]
                  == cfg.n_layers, f"{SP_ARCH} prefill sp={sp} launches "
                  f"{out[f'prefill_{key}']['launches']}")
            logits[key] = last.float().cpu()
            del params
            torch.cuda.empty_cache()
    agree = logit_agreement(logits["sp"], logits["tp"])
    del agree["plain_top2_gap"]
    out["prefill_f32_sp_vs_tp"] = agree
    check(agree["max_abs"] <= SP_LOGIT_REL * agree["max_logit"],
          f"{SP_ARCH} float32 SP prefill against tp = 2 alone: {agree}")
    cfg = dataclasses.replace(get_arch(SP_DECODE_ARCH),
                              n_layers=SP_DECODE_LAYERS)
    dims = ModelDims.create(cfg, DIST_WORLD)
    batch = synth_batch(cfg, batch=4, seq=1024, seed=0, device=dev)
    batch.pop("labels")
    runs = {}
    with torch.inference_mode():
        for sp in (False, True):
            par = _sp_par(cfg, mesh, 4, seq_parallel=sp)
            params = _dist_params(cfg, dims, par, dev, torch.bfloat16)
            zero_lm_counts()
            _dist_sync(dev)
            t0 = time.perf_counter()
            runs[sp] = _greedy(make_prefill_step(cfg, dims, 1024 + SP_GEN,
                                                 par=par),
                               make_decode_step(cfg, dims, par=par), params,
                               batch, SP_GEN)
            _dist_sync(dev)
            key = "sp" if sp else "tp"
            out[f"decode_{key}"] = {"s": time.perf_counter() - t0,
                                    "launches": lm_counts(),
                                    "coll_decode_step": runs[sp][3]}
            check(out[f"decode_{key}"]["launches"]["flash_attention"]
                  == cfg.n_layers, f"{SP_DECODE_ARCH} sp={sp} launches "
                  f"{out[f'decode_{key}']['launches']}")
            del params
            torch.cuda.empty_cache()
    (tok_sp, top2_sp, _, c_dec), (tok_tp, top2_tp, _, _) = runs[True], \
        runs[False]
    check("sp_reduce_scatter" in c_dec, f"SP decode step collectives "
          f"{sorted(c_dec)}")
    parted = _tokens_agree(tok_sp, tok_tp, top2_sp, top2_tp)
    out["decode_tokens"] = {"sp": tok_sp, "tp": tok_tp, "parted": parted}
    check(all(p["tied"] for p in parted.values()),
          f"{SP_DECODE_ARCH} SP tokens {tok_sp} against {tok_tp}: rows "
          f"{parted} part off a tie")
    _dist_sync(dev)
    return out


def mm_serve(dev) -> dict:
    """(b) arctic-480b at its published widths, ``MM_LAYERS`` layer, tp = 2:
    a bf16 prefill of batch 4 x 1 024 in the default expert layout (every
    expert on the rank's d_ff columns) and in the model-major one (the
    rank's 64 experts whole, brought there by one all-to-all a leaf), on
    the same seeded weights; logits held to each other, peak memory and
    time of each."""
    from repro_torch.launch.mesh import RankMesh, make_mesh
    from repro_torch.models import ModelDims, get_arch
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.models.testing import synth_batch
    cfg = dataclasses.replace(get_arch(MM_ARCH), n_layers=MM_LAYERS)
    dims = ModelDims.create(cfg, DIST_WORLD)
    mesh = RankMesh(make_mesh((1, DIST_WORLD), ("data", "model")))
    batch = synth_batch(cfg, batch=4, seq=1024, seed=0, device=dev)
    batch.pop("labels")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"layers": MM_LAYERS}
    par = _sp_par(cfg, mesh, 4)
    with torch.inference_mode():
        params = _drawn_shards(cfg, dims, par, dev, torch.bfloat16, 0)
        out["expert_gb_rank"] = sum(
            t.numel() * t.element_size()
            for n, t in params["layers"][0][0]["moe"].items()
            if n != "router") / 1e9
        out["params_gib_rank"] = torch.cuda.memory_allocated(dev) / 2 ** 30
        logits = {}
        for layout in ("default", "model_major"):
            par = _sp_par(cfg, mesh, 4, expert_axes=layout)
            check(par.model_major == (layout == "model_major"),
                  f"{MM_ARCH} expert_axes={layout}: {par.model_major}")
            torch.cuda.reset_peak_memory_stats(dev)
            zero_lm_counts()
            _dist_sync(dev)
            t0 = time.perf_counter()
            (last, _), stats = _coll_delta(lambda: make_prefill_step(
                cfg, dims, 1024, par=par)(params, batch))
            _dist_sync(dev)
            out[layout] = {"prefill_s": time.perf_counter() - t0,
                           "peak_gib": torch.cuda.max_memory_allocated(dev)
                           / 2 ** 30, "launches": lm_counts(),
                           "coll": stats}
            check(out[layout]["launches"]["flash_attention"] == MM_LAYERS,
                  f"{MM_ARCH} {layout} launches {out[layout]['launches']}")
            logits[layout] = last.float().cpu()
            torch.cuda.empty_cache()
    check(out["model_major"]["coll"]["expert_all_to_all"]["calls"]
          == 3 * MM_LAYERS and "expert_all_to_all" not in out["default"][
              "coll"], f"{MM_ARCH} all-to-alls: {out['model_major']['coll']}")
    agree = logit_agreement(logits["model_major"], logits["default"])
    del agree["plain_top2_gap"]
    out["model_major_vs_default"] = agree
    check(bool(torch.isfinite(logits["model_major"]).all())
          and agree["max_abs"] <= MM_LOGIT_REL * agree["max_logit"],
          f"{MM_ARCH} model-major bf16 logits against the default "
          f"layout's: {agree}")
    del params
    torch.cuda.empty_cache()
    _dist_sync(dev)
    return out


def sp_rank(rank: int, parts: str = "ab") -> dict:
    """Phase 18's rank: (a) and (b), each part with its wall time."""
    from repro_torch.distributed import collectives as coll
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "backend": coll.backend()}
    for key, part, fn in (("train sp", "a", sp_train),
                          ("serve sp", "a", sp_serve),
                          ("serve mm", "b", mm_serve)):
        if part in parts:
            t0 = time.perf_counter()
            out[key] = fn(dev)
            out[key]["wall_s"] = time.perf_counter() - t0
    return out


def flash_bwd_masked_record(q, k, v, o, do, lse, err, smi) -> dict:
    """``flash_attention_bwd`` under ``CACHE_MASK`` timed: kernel and plain
    per call (CUDA events), the bound of this mask's work, and the backward
    of ``F.scaled_dot_product_attention`` under the same boolean mask."""
    from repro_torch.kernels.flash_attention import (attention_bwd_plain,
                                                     flash_attention_bwd)
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse=lse,
                                             **CACHE_MASK))
    plain_ms = cuda_ms(lambda: attention_bwd_plain(q, k, v, o, do,
                                                   **CACHE_MASK), reps=5)
    b_ms, b_by = flash_bwd_bound_ms(q, k, True, **CACHE_MASK)
    Sq, Skv = q.shape[1], k.shape[1]
    kv_pos = torch.arange(Skv, device=q.device)
    q_pos = torch.arange(Sq, device=q.device) + CACHE_MASK["q_offset"]
    mask = (kv_pos[None, :] < CACHE_MASK["kv_len"]) & (
        kv_pos[None, :] <= q_pos[:, None])
    lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    lout = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, attn_mask=mask, enable_gqa=lq.shape[1] != lk.shape[1])
    ldo = do.transpose(1, 2)
    lib = torch.autograd.grad(lout, (lq, lk, lv), ldo, retain_graph=True)
    ref = attention_bwd_plain(q, k, v, o, do, **CACHE_MASK)
    lib_err = max((x.transpose(1, 2).float() - y.float()).abs().max().item()
                  for x, y in zip(lib, ref))
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lout, (lq, lk, lv), ldo, retain_graph=True))
    del lout, lib
    print(f"flash_attention_bwd under a cache mask (q {tuple(q.shape)} over "
          f"k/v {tuple(k.shape)} bf16, causal, {CACHE_MASK}): per call (CUDA "
          f"events, median of 25) kernel {ms:.6f} ms, plain {plain_ms:.6f} "
          f"ms; bound {b_ms:.6f} ms ({b_by}); the backward of "
          f"F.scaled_dot_product_attention under the same boolean mask "
          f"{lib_ms:.6f} ms (max |sdpa - plain| {lib_err:.4g}); on {smi}")
    return {"shape": [q.shape[0], Sq, Skv, q.shape[2], k.shape[2],
                      q.shape[3]], **CACHE_MASK, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def cache_grad_layer(g, dev) -> dict:
    """``attn_apply`` at qwen2.5-32b's widths (40 query heads over 8 kv,
    head_dim 128, bf16) writing 256 new rows into a 1 024-row cache at
    600 and differentiated through it: the kernels' launches (one forward,
    one backward, counted from 0), and the gradients of x, the weights and
    the cache's earlier rows held to the plain path's (``attention_plain``
    under autograd) within ``LM_TOL`` bf16 of their largest."""
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import layers
    B, S, L, idx = 4, 256, 1024, 600
    d, n_q, n_kv, hd = 5120, 40, 8, 128
    dims = layers.AttnDims(d_model=d, n_q=n_q, n_kv=n_kv, hd=hd)
    dt = torch.bfloat16
    p = {n: {"w": randn((d, m), g, dt, dev) / math.sqrt(d)} for n, m in (
        ("wq", n_q * hd), ("wk", n_kv * hd), ("wv", n_kv * hd))}
    p["wo"] = {"w": randn((n_q * hd, d), g, dt, dev) / math.sqrt(n_q * hd)}
    x = randn((B, S, d), g, dt, dev)
    cache = {n: randn((B, L, n_kv, hd), g, dt, dev) for n in ("k", "v")}
    dout = randn((B, S, d), g, dt, dev)
    positions = torch.arange(idx, idx + S, device=dev)[None]

    def run():
        leaves = {"x": x.clone().requires_grad_(),
                  **{n: p[n]["w"].clone().requires_grad_() for n in p},
                  **{f"cache_{n}": t.clone().requires_grad_()
                     for n, t in cache.items()}}
        out, _ = layers.attn_apply(
            {n: {"w": leaves[n]} for n in p}, leaves["x"], dims,
            causal=True, theta=1e6, positions=positions,
            cache={n: leaves[f"cache_{n}"].clone() for n in cache},
            cache_index=idx)
        out.backward(dout)
        return {n: t.grad for n, t in leaves.items()}
    zero_lm_counts()
    got = run()
    launches = lm_counts()
    check(launches["flash_attention"] == 1
          and launches["flash_attention_bwd"] == 1,
          f"attn_apply with a cache, differentiated: launches {launches}")
    real = layers.attention

    def plain(q, k, v, **kw):
        return attention_plain(q, k, v, **kw)
    layers.attention = plain
    try:
        want = run()
    finally:
        layers.attention = real
    errs = {n: kernel_err_of_max(got[n], want[n], f"attn_apply cache grad "
                                 f"d{n}", dt) for n in got}
    check(not got["cache_k"][:, idx:idx + S].any()
          and bool(got["cache_k"][:, :idx].any()),
          "attn_apply cache grad: the overwritten rows must get none, the "
          "earlier rows some")
    print(f"attn_apply with a cache at {SP_ARCH}'s widths (x [{B}, {S}, "
          f"{d}] written at {idx} of {L}, bf16), differentiated: launches "
          f"{launches}; max |kernel path - plain path| by gradient "
          f"{ {n: round(e, 6) for n, e in errs.items()} }")
    return {"launches": launches, "max_abs_err": errs}


def seq_parallel_phase(dev, smi, parts: str = "ab") -> dict:
    """Phase 18: (c) in this process, then (a) and (b) on ``DIST_WORLD``
    spawned ranks sharing the card; the parent checks the ranks agree."""
    from repro_torch.kernels.flash_attention import (attention_bwd_plain,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     lse_buffer)
    from repro_torch.launch.mesh import backend_for, spawn
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(18)
    out = {"cache_mask": {}}
    for arch, (B, Sq, Skv, Hq, Hkv, D) in CACHE_BWD_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            q, do = (randn((B, Sq, Hq, D), g, dt, dev) for _ in range(2))
            k, v = (randn((B, Skv, Hkv, D), g, dt, dev) for _ in range(2))
            lse = lse_buffer(q) if dt == torch.bfloat16 else None
            o = flash_attention(q, k, v, lse=lse, **CACHE_MASK)
            what = (f"flash_attention_bwd {arch} {(B, Sq, Skv, Hq, Hkv, D)} "
                    f"{CACHE_MASK} {dt}")

            def call():
                return flash_attention_bwd(q, k, v, o, do, lse=lse,
                                           **CACHE_MASK)
            got = call()
            ref = attention_bwd_plain(q, k, v, o, do, **CACHE_MASK)
            err = hold_grads(got, ref, dt, what)
            repeat_bits(call, got, what)
            kv_len = CACHE_MASK["kv_len"]
            check(not got[1][:, kv_len:].any() and not got[2][:, kv_len:]
                  .any(), f"{what}: keys past kv_len got a gradient")
            print(f"{what}: max |kernel - plain| {err!r}, a second call the "
                  "same bits, no gradient past kv_len")
            if arch == SP_ARCH and dt == torch.bfloat16:
                out["cache_mask"] = flash_bwd_masked_record(
                    q, k, v, o, do, lse, err, smi)
    out["cache_layer"] = cache_grad_layer(g, dev)
    torch.cuda.empty_cache()
    gib = 2 ** 30
    print(f"  this process holds {torch.cuda.memory_allocated() / gib:.3f} "
          f"GiB allocated, {torch.cuda.memory_reserved() / gib:.3f} GiB "
          "reserved of the card while the ranks run")
    backend = backend_for(torch.device("cuda"), DIST_WORLD)
    t0 = time.perf_counter()
    ranks = spawn(sp_rank, DIST_WORLD, parts, timeout_s=DIST_WALL_S,
                  backend=backend)
    out["ranks_wall_s"] = time.perf_counter() - t0
    r0 = ranks[0]
    if "a" in parts:
        for r in ranks:
            for m in ("loss", "grad_norm"):
                check(r["train sp"]["sp"][m] == r0["train sp"]["sp"][m],
                      f"SP training: ranks' {m} differ")
            check(r["serve sp"]["decode_tokens"]["sp"]
                  == r0["serve sp"]["decode_tokens"]["sp"],
                  "SP decode: ranks' tokens differ")
    for r in ranks:
        print(f"  rank {r['rank']}: " + json.dumps(
            {k: v for k, v in r.items() if k != "rank"}))
    out["ranks"] = ranks
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  {smi}; {DIST_WORLD} ranks share the card (correctness runs, "
          f"not scaling figures); backend {r0['backend']}; ranks' wall "
          f"{out['ranks_wall_s']:.1f} s, phase {out['phase_s']:.1f} s")
    return out


def sp_launches(sp: dict, name: str) -> dict:
    """Phase 18's launches of LM kernel ``name`` by path (rank 0's for the
    ranks' runs)."""
    if name not in lm_counts():
        return {}
    out = {}
    layer = sp.get("cache_layer", {}).get("launches", {})
    out["train_attn_apply_kv_cache_layer"] = layer.get(name, 0)
    r = sp.get("ranks", [{}])[0]
    if "train sp" in r:
        for key in ("tp", "sp"):
            out[f"train_{SP_ARCH}_{SP_TRAIN_LAYERS}_layer_tp2_{key}_step_"
                "rank0"] = r["train sp"][key]["launches_step"][name]
    if "serve sp" in r:
        for key in ("tp", "sp"):
            out[f"serve_{SP_ARCH}_{SP_SERVE_LAYERS}_layers_tp2_{key}_"
                "prefill_f32_rank0"] = r["serve sp"][f"prefill_{key}"][
                "launches"][name]
            out[f"serve_{SP_DECODE_ARCH}_{SP_DECODE_LAYERS}_layers_tp2_"
                f"{key}_prefill_and_{SP_GEN - 1}_decode_steps_rank0"] = r[
                "serve sp"][f"decode_{key}"]["launches"][name]
    if "serve mm" in r:
        for key in ("default", "model_major"):
            out[f"serve_{MM_ARCH}_{MM_LAYERS}_layer_tp2_{key}_prefill_"
                "rank0"] = r["serve mm"][key]["launches"][name]
    return {k: v for k, v in out.items() if v}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to measure")
    if sys.argv[1:] == [PROFILE_BWD_ARG]:
        profile_backward_kernels()
        return
    if sys.argv[1:] == [PROFILE_VLM_ARG]:
        profile_vlm_attention()
        return
    if sys.argv[1:] == [PROFILE_XLSTM_ARG]:
        profile_xlstm_kernels()
        return
    if sys.argv[1:] == [PROFILE_XLSTM_STEP_ARG]:
        profile_xlstm_step()
        return
    t_start = time.perf_counter()
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
                 "ssd_scan", "flash_attention_bwd", "ssd_scan_bwd",
                 "ssd_wide_bwd", "slstm"])
    print(f"kernel build {time.perf_counter() - t0:.3f} s "
          f"(nvcc: {build.build_seconds})")
    for name, log in build.build_log.items():
        for line in log.strip().splitlines():
            print(f"  [{name}] {line}")
    if sys.argv[1:] == [DRYRUN_ARG]:
        print(json.dumps(dryrun_phase(dev, smi)))
        return
    if sys.argv[1:2] == [SP_ARG]:
        phase("18 sequence parallelism, model-major experts, gradients "
              "through a KV-cache mask")
        sp = seq_parallel_phase(dev, smi, *sys.argv[2:3])
        print(json.dumps({k: v for k, v in sp.items() if k != "ranks"}))
        return

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

    phase("2f xLSTM's training kernels: ssd_wide_bwd, slstm and slstm_bwd "
          "against their plain versions, timed at xlstm-350m's shapes")
    xlstm_kernels = xlstm_kernels_phase(g, dev, smi)

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

    phase("15 VLM: llama-3.2-vision-90b at full width, depth cut to "
          f"{VLM_SUPER_BLOCKS} super-blocks, batch 4, prompt 1024, 32 tokens, "
          "bf16, greedy; the reduced VLM in float32 against the reference")
    vlm = vlm_phase(dev, smi)

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

    phase("14 training: the backward kernels, reduced zamba2 against the "
          "reference's steps, zamba2-2.7b at full width, the train driver")
    trained = training_phase(dev, smi)

    phase("16 distributed: two ranks on the card, minitron-8b and "
          "qwen2-moe-a2.7b served at tp = 2, minitron-8b trained at tp = 2, "
          "xlstm-350m at dp = 2 with ZeRO-1, compressed_psum")
    dist = distributed_phase(smi)

    phase("17 dry-run tools: the 16x16 cells traced on meta, xlstm-350m's "
          "cells on the card, phase 14's steps' hfu and mfu")
    dry = dryrun_phase(dev, smi, trained)

    phase("18 sequence parallelism and the model-major experts on two "
          "ranks, gradients through a KV-cache mask")
    seqp = seq_parallel_phase(dev, smi)

    phase("8 summary")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s to the "
          f"summary (phase 17 {dry['phase_s']:.1f} s, phase 18 "
          f"{seqp['phase_s']:.1f} s)")
    print(json.dumps({"distributed": {k: v for k, v in dist.items()
                                      if k != "ranks"}, "dryrun": dry,
                      "seq_parallel": {k: v for k, v in seqp.items()
                                       if k != "ranks"},
                      "portfolio": portfolio, "multimodel": pod,
                      "serve": served, "sync_witness": witness,
                      "vlm": {k: v for k, v in vlm.items()
                              if k != "kernels"},
                      "training": {k: v for k, v in trained.items()
                                   if k != "kernels"}}))
    kernels = [{
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
                "flash_attention"] for a in NEW_SERVE},
            f"serve_{VLM_ARCH}_{VLM_SUPER_BLOCKS}_super_blocks":
                vlm["launches"]["flash_attention"],
            "vlm_reduced_f32": vlm["reduced_f32_launches"]},
        "shapes": {**new_shapes["flash_attention"],
                   **{f"{a} tp=2": r for a, r in new_shapes[
                       "flash_attention_tp2"].items()},
                   **{f"{a} data=2": r for a, r in new_shapes[
                       "flash_attention_fsdp"].items()},
                   **{f"{VLM_ARCH} {k}": r
                      for k, r in vlm["kernels"].items()}},
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
        "shapes": {**new_shapes["ssd_scan"], "xlstm-350m dp=2": {
            "shape": list(XLSTM_SSD_DP2), "max_abs_err": new_shapes[
                "ssd_scan_dp2"]}},
    }, *({
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "launches": trained["zamba2_full_width"]["launches_timed_steps"][
            name],
        **trained["kernels"][name],
        **({"shapes": {"qwen2.5-32b data=2": trained["kernels"][
            "flash_attention_bwd_fsdp"]},
            "cache_mask": seqp["cache_mask"]} if name == "flash_attention_bwd"
           else {}),
        "launches_by_path": {
            "train_zamba2_step": trained["zamba2_full_width"][
                "launches_per_step"][name],
            f"train_zamba2_{TRAIN_TIMED}_steps": trained[
                "zamba2_full_width"]["launches_timed_steps"][name],
            "train_reduced_f32": trained["reduced_f32"]["launches"][name],
            "train_driver_3_runs": trained["driver"]["launches"][name]},
    } for name, replaces in (
        ("flash_attention_bwd", "src/repro/models/layers.py:94 (_sdpa, "
         "differentiated by jax.grad; no TPU kernel)"),
        ("ssd_scan_bwd", "src/repro/models/layers.py:314 (gla_chunked, "
         "differentiated by jax.grad; no TPU kernel)"))), *({
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
        "replaces": replaces,
        "launches": trained["xlstm_full_width"]["launches_timed_steps"][
            name],
        "design": design,
        **xlstm_kernels[name],
        "launches_by_path": {
            "train_xlstm_step": trained["xlstm_full_width"][
                "launches_per_step"][name],
            f"train_xlstm_{TRAIN_TIMED}_steps": trained[
                "xlstm_full_width"]["launches_timed_steps"][name],
            "train_xlstm_reduced_f32": trained["xlstm_reduced_f32"][
                "launches"][name],
            **({"serve_xlstm_prefill": served[XLSTM_ARCH][
                "launches_per_prefill"]["slstm"],
                "serve_xlstm_decode_step": served[XLSTM_ARCH][
                    "launches_per_decode_step"]["slstm"],
                "realize_xlstm-350m": pod[XLSTM_ARCH]["launches"]["slstm"]}
               if name == "slstm" else {})},
    } for name, source, replaces, design in (
        ("ssd_wide_bwd", "ssd_wide_bwd", "src/repro/models/layers.py:314 "
         "(gla_chunked, the mLSTM's numerator and normaliser, "
         "differentiated by jax.grad; no TPU kernel)",
         "redesigned for Hopper: bf16 on wgmma with TMA rings (states "
         "chained by release flags, dq / dk / dv items, the normaliser a "
         "rank-1 term), float32 on the CUDA cores"),
        ("slstm", "slstm", "src/repro/models/blocks.py:333 (_slstm_cell "
         "under lax.scan at :369; no TPU kernel)",
         "redesigned for Hopper: a cluster of 8 CTAs a head, bf16 r held "
         "in registers and multiplied on the tensor cores (mma.sync), h "
         "handed on point to point by st.async onto mbarriers (no cluster "
         "barrier a position), gx streamed in and the outputs stored by "
         "TMA off the chain; float32 on the CUDA cores"),
        ("slstm_bwd", "slstm", "src/repro/models/blocks.py:333 "
         "(_slstm_cell's lax.scan, differentiated by jax.grad; no TPU "
         "kernel)", "redesigned for Hopper: the reverse recurrence on the "
         "same clusters, dg r^T's partials on the tensor cores sent to "
         "each unit's CTA by st.async and added in rank order, g, c, n, "
         "m and dys streamed in and dgx out by TMA; dr one batched "
         "product")))]
    for k in kernels:
        k["launches_by_path"].update(dist_launches(dist, k["name"]))
        k["launches_by_path"].update(sp_launches(seqp, k["name"]))
        k["launches_by_path"].update({
            path: counts[k["name"]] for path, counts in dry[
                "launches"].items() if k["name"] in counts})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
