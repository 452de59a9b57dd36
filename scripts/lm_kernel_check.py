"""Short first check of the LM kernels on the card: build, compare, time.

Builds ``flash_attention`` and ``ssd_scan`` and their backward kernels from
``src/repro_torch/kernels/csrc`` (printing ``ptxas``'s register and spill
report), compares each with its plain torch version on a few shapes in
float32 and bf16 (printing the max |kernel - plain|, and for the backward
kernels that over the largest plain gradient, whether every gradient is
within the tolerance ``chip_smoke.py`` holds it to, and whether a second
call gives the same bits), and times one call of each
at the zamba2-2.7b shapes (batch 4, sequence 1024) with CUDA events over
five calls.  It is the quick call to make after editing a kernel;
``chip_smoke.py`` is the full check.  Needs a CUDA device.

Usage: python scripts/lm_kernel_check.py [--grad-only]
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (attention_bwd_plain,
                                                 attention_plain,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 lse_buffer)
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                          ssd_scan_bwd_plain, ssd_scan_plain)

# (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len)
FLASH = [(1, 64, 64, 2, 1, 16, True, 0, None),
         (2, 1000, 1000, 4, 2, 80, True, 0, None),
         (1, 1, 1, 1, 1, 64, True, 0, None),
         (2, 100, 300, 4, 4, 128, True, 37, 200),
         (2, 48, 68, 4, 2, 16, True, 0, 48),
         (4, 1024, 1056, 32, 32, 80, True, 0, 1024),
         (1, 2048, 2048, 8, 1, 64, False, 0, None)]
# (B, L, H, N, P, chunk, q and k broadcast over heads)
SSD = [(1, 128, 1, 16, 16, 64, False), (2, 256, 2, 64, 64, 128, False),
       (2, 48, 4, 16, 16, 16, True), (4, 1024, 80, 64, 64, 256, True),
       (1, 512, 2, 64, 64, 256, False)]


def events_ms(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# backward: (B, S, Hq, Hkv, D, causal, Skv) and (B, L, H, N, P, chunk,
# broadcast, slow decay)
FLASH_BWD = [(1, 64, 2, 1, 16, True, 64), (2, 100, 4, 2, 80, True, 100),
             (2, 130, 4, 4, 64, False, 130), (1, 256, 8, 2, 128, True, 256),
             (1, 130, 4, 1, 16, True, 130), (2, 64, 4, 4, 32, True, 64),
             (2, 100, 4, 2, 64, False, 300), (1, 1024, 64, 8, 128, False, 4096),
             (4, 1024, 32, 32, 80, True, 1024)]
SSD_BWD = [(1, 64, 2, 16, 16, 16, False, False),
           (2, 96, 3, 16, 16, 16, True, False),
           (1, 512, 2, 64, 64, 128, False, False),
           (2, 512, 4, 64, 32, 256, True, False),
           (2, 256, 4, 32, 48, 64, False, False),
           (1, 1024, 8, 64, 64, 256, True, True),
           (2, 200, 3, 32, 16, 100, False, True),
           (4, 1024, 80, 64, 64, 256, True, False),
           (4, 1024, 80, 64, 64, 256, True, True)]


def device_parts(fn, n: int = 5) -> str:
    """Each device kernel's time (ms a call) over ``n`` calls, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total",
                     getattr(ev, "cuda_time_total", 0.0))
        if us > 0 and ev.count:
            rows.append(f"{ev.key[:50]} x{ev.count / n:g} {us / n / 1e3:.4f}")
    return "; ".join(rows)


def rel_err(outs, refs) -> list:
    return [round(((o.float() - r.float()).abs().max()
                   / r.float().abs().max().clamp_min(1e-30)).item(), 8)
            for o, r in zip(outs, refs)]


def within(outs, refs, dt) -> bool:
    """bf16 gradients elementwise within 2e-2 (rtol and atol), float32
    ones (and da) within 2e-5 of the largest plain entry."""
    ok = True
    for i, (o, r) in enumerate(zip(outs, refs)):
        o, r = o.float(), r.float()
        if dt == torch.bfloat16 and i < 3:
            ok &= bool(((o - r).abs() <= 2e-2 + 2e-2 * r.abs()).all())
        else:
            ok &= bool((o - r).abs().max() <= 2e-5 * r.abs().max())
    return ok


def grad_checks(rn) -> None:
    for dt in (torch.float32, torch.bfloat16):
        for B, S, Hq, Hkv, D, causal, Skv in FLASH_BWD:
            q, do = rn(B, S, Hq, D, dt=dt), rn(B, S, Hq, D, dt=dt)
            k, v = rn(B, Skv, Hkv, D, dt=dt), rn(B, Skv, Hkv, D, dt=dt)
            lse = lse_buffer(q)
            o = flash_attention(q, k, v, causal=causal, lse=lse)
            got = flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
            again = flash_attention_bwd(q, k, v, o, do, causal=causal,
                                        lse=lse)
            ref = attention_bwd_plain(q, k, v, o, do, causal=causal)
            plain_lse = torch.empty_like(lse)
            attention_plain(q, k, v, causal=causal, lse=plain_lse)
            torch.cuda.synchronize()
            lse_err = (lse[..., :S] - plain_lse[..., :S]).abs().max().item()
            print("flash_bwd", dt, B, S, Skv, Hq, Hkv, D, causal,
                  "err/max (dq, dk, dv)", rel_err(got, ref), "within",
                  within(got, ref, dt), "same bits",
                  all(torch.equal(x, y) for x, y in zip(got, again)),
                  "lse err", lse_err, flush=True)
        for B, L, H, N, P, c, shared, slow in SSD_BWD:
            hq = 1 if shared else H
            q = rn(B, L, hq, N, dt=dt).expand(B, L, H, N)
            k = rn(B, L, hq, N, dt=dt).expand(B, L, H, N)
            v, do = rn(B, L, H, P, dt=dt), rn(B, L, H, P, dt=dt)
            if slow:
                a = -0.01 * torch.rand(B, L, H, device="cuda")
            else:
                a = -torch.nn.functional.softplus(rn(B, L, H))
            got = ssd_scan_bwd(q, k, v, a, do, chunk=c)
            again = ssd_scan_bwd(q, k, v, a, do, chunk=c)
            ref = ssd_scan_bwd_plain(q, k, v, a, do, chunk=c)
            torch.cuda.synchronize()
            print("ssd_bwd", dt, B, L, H, N, P, c, shared, slow,
                  "err/max (dq, dk, dv, da)", rel_err(got, ref), "within",
                  within(got, ref, dt), "same bits",
                  all(torch.equal(x, y) for x, y in zip(got, again)),
                  flush=True)
    bf = torch.bfloat16
    q, k, v, do = (rn(4, 1024, 32, 80, dt=bf) for _ in range(4))
    lse = lse_buffer(q)
    o = flash_attention(q, k, v, lse=lse)
    print("flash_bwd ms", events_ms(
        lambda: flash_attention_bwd(q, k, v, o, do, lse=lse)))
    print("flash_bwd parts", device_parts(
        lambda: flash_attention_bwd(q, k, v, o, do, lse=lse)))
    lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lo = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv,
                                                          is_causal=True)
    ldo = do.transpose(1, 2)
    print("sdpa backward ms", events_ms(
        lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                    retain_graph=True)))
    q = rn(4, 1024, 1, 64, dt=bf).expand(4, 1024, 80, 64)
    k = rn(4, 1024, 1, 64, dt=bf).expand(4, 1024, 80, 64)
    v, do = rn(4, 1024, 80, 64, dt=bf), rn(4, 1024, 80, 64, dt=bf)
    a = -torch.nn.functional.softplus(rn(4, 1024, 80))
    print("ssd_bwd ms", events_ms(
        lambda: ssd_scan_bwd(q, k, v, a, do, chunk=256)))
    print("ssd_bwd parts", device_parts(
        lambda: ssd_scan_bwd(q, k, v, a, do, chunk=256)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lm_kernel_check: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    build.build(["flash_attention", "ssd_scan", "flash_attention_bwd",
                 "ssd_scan_bwd"])
    print("build", time.perf_counter() - t0, build.build_seconds)
    for name, log in build.build_log.items():
        print(name, log)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    grad_checks(rn)
    if "--grad-only" in sys.argv:
        return

    for dt in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, Hq, Hkv, D, causal, off, kvl in FLASH:
            q = rn(B, Sq, Hq, D, dt=dt)
            k, v = rn(B, Skv, Hkv, D, dt=dt), rn(B, Skv, Hkv, D, dt=dt)
            kw = dict(causal=causal, q_offset=off, kv_len=kvl)
            err = (flash_attention(q, k, v, **kw).float()
                   - attention_plain(q, k, v, **kw).float()).abs().max()
            print("flash", dt, B, Sq, Skv, Hq, Hkv, D, kw, "err", err.item())
        for B, L, H, N, P, c, shared in SSD:
            hq = 1 if shared else H
            q = rn(B, L, hq, N, dt=dt).expand(B, L, H, N)
            k = rn(B, L, hq, N, dt=dt).expand(B, L, H, N)
            v = rn(B, L, H, P, dt=dt)
            a = -torch.nn.functional.softplus(rn(B, L, H))
            ref = ssd_scan_plain(q, k, v, a, chunk=c).float()
            err = (ssd_scan(q, k, v, a, chunk=c).float() - ref).abs().max()
            print("ssd", dt, B, L, H, N, P, c, shared, "err", err.item(),
                  "scale", ref.abs().max().item())
    bf = torch.bfloat16
    q = rn(4, 1024, 32, 80, dt=bf)
    k, v = rn(4, 1056, 32, 80, dt=bf), rn(4, 1056, 32, 80, dt=bf)
    print("flash ms", events_ms(
        lambda: flash_attention(q, k, v, causal=True, kv_len=1024)))
    q = rn(4, 1024, 1, 64, dt=bf).expand(4, 1024, 80, 64)
    k = rn(4, 1024, 1, 64, dt=bf).expand(4, 1024, 80, 64)
    v = rn(4, 1024, 80, 64, dt=bf)
    a = -torch.nn.functional.softplus(rn(4, 1024, 80))
    print("ssd ms", events_ms(lambda: ssd_scan(q, k, v, a, chunk=256)))


if __name__ == "__main__":
    main()
