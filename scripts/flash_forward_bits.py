"""SHA-256 digests of ``flash_attention``'s outputs on seeded inputs.

The forward kernel gained an optional log-sum-exp output for training;
serving passes none.  This script prints, as one JSON object, the digest
of the output bits of a few seeded calls (numpy inputs, seed 0, cast to
the card), so that the output of one version of the kernel can be held
bit for bit against another's:
``tests/test_torch_attention_grad.py::test_cuda_forward_bits_unchanged``
holds the current kernel, with and without the log-sum-exp output,
against the digests this script printed for the kernel before that
output existed, on an NVIDIA H100.  Needs a CUDA device.

Usage: python scripts/flash_forward_bits.py [--src DIR]
(``--src``: the ``src`` directory whose ``repro_torch`` to import; the
default is this repository's.)
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

# (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len, bf16?)
CASES = [(2, 300, 300, 8, 2, 80, True, 0, None, True),
         (1, 200, 520, 4, 4, 128, True, 300, 500, True),
         (2, 100, 100, 4, 2, 64, True, 0, None, False)]


def digests(flash_attention, torch) -> dict:
    out = {}
    for B, Sq, Skv, Hq, Hkv, D, causal, off, kvl, bf in CASES:
        rng = np.random.default_rng(0)
        dt = torch.bfloat16 if bf else torch.float32
        q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32))
                   .to("cuda", dt)
                   for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D),
                             (B, Skv, Hkv, D)))
        o = flash_attention(q, k, v, causal=causal, q_offset=off,
                            kv_len=kvl)
        raw = o.contiguous().view(torch.int16 if bf else torch.int32)
        key = f"{B},{Sq},{Skv},{Hq},{Hkv},{D},{int(causal)},{off},{kvl},{dt}"
        out[key] = hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_forward_bits: no CUDA device")
    from repro_torch.kernels.flash_attention import flash_attention
    print(json.dumps(digests(flash_attention, torch), indent=1))


if __name__ == "__main__":
    main()
