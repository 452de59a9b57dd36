"""Fused device window search: scoring, beam combination and top-k on the
device, one fetch per window.

Counterpart of ``repro/core/device_search.py``.  The host beam pipeline
scores each model's candidate batch, fetches it, orders it on the host and
combines with the numpy beam: one sync per scored batch and a host combine.
Here the whole window search runs on the device between one upload and one
fetch:

* the protocol form — ``beam_scan`` itself over host-scored, host-ordered
  float64 candidate tables (the reference's ``protocol_program`` minus its
  pool).  Each stage does the reference's exact IEEE operations (one
  ``max``, one ``add``, one ``multiply`` per item) and the stable
  ascending sort reproduces its lowest-flat-index tie rule, so plans,
  metrics and the explored cloud are bit-identical to
  ``engine.reference_combine``.
* ``fused_program`` — the throughput form: the scoring of every model of
  the window (one ``scar_eval`` launch on a GPU), quantised (tier, score)
  candidate ordering, compute-weight model ordering and the shared beam
  scan, all in float32, as in the reference.

Both share ``beam_scan``, whose per-stage screen (disjointness, keep
width, expansion budget and the masked scores) is one ``kernels.
scar_search`` launch on a GPU.  The reference scans a pool,
a prefix of each model's candidate order, and falls back to the full order
under ``lax.cond`` only when the pool cannot be complete; the pool exists to
spare XLA's CPU sort, and the fallback selects exactly what the pool
selects whenever the pool is taken.  Choosing between them here would need
a device-to-host read per stage, so the port scans the full order at every
stage, which gives the same picks.

No function here copies between host and device or reads a device value on
the host: the callers upload the inputs before and fetch the outputs after
(``engine.DeviceBeamEngine``), so a window program makes no hidden sync.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.scar_eval import ops as scar_eval_ops
from repro_torch.kernels.scar_search import screen

from .engine import metric_score
from .quantize import SCORE_SIG, quantize_scores_torch

__all__ = ["beam_scan", "bucket_size", "fused_program", "split_words_u32"]

_KEY_INVALID = 0xFFFFFFFF


def bucket_size(n: int, base: int = 256) -> int:
    """Round ``n`` up to a shape bucket.

    Buckets are powers of two up to 8192, then multiples of 8192.  The
    candidate axis of the device programs is padded to this, so a whole
    schedule's windows land on a few discrete shapes.
    """
    b = base
    while b < n and b < 8192:
        b *= 2
    if n <= b:
        return b
    return -(-n // 8192) * 8192


def split_words_u32(words: np.ndarray) -> np.ndarray:
    """uint64 occupancy words [N, W] -> uint32 [N, 2W], (lo, hi) per word.

    The device carries the uint32 bits in int32 tensors
    (``split_words_u32(w).view(np.int32)``), which the ``scar_search``
    kernel reads as unsigned.
    """
    lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (words >> np.uint64(32)).astype(np.uint32)
    out = np.empty((words.shape[0], 2 * words.shape[1]), np.uint32)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return out


def beam_scan(full, keeps, *, beam: int, metric: str, max_exp: int,
              use_kernel: bool):
    """The shared beam combination: one stage per model.

    ``full``: ``(words [M, N, 2W] int32, lat [M, N], e [M, N],
    valid [M, N] bool)`` — every candidate of each model in host
    candidate ((tier, score)) order, the rows past its count marked
    invalid; ``keeps``: the ``M`` per-model widths (host ints).  Each stage
    is one ``kernels.scar_search`` screen, with ``engine.BeamEngine``'s
    semantics applied unconditionally: the keep-rank filter and the
    row-major expansion budget are no-ops exactly where the host skips
    them, and a stable ascending sort of the masked scores reproduces the
    host's stable argsort over its row-major acceptance listing.  The
    expansion counter and the live beam rows stay on the device, in the
    screen's ``state``.  Scores stay in the dtype of ``lat``.

    Returns per stage ``(parent [beam], cand [beam], lat [beam],
    energy [beam], n_new, failed)``, stacked over the ``M`` stages;
    ``cand`` indexes the stage's candidate order.
    """
    f_words, f_lat, f_e, f_valid = full
    m_models, n_full, w2 = f_words.shape
    dev = f_lat.device
    b_mask = torch.zeros((beam, w2), dtype=torch.int32, device=dev)
    b_lat = torch.zeros(beam, dtype=f_lat.dtype, device=dev)
    b_e = torch.zeros(beam, dtype=f_lat.dtype, device=dev)
    # (total, expansions, live beam rows, no placement): one live row, made
    # on the device (writing a Python scalar into it would copy and sync)
    state = (torch.arange(4, device=dev) == 2).long()
    ys = []
    for m in range(m_models):
        fw, fl, fe = f_words[m], f_lat[m], f_e[m]
        sc, state = screen(b_mask, fw, f_valid[m], state,
                           use_kernel=use_kernel, keep=int(keeps[m]),
                           max_exp=max_exp, b_lat=b_lat, b_e=b_e, c_lat=fl,
                           c_e=fe, metric=metric)
        # stable ascending: equal scores keep the lowest flat index, the
        # reference's lax.top_k tie rule (torch.topk has no fixed one)
        idx = torch.sort(sc.reshape(-1), stable=True).indices[:beam]
        parent, j = idx // n_full, idx % n_full
        b_lat = torch.maximum(b_lat[parent], fl[j])
        b_e = b_e[parent] + fe[j]
        b_mask = b_mask[parent] | fw[j]
        ys.append((parent, j, b_lat, b_e, state))
    parents, cands, lats, es, states = (torch.stack(t) for t in zip(*ys))
    return parents, cands, lats, es, states[:, 2], states[:, 3]


def _order_key(qs: torch.Tensor, tiers: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Packed int64 (tier, quantised score) order key.

    Non-negative float32 scores order like their bit patterns, so
    ``tier << 31 | bits(score)`` orders lexicographically by
    (tier, score); invalid rows get ``0xFFFFFFFF`` and sort last.
    """
    bits = torch.clamp(qs, min=0.0).view(torch.int32).long()
    key = bits | (tiers.long() << 31)
    return torch.where(valid, key, _KEY_INVALID)


def fused_program(window, *, beam: int, keep: int, metric: str,
                  max_exp: int, n_pad: int, use_kernel: bool,
                  congestion: bool = False):
    """The whole window search as one device program.

    ``window``: ``(batch, words, tiers)`` on the device: the
    ``scar_eval.pack_window`` batch of every model's assembled candidates,
    in model-index order, their ``[B + 1, 2W]`` int32 occupancy words and
    ``[B + 1]`` int32 tiers, each with a zero row after the last
    candidate.  ``n_pad`` (``bucket_size``) is at least every model's
    candidate count.  Returns ``(model_order,) + beam_scan ys`` with the
    ys candidate indices translated to rows of each model's assembled
    batch, so the host rebuilds the window plan from one fetch.
    ``SearchConfig.eval_backend`` does not apply: as in the reference,
    every batch of the fused path is scored in float32.
    """
    if congestion:
        raise NotImplementedError(
            "comm_model='congestion' in the fused device search is not "
            "ported yet (ROADMAP.md queue 1, item 4b: the congestion comm "
            "model, with device_search._cand_link_bytes)")
    batch, words, tiers = window
    m_models = len(batch.models)
    out = scar_eval_ops.evaluate(batch, use_kernel=use_kernel)   # [B, 2]
    # every model's candidates on a row of an [M, n_pad] plane; padding
    # points at the zero word row and an infinite score
    dev = words.device
    arange_n = torch.arange(n_pad, device=dev)
    valid = arange_n < batch.desc[:, 1:2]
    rows = torch.where(valid, batch.desc[:, 0:1] + arange_n,
                       words.shape[0] - 1)
    scores = torch.cat([out, out.new_full((1, 2), float("inf"))])[rows]
    lat, energy = scores[..., 0], scores[..., 1]
    # the host ordering contract (sched.build_candidates): stable sort on
    # (tier, score quantised to the shared grain), per model
    qs = quantize_scores_torch(metric_score(lat, energy, metric),
                               sig=SCORE_SIG)
    order = torch.sort(_order_key(qs, tiers[rows], valid), dim=1,
                       stable=True).indices
    # model order by compute weight, largest min-latency first (the host
    # engines' ``sorted(key=-min(lat))``)
    morder = torch.sort(-lat.min(dim=1).values, stable=True).indices
    order = order[morder]
    srows = torch.gather(rows[morder], 1, order)
    parents, cands, tlat, te, n_new, failed = beam_scan(
        (words[srows], torch.gather(lat[morder], 1, order),
         torch.gather(energy[morder], 1, order), valid[morder]),
        [keep] * m_models, beam=beam, metric=metric, max_exp=max_exp,
        use_kernel=use_kernel)
    return (morder, parents, torch.gather(order, 1, cands), tlat, te, n_new,
            failed)
