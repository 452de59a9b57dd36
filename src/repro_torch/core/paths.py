"""Batched frontier-expansion construction of self-avoiding XY-mesh paths.

``sched.enumerate_paths`` walks the scheduling-tree path space with a
recursive Python DFS — fine on a 3x3/6x6 MCM, but the hot spot once the
window combiner is vectorized (PR 1) and the sweep moves to 8x8/16x16 pods.
This module rebuilds candidate construction as a *batched frontier
expansion*: all partial paths grow one hop per level as padded numpy
tensors, so the per-hop work is a handful of array ops instead of a Python
call per path.

Representation (shared with ``engine.py``):

* paths   ``[N, L]`` int16 chiplet ids (every row is a complete length-L
  self-avoiding path);
* words   ``[N, W]`` uint64 occupancy masks, ``W = ceil(n_chiplets / 64)``,
  exactly the multi-word packing ``engine.CandidateTensors`` consumes —
  packed once for the surviving rows, so the candidate mask tensor comes
  out of construction for free.

DFS-order parity: expanding each level's rows in (parent, direction) order
— direction order matching ``MCM.neighbors`` — yields the final level's
rows in exactly the DFS emission order of ``enumerate_paths``.  With the
same per-start budget split (``cap // len(starts)``, duplicates counted,
then applied to the deduplicated start pool) the truncated result is
*bitwise identical* to the recursive oracle whenever the frontier stays
exhaustive.  Two frontier bounds apply:

* the final hop is *budget-aware*: per-start prefix chunks of partials are
  expanded only until every start has met its ``per_start`` completion
  budget.  This skips exclusively rows the truncation would drop, so it is
  exact at any cap;
* intermediate levels that outgrow ``frontier_cap`` (large meshes the DFS
  could not sweep anyway) are thinned by a deterministic stratified sample
  — evenly spaced rows per start group.

Results are memoised in a per-process LRU keyed on
``(rows, cols, length, starts, cap, frontier_cap)``.  Path geometry depends
only on mesh shape, so the cache is shared across every scenario, window,
and metric a portfolio worker runs (spawn workers each warm their own, like
the per-worker ``CostDB`` cache).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from repro_torch.obs import registry as _obs_registry

__all__ = ["frontier_paths", "path_cache_clear", "path_cache_info"]

# Frontier rows kept per intermediate level before stratified sampling kicks
# in.  The default is high enough that every mesh the DFS oracle can handle
# (<= 6x6, typical segment counts) is enumerated exhaustively -> exact DFS
# parity.
DEFAULT_FRONTIER_CAP = 32768

_ONE = np.uint64(1)


def _children(paths: np.ndarray, rows: int, cols: int):
    """One-hop expansion of every row, in DFS (parent, direction) order.

    Returns ``(parent, chip)``: source row indices and the appended chiplet,
    ordered so children inherit the frontier's DFS-prefix sort.  The
    direction order matches ``MCM.neighbors`` (down, up, right, left); the
    self-avoidance test is a membership compare against each row (L <= a few
    dozen int16s — cheaper than maintaining per-row occupancy words).
    """
    n = rows * cols
    last = paths[:, -1].astype(np.int32)
    offsets = np.array([cols, -cols, 1, -1], dtype=np.int32)
    nxt = (last[:, None] + offsets[None, :]).astype(np.int16)    # [N, 4]
    colpos = last % cols
    ok = np.stack([last + cols < n,
                   last - cols >= 0,
                   colpos != cols - 1,
                   colpos != 0], axis=1)                         # [N, 4]
    visited = nxt == paths[:, :1]            # column loop beats a 3D
    for col in range(1, paths.shape[1]):     # broadcast: [N, 4] passes, no
        visited |= nxt == paths[:, col:col + 1]   # [N, 4, L] temporary
    ok &= ~visited
    parent, dirn = np.nonzero(ok)            # row-major == DFS-prefix order
    return parent, dirn, nxt[parent, dirn]


def _group_ranks(start_id: np.ndarray):
    """(group index, within-group rank) for contiguous ``start_id`` runs."""
    total = start_id.shape[0]
    first = np.concatenate([[True], start_id[1:] != start_id[:-1]])
    group = np.cumsum(first) - 1
    rank = np.arange(total) - np.flatnonzero(first)[group]
    return group, rank


def _stratified_sample(paths: np.ndarray, start_id: np.ndarray, limit: int):
    """Deterministically thin the frontier to ~``limit`` rows.

    Each start group keeps a proportional quota (at least one row) of
    evenly spaced survivors, so every scheduling-tree root stays
    represented and repeated calls are reproducible (no RNG: the result
    feeds the shared cache).
    """
    total = paths.shape[0]
    first = np.concatenate([[True], start_id[1:] != start_id[:-1]])
    offs = np.concatenate([np.flatnonzero(first), [total]])
    keep: list[np.ndarray] = []
    for g in range(offs.shape[0] - 1):
        lo, hi = int(offs[g]), int(offs[g + 1])
        size = hi - lo
        quota = max(1, (limit * size) // total)
        if quota >= size:
            keep.append(np.arange(lo, hi))
        else:
            pick = np.round(np.linspace(0, size - 1, quota)).astype(np.int64)
            keep.append(lo + np.unique(pick))
    idx = np.concatenate(keep)
    return paths[idx], start_id[idx]


def _expand_final(paths: np.ndarray, start_id: np.ndarray, rows: int,
                  cols: int, per_start: int):
    """Budget-aware last hop: stop once every start met its completion quota.

    Per-start prefix windows of partials are expanded round by round; a
    start whose completion count reaches ``per_start`` drops out.  Children
    of earlier partials always precede children of later ones within a
    start, so every skipped row is one the per-start truncation would have
    discarded — the kept prefix is bit-identical to exhaustive expansion.
    """
    group, rank = _group_ranks(start_id)
    n_groups = int(group[-1]) + 1
    window = max(per_start, 64)
    done = np.zeros(n_groups, dtype=bool)
    counts = np.zeros(n_groups, dtype=np.int64)
    chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    w = 0
    while True:
        sel = np.flatnonzero((~done[group]) & (rank >= w * window)
                             & (rank < (w + 1) * window))
        if sel.size == 0:
            break        # ranks are contiguous: no window w rows => no later
        parent, dirn, chip = _children(paths[sel], rows, cols)
        src = sel[parent]
        chunks.append((src * 4 + dirn, src, chip))
        counts += np.bincount(group[src], minlength=n_groups)
        done = counts >= per_start
        if done.all():
            break
        w += 1
    if not chunks:
        return (np.empty((0, paths.shape[1] + 1), dtype=np.int16),
                start_id[:0])
    key = np.concatenate([c[0] for c in chunks])
    src = np.concatenate([c[1] for c in chunks])
    chip = np.concatenate([c[2] for c in chunks])
    order = np.argsort(key, kind="stable")   # global DFS order across chunks
    src, chip = src[order], chip[order]
    new_paths = np.concatenate([paths[src], chip[:, None]], axis=1)
    return new_paths, start_id[src]


def _truncate_per_start(paths: np.ndarray, start_id: np.ndarray,
                        per_start: int):
    """Keep each start group's first ``per_start`` rows (= the DFS budget)."""
    _, rank = _group_ranks(start_id)
    keep = rank < per_start
    return paths[keep]


def _pack_words(paths: np.ndarray, n_words: int) -> np.ndarray:
    """[N, L] complete paths -> [N, W] uint64 occupancy words."""
    total, length = paths.shape
    words = np.zeros((total, n_words), dtype=np.uint64)
    idx = np.arange(total)
    for col in range(length):
        c = paths[:, col].astype(np.int64)
        words[idx, c >> 6] |= _ONE << (c & 63).astype(np.uint64)
    return words


def _build(rows: int, cols: int, length: int, starts: tuple[int, ...],
           cap: int, frontier_cap: int):
    n = rows * cols
    if n + cols >= np.iinfo(np.int16).max:
        raise ValueError(f"mesh {rows}x{cols} too large for int16 path ids")
    n_words = max(1, (n + 63) // 64)
    # Budget semantics of the DFS oracle: split over the raw start list
    # (duplicates included), enumerate over the deduplicated pool.
    per_start = max(1, cap // max(1, len(starts)))
    pool = list(dict.fromkeys(starts))
    empty = (np.empty((0, max(length, 0)), dtype=np.int16),
             np.empty((0, n_words), dtype=np.uint64))
    if not pool or length < 1:
        return empty

    paths = np.asarray(pool, dtype=np.int16)[:, None]
    start_id = np.arange(len(pool), dtype=np.int64)
    for level in range(1, length):
        if level == length - 1:
            paths, start_id = _expand_final(paths, start_id, rows, cols,
                                            per_start)
        else:
            parent, _, chip = _children(paths, rows, cols)
            paths = np.concatenate([paths[parent], chip[:, None]], axis=1)
            start_id = start_id[parent]
        if paths.shape[0] == 0:
            return empty
        if paths.shape[0] > frontier_cap and level < length - 1:
            paths, start_id = _stratified_sample(paths, start_id,
                                                 frontier_cap)
    paths = _truncate_per_start(paths, start_id, per_start)
    return paths, _pack_words(paths, n_words)


_CACHE: OrderedDict[tuple, tuple[np.ndarray, np.ndarray]] = OrderedDict()
_CACHE_LOCK = threading.Lock()
_CACHE_MAX = 256
# Hit/miss accounting lives in the process-global telemetry registry
# (repro_torch.obs) so path_cache_info(), obs.cache_stats() and exported traces
# all read the same integers.
_HIT = _obs_registry.counter("paths.cache_hit")
_MISS = _obs_registry.counter("paths.cache_miss")


def frontier_paths(rows: int, cols: int, length: int, starts,
                   cap: int = 512,
                   frontier_cap: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """All self-avoiding XY-mesh paths of ``length`` chiplets, batched.

    Returns ``(paths [N, length] int16, words [N, W] uint64)`` — read-only
    views served from the per-process LRU cache.  Semantics (start pool,
    per-start budget split, emission order) mirror ``sched.enumerate_paths``
    exactly while intermediate frontiers stay under ``frontier_cap``
    (default ``max(4 * cap, DEFAULT_FRONTIER_CAP)``).
    """
    if frontier_cap is None:
        frontier_cap = max(4 * cap, DEFAULT_FRONTIER_CAP)
    key = (rows, cols, length, tuple(starts), cap, frontier_cap)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            _CACHE.move_to_end(key)
            _HIT.inc()
            return hit
    paths, words = _build(rows, cols, length, key[3], cap, frontier_cap)
    paths.flags.writeable = False
    words.flags.writeable = False
    with _CACHE_LOCK:
        _MISS.inc()
        _CACHE[key] = (paths, words)
        _CACHE.move_to_end(key)
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return paths, words


def path_cache_clear() -> None:
    """Drop every cached path tensor (benchmarks re-time cold builds)."""
    with _CACHE_LOCK:
        _CACHE.clear()
        _HIT.reset()
        _MISS.reset()


def path_cache_info() -> dict:
    """Cache size/limit plus the registry-backed hit/miss counts."""
    with _CACHE_LOCK:
        return {"size": len(_CACHE), "maxsize": _CACHE_MAX,
                "hits": _HIT.value, "misses": _MISS.value}
