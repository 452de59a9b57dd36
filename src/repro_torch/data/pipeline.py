"""Deterministic, shardable, resumable synthetic data pipeline (counterpart
of ``repro.data.pipeline``).

Batches are a pure function of (seed, step, host shard), drawn with numpy
exactly as the reference draws them, so ``batch_at`` gives the reference's
arrays bit for bit and there is no state to checkpoint: resuming at step N
reproduces the stream an uninterrupted run would have seen.  A background
prefetch thread keeps batches ahead of the training loop.  Batches are
host numpy arrays; ``models.steps.batch_to_device`` moves them.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ArchConfig

__all__ = ["StepWatchdog", "SyntheticLM"]


class SyntheticLM:
    """Token stream for LM training: next-token labels over a fixed vocab."""

    def __init__(self, cfg: ArchConfig, global_batch: int, seq: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1):
        if global_batch % host_count:
            raise ValueError(f"batch {global_batch} does not split over "
                             f"{host_count} hosts")
        self.cfg = cfg
        self.batch = global_batch // host_count
        self.global_batch = global_batch
        self.seq = seq
        self.seed = seed
        self.host_index = host_index

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        cfg = self.cfg
        out: dict = {}
        if cfg.frontend_stub:
            out["frames"] = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model)).astype(np.float32)
            out["labels"] = rng.integers(
                0, cfg.vocab, (self.batch, self.seq)).astype(np.int32)
        else:
            tokens = rng.integers(0, cfg.vocab,
                                  (self.batch, self.seq + 1)).astype(np.int32)
            out["tokens"] = tokens[:, :-1]
            out["labels"] = tokens[:, 1:]
        if cfg.cross_ctx_len:
            out["cross_ctx"] = rng.standard_normal(
                (self.batch, cfg.cross_ctx_len, cfg.d_model)
            ).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0,
                prefetch: int = 2) -> Iterator[dict]:
        """Batches from ``start_step`` on, ``prefetch`` made ahead by a
        daemon thread; closing the generator stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                batch = self.batch_at(step)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            t.join()


class StepWatchdog:
    """Straggler visibility: records per-step wall time, flags outliers."""

    def __init__(self, threshold: float = 3.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.times: list[float] = []
        self.slow_steps: list[tuple[int, float]] = []

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        recent = self.times[-self.window:]
        median = sorted(recent)[len(recent) // 2]
        slow = len(recent) >= 5 and seconds > self.threshold * median
        if slow:
            self.slow_steps.append((step, seconds))
        return slow
