"""Deterministic, shard-aware token data pipeline (a copy of
``repro.data.pipeline``: pure numpy, so the batches are the reference's, bit
for bit, at the same seed, step and shard).

Two sources:
* ``SyntheticSource`` — stateless hash-based token generation: batch at
  (step, shard) is a pure function of (seed, step, shard), so restarts and
  elastic re-sharding reproduce the exact global stream with no data state
  in checkpoints (the step number *is* the data cursor).
* ``MemmapSource``  — windows from a binary token corpus (np.memmap), with
  deterministic shuffled window order per epoch.

``Pipeline`` adds host-side background prefetch (double-buffered thread) and
splits the global batch across data shards: shard i of N reads rows
[i·B/N, (i+1)·B/N) of the global batch — on a multi-host deployment each
host feeds its addressable shard; in this single-process container the
launcher assembles all shards (same code path, N=1..n).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"       # "synthetic" | "memmap"
    corpus_path: str = ""
    num_shards: int = 1
    shard_index: int = 0


class SyntheticSource:
    """Pure-function token batches: counter-based PRNG (Philox) keyed by
    (seed, step, shard) — deterministic, seekable, restart-safe."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rows = cfg.global_batch // cfg.num_shards
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=[0, 0, step, cfg.shard_index]))
        # skewed zipf-ish distribution so models can actually learn structure
        z = rng.zipf(1.3, size=(rows, cfg.seq_len + 1)).astype(np.int64)
        tokens = (z % (cfg.vocab_size - 1)) + 1
        return {
            "tokens": tokens[:, : cfg.seq_len].astype(np.int32),
            "mask": np.ones((rows, cfg.seq_len), np.int32),
        }


class MemmapSource:
    """Windows from a flat binary int32 token file."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(cfg.corpus_path, dtype=np.int32, mode="r")
        self.n_windows = max(1, (len(self.tokens) - 1) // cfg.seq_len)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rows = cfg.global_batch // cfg.num_shards
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=[0, 1, step, cfg.shard_index]))
        idx = rng.integers(0, self.n_windows, size=rows)
        out = np.stack([self.tokens[i * cfg.seq_len: i * cfg.seq_len + cfg.seq_len] for i in idx])
        return {"tokens": out.astype(np.int32), "mask": np.ones_like(out, np.int32)}


def make_source(cfg: DataConfig):
    if cfg.source == "memmap":
        return MemmapSource(cfg)
    return SyntheticSource(cfg)


class Pipeline:
    """Background-prefetched iterator over batches starting at `start_step`."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, prefetch: int = 2):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide evenly across data shards")
        self.cfg = cfg
        self.source = make_source(cfg)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
