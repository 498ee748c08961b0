"""Deterministic synthetic LM data pipeline: the port's own copy of the
reference's ``repro/data/pipeline.py`` (numpy only), batch for batch the
same.

Deterministic per (seed, step, shard) — a restart at step k regenerates
exactly the batch a failed run would have seen (the checkpoint stores only
the step cursor, and resume is bit-exact; tests/test_torch_checkpoint.py
asserts this).  Host-sharded: each data-parallel host materializes only its
slice.  A background thread prefetches ``prefetch`` batches ahead.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    """Markov-ish token stream with a learnable structure (loss can go
    well below uniform): token t+1 = (a * t + noise) % vocab."""

    def __init__(self, cfg, seq_len: int, global_batch: int, seed: int = 0,
                 shard: int = 0, num_shards: int = 1):
        assert global_batch % num_shards == 0
        self.cfg = cfg
        self.seq_len = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 977 + self.shard) % (2 ** 31)
        )
        V = cfg.vocab_size
        B, S = self.local_batch, self.seq_len
        start = rng.randint(0, V, size=(B, 1))
        steps = rng.randint(1, 7, size=(B, 1))
        pos = np.arange(S + 1)[None, :]
        stream = (start + steps * pos + (pos ** 2 % 3)) % min(V, 4096)
        tokens = stream[:, :-1].astype(np.int32)
        labels = stream[:, 1:].astype(np.int32)
        out = {"tokens": tokens, "labels": labels}
        if cfg.family == "vlm":
            out["patches"] = rng.randn(B, cfg.num_patches, cfg.d_model).astype(
                np.float32
            ) * 0.02
        if cfg.family == "audio":
            out["frames"] = rng.randn(B, cfg.encoder_seq, cfg.d_model).astype(
                np.float32
            ) * 0.02
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch (overlaps host data gen with device step)."""

    def __init__(self, source: Iterator, prefetch: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._src = source
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._src:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_data_iterator(cfg, seq_len: int, global_batch: int, seed: int = 0,
                       shard: int = 0, num_shards: int = 1,
                       start_step: int = 0, prefetch: int = 2):
    src = SyntheticLM(cfg, seq_len, global_batch, seed, shard, num_shards)
    return PrefetchIterator(src.iterate(start_step), prefetch)
