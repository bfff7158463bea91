"""Deterministic, shard-aware synthetic data pipeline (the port's own copy
of ``repro.data.pipeline``, which needs only numpy; its batches equal the
JAX package's byte for byte).

Key property for fault tolerance: the stream is a *stateless function of
(seed, step, shard)* — resuming from a checkpointed step reproduces the
exact same batches with no pipeline state beyond the integer step, so
checkpoint/restore is bit-exact (tested in test_torch_train_loop.py).

Tokens follow a noisy affine recurrence (t_{i+1} = a*t_i + b + noise mod V)
so a model can actually learn structure — the end-to-end example's loss
decreases — while generation stays O(batch) with numpy Philox counters.

A background prefetch thread overlaps host generation with device steps
(the host-side half of compute/transfer overlap).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ShardInfo:
    shard: int = 0
    n_shards: int = 1


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, shard: ShardInfo = ShardInfo(),
                 noise: float = 0.05, input_mode: str = "tokens",
                 d_model: int = 0):
        if global_batch % shard.n_shards:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {shard.n_shards} shards")
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // shard.n_shards
        self.seed = seed
        self.shard = shard
        self.noise = noise
        self.input_mode = input_mode
        self.d_model = d_model

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, self.shard.shard, 0, 0]))

    def batch(self, step: int) -> dict:
        """Batch for ``step`` on this shard: {tokens|embeds, labels}."""
        rng = self._rng(step)
        B, S, V = self.local_batch, self.seq_len, self.vocab
        a = 31 + 2 * (step % 5)          # odd multiplier, varies per step
        t0 = rng.integers(0, V, size=(B, 1))
        seq = [t0]
        for _ in range(S):
            nxt = (a * seq[-1] + 17) % V
            flip = rng.random((B, 1)) < self.noise
            rand = rng.integers(0, V, size=(B, 1))
            seq.append(np.where(flip, rand, nxt))
        arr = np.concatenate(seq, axis=1)         # [B, S+1]
        tokens = arr[:, :-1].astype(np.int32)
        labels = arr[:, 1:].astype(np.int32)
        if self.input_mode == "embeds":
            emb = rng.standard_normal((B, S, self.d_model)).astype(np.float32)
            return {"embeds": emb, "labels": labels}
        return {"tokens": tokens, "labels": labels}


class Prefetcher:
    """Background thread generating batches ahead of consumption."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.source.batch(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
        # drain so the worker unblocks
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)
