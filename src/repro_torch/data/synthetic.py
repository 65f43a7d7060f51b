"""Deterministic synthetic data pipeline (copy of ``repro.data.synthetic``;
numpy only).

The stream is a stateless function of (seed, step), so a restarted run
replays the same batches with no loader state beyond the step counter
(the supervisor's replay relies on it). ``batch_at(step)`` is bit for bit
the reference's. A background thread prefetches ahead of the loop.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class TokenStream:
    """Markov-ish synthetic token stream with learnable structure:
    tokens[t+1] = (a * tokens[t] + b + noise) % vocab gives the model a
    signal to fit, so losses visibly decrease."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S, V = self.local_batch, self.seq_len, self.vocab
        a = 31
        start = rng.integers(0, V, size=(B, 1))
        idx = np.arange(S)[None, :]
        base = (start + a * idx) % V
        noise = rng.integers(0, 2, size=(B, S))
        toks = ((base + noise) % V).astype(np.int32)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator (depth-bounded)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
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


def pack_documents(docs: list[np.ndarray], seq_len: int, pad: int = 0
                   ) -> np.ndarray:
    """Greedy sequence packing of variable-length docs into fixed rows."""
    rows, cur = [], []
    cur_len = 0
    for d in docs:
        d = d[: seq_len]
        if cur_len + len(d) > seq_len:
            rows.append(np.concatenate(
                cur + [np.full(seq_len - cur_len, pad, np.int32)]))
            cur, cur_len = [], 0
        cur.append(d.astype(np.int32))
        cur_len += len(d)
    if cur:
        rows.append(np.concatenate(
            cur + [np.full(seq_len - cur_len, pad, np.int32)]))
    return np.stack(rows) if rows else np.zeros((0, seq_len), np.int32)
