"""Token pipeline for the LM substrate (mirrors `repro.data.tokens`).

Synthetic-but-learnable streams for training: a Zipf-ish unigram mixture
with planted bigram structure, so a small model's loss visibly drops
within a few hundred steps, made on the host by a prefetching thread.
The draws are the reference's, from the same numpy generator in the same
order, so the batches equal the reference's bit for bit.  One difference:
the reference's thread drops a batch it made whenever the queue stays
full for a second (a consumer slower than that, such as a step that
compiles, skips batches by the clock); this one waits to put it, so the
n-th batch is always the n-th draw (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def synthetic_token_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                           prefetch: int = 2):
    """Infinite iterator of {"tokens": int32 CPU tensor [B, S]} with
    planted structure: 80% of transitions follow a fixed random successor,
    the rest (and each first token) are drawn from Zipf 1.2 weights.  A
    daemon thread keeps up to `prefetch` batches ready; closing the
    iterator stops it."""
    rng = np.random.default_rng(seed)
    # planted deterministic bigram successor for 80% of transitions
    succ = rng.integers(0, vocab, size=vocab)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.2
    probs /= probs.sum()

    def make_batch():
        toks = np.empty((batch, seq), np.int64)
        toks[:, 0] = rng.choice(vocab, size=batch, p=probs)
        for t in range(1, seq):
            follow = rng.random(batch) < 0.8
            toks[:, t] = np.where(
                follow, succ[toks[:, t - 1]],
                rng.choice(vocab, size=batch, p=probs))
        return {"tokens": torch.from_numpy(toks.astype(np.int32))}

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        while not stop.is_set():
            item = make_batch()
            while not stop.is_set():
                try:
                    q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
