"""Fixed-shape read-batch sources for out-of-core assembly (mirrors
`repro.stream.batches`).

A dataset is a *batch source*: an object that can be iterated again and
again (`iter(source)` starts a fresh pass) and whose every batch is a
`ReadSet` of the same shape `[batch_reads, max_len]`.  The two-pass Bloom
admission and every assembly round re-stream the data.  Batches live on
the host as CPU tensors; the execution context moves one batch at a time
to its device.

Padding rows are inert: zero length, all-INVALID bases, mate -1.  Mate
pointers are batch-local (a batch always holds whole pairs).
"""
from __future__ import annotations

from typing import Callable, Iterator, List

import numpy as np
import torch

from repro_torch.core.types import INVALID_BASE, ReadSet


def pad_batch(reads: ReadSet, batch_reads: int) -> ReadSet:
    """Pad a ReadSet up to exactly `batch_reads` rows with inert rows."""
    R, L = reads.bases.shape
    if R > batch_reads:
        raise ValueError(f"batch has {R} rows > batch_reads={batch_reads}")
    if R == batch_reads:
        return reads
    pad = batch_reads - R
    dev = reads.bases.device
    return ReadSet(
        bases=torch.cat([reads.bases, torch.full(
            (pad, L), INVALID_BASE, dtype=torch.uint8, device=dev)]),
        lengths=torch.cat([reads.lengths, torch.zeros(
            (pad,), dtype=torch.int32, device=dev)]),
        mate=torch.cat([reads.mate, torch.full(
            (pad,), -1, dtype=torch.int32, device=dev)]),
        insert_size=reads.insert_size,
    )


def batches_from_readset(reads: ReadSet, batch_reads: int) -> List[ReadSet]:
    """Slice an in-memory ReadSet into fixed-shape, pair-atomic batches.

    Batch b holds rows [b * batch_reads, (b+1) * batch_reads) in their
    original order, so concatenating per-batch outputs gives the in-memory
    layout.  Mate pointers rebase to batch-local indices; a mate outside
    its read's batch is severed (-1), which an even `batch_reads` and the
    interleaved (r1, r2) pair convention prevent.
    """
    if batch_reads < 2 or batch_reads % 2:
        raise ValueError(f"batch_reads={batch_reads} must be even and >= 2")
    R = int(reads.num_reads)
    mate = reads.mate.cpu().numpy()
    out = []
    for start in range(0, R, batch_reads):
        stop = min(start + batch_reads, R)
        m = mate[start:stop]
        local = np.where((m >= start) & (m < stop), m - start,
                         -1).astype(np.int32)
        out.append(pad_batch(ReadSet(
            bases=reads.bases[start:stop],
            lengths=reads.lengths[start:stop],
            mate=torch.from_numpy(local).to(reads.mate.device),
            insert_size=reads.insert_size,
        ), batch_reads))
    return out


class BatchSource:
    """Re-iterable batch source built from an iterator factory.

    Each `iter()` calls `make_iter()` afresh, so every pass re-streams from
    the start.  The factory must be deterministic: all passes must see the
    same batches in the same order.
    """

    def __init__(self, make_iter: Callable[[], Iterator[ReadSet]]):
        self._make_iter = make_iter

    def __iter__(self) -> Iterator[ReadSet]:
        return iter(self._make_iter())


def require_reiterable(batches) -> None:
    """Reject single-shot iterators (they return themselves from `iter()`)
    up front, instead of letting pass 2 see an exhausted stream."""
    if iter(batches) is batches:
        raise TypeError(
            "batch source is a single-shot iterator; the streaming "
            "pipeline iterates the data several times (two-pass Bloom "
            "admission, per-round alignment) — wrap the generator in "
            "repro_torch.stream.BatchSource(lambda: <make iterator>) or "
            "pass a sequence"
        )


def check_batch_shapes(batches) -> tuple:
    """Validate the source contract; returns (batch_reads, max_len) of the
    first batch, the only one it reads."""
    require_reiterable(batches)
    it = iter(batches)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("empty batch source") from None
    return int(first.num_reads), int(first.max_len)
