"""Shared record types and conventions (mirrors `repro.core.types`).

Base encoding: A=0, C=1, G=2, T=3, 4 = N / invalid / pad.

K-mer packing: k <= 31 bases, 2 bits each, MSB-first, held as a dual-lane
(hi, lo) pair of 32-bit words, code = hi * 2**32 + lo.  Bits 62..63 are
always zero, so the all-ones `hi` is free to act as the EMPTY sentinel.

Lane dtype: every uint32 lane (k-mer hi/lo, hashes, table keys) is stored
as a **torch.int32 tensor holding the same 32-bit pattern**.  The CUDA
kernels read it as `uint32_t`.  PyTorch on the CPU cannot shift or compare
`torch.uint32`, so the plain versions widen a lane to int64, mask it to 32
bits (`widen`), compute, and narrow the result back (`narrow`).  Unsigned
order of two lanes is the order of their widened values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_BASE = 4  # N / pad

# Extension codes (per side of a k-mer); 0..3 are the bases themselves.
EXT_F = 4  # fork: multiple candidate extensions survive the threshold
EXT_X = 5  # no extension observed (dead end)

EMPTY_HI = 0xFFFFFFFF  # hi-lane sentinel for empty hash slots (unsigned)
LANE_DTYPE = torch.int32
U32_MASK = 0xFFFFFFFF

COMP = (3, 2, 1, 0, 4)  # A<->T, C<->G, N->N


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 lane bit pattern -> int64 holding the unsigned value."""
    return x.to(torch.int64) & U32_MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 (any value; low 32 bits kept) -> int32 lane bit pattern."""
    return (((x & U32_MASK) ^ 0x80000000) - 0x80000000).to(LANE_DTYPE)


def lane_const(value: int) -> int:
    """Python int in [0, 2**32) -> the int32 value with the same bits."""
    return ((value & U32_MASK) ^ 0x80000000) - 0x80000000


def sort_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order is the unsigned (hi, lo) order.

    A plain `hi << 32 | lo` would put the 0xFFFFFFFF sentinel rows first;
    offsetting `hi` by 2**31 keeps them last, as `lax.sort` on uint32 does.
    """
    return (widen(hi) - 0x80000000) * (1 << 32) + widen(lo)


def drop_rows(idx: torch.Tensor, n: int):
    """(keep, row): where a JAX `.at[idx]` scatter with mode="drop" writes
    into an n-row array.  JAX wraps a negative index once (-1 is row n-1)
    and then drops what lies outside [0, n); callers index with row[keep].
    """
    row = idx.to(torch.int64)
    row = torch.where(row < 0, row + n, row)
    return (row >= 0) & (row < n), row


class ReadSet(NamedTuple):
    """A batch of (possibly paired) reads, dense [R, L] layout.

    bases:   [R, L] uint8 codes (4 = pad past `lengths`).
    lengths: [R] int32 actual read lengths.
    mate:    [R] int32 index of the mate read, -1 if unpaired.
    insert_size: library insert size (fragment length).
    """

    bases: torch.Tensor
    lengths: torch.Tensor
    mate: torch.Tensor
    insert_size: int

    @property
    def num_reads(self) -> int:
        return self.bases.shape[0]

    @property
    def max_len(self) -> int:
        return self.bases.shape[1]

    def to(self, device) -> "ReadSet":
        return ReadSet(self.bases.to(device), self.lengths.to(device),
                       self.mate.to(device), self.insert_size)


class ContigSet(NamedTuple):
    """Dense contig storage.

    bases:   [C, Lmax] uint8 (4 past length)
    lengths: [C] int32 (0 = dead/empty slot)
    depths:  [C] float32 mean k-mer depth
    """

    bases: torch.Tensor
    lengths: torch.Tensor
    depths: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.bases.shape[0]

    @property
    def max_len(self) -> int:
        return self.bases.shape[1]


class KmerSet(NamedTuple):
    """Counted canonical k-mers with per-side extension statistics.

    All arrays have length `capacity`; live slots are flagged by `used`.
    """

    hi: torch.Tensor          # [cap] int32 lane
    lo: torch.Tensor          # [cap] int32 lane
    count: torch.Tensor       # [cap] int32 occurrence count
    left_cnt: torch.Tensor    # [cap, 4] int32 per-base left-extension counts
    right_cnt: torch.Tensor   # [cap, 4] int32
    left_ext: torch.Tensor    # [cap] uint8 EXT_* code
    right_ext: torch.Tensor   # [cap] uint8
    used: torch.Tensor        # [cap] bool

    @property
    def capacity(self) -> int:
        return self.hi.shape[0]
