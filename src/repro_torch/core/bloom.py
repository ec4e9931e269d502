"""Bloom filter (paper §II-B): drop singleton erroneous k-mers cheaply
(mirrors `repro.core.bloom`).

A k-mer is admitted to counting only on its second sighting, so the count
table never holds the population of error singletons.  The filter is a
dense bool vector of a power-of-two size; each key sets `num_hashes`
positions, the owner hash of the key with a salt XORed into its high
lane.  `insert` returns a new filter and leaves its input as it was.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import kmer
from .types import widen

_SALTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


class BloomFilter(NamedTuple):
    bits: torch.Tensor  # [m] bool
    num_hashes: int

    @property
    def size(self) -> int:
        return self.bits.shape[0]


def empty(m: int, num_hashes: int = 3, device=None) -> BloomFilter:
    assert m & (m - 1) == 0, "bloom size must be a power of two"
    assert 1 <= num_hashes <= len(_SALTS)
    return BloomFilter(bits=torch.zeros((m,), dtype=torch.bool,
                                        device=device),
                       num_hashes=num_hashes)


def _positions(f: BloomFilter, hi, lo):
    """int64 filter positions of each key, one tensor per hash."""
    whi, wlo = widen(hi), widen(lo)
    return [kmer._hash64(whi ^ salt, wlo) & (f.size - 1)
            for salt in _SALTS[: f.num_hashes]]


def insert(f: BloomFilter, hi, lo, valid) -> BloomFilter:
    """Set the positions of the valid keys (invalid rows are left out
    before the scatter, where the reference drops them)."""
    bits = f.bits.clone()
    rows = torch.nonzero(valid.reshape(-1)).squeeze(1)
    fhi, flo = hi.reshape(-1)[rows], lo.reshape(-1)[rows]
    for pos in _positions(f, fhi, flo):
        bits[pos] = True
    return BloomFilter(bits=bits, num_hashes=f.num_hashes)


def query(f: BloomFilter, hi, lo):
    """True where every position of the key is set (no false negatives)."""
    hit = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    for pos in _positions(f, hi, lo):
        hit &= f.bits[pos]
    return hit
