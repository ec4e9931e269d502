"""Open-addressed hash table for dual-lane keys (mirrors `repro.core.dht`).

Insertion runs in bulk-synchronous rounds: every pending key bids for its
current probe slot, the highest batch index wins, a key that meets itself
dedupes, a key that meets a different key advances one slot, and a race
loser retries the same slot.  Winners never move, so an empty slot ends
every probe chain that passes it and lookups stop there.

`insert` and `lookup` go through `kernels.ops.dht_insert` / `dht_lookup`:
the CUDA kernels for tensors on the card, the plain versions in
`kernels.ref` on the CPU.  Capacity must be a power of two.  Keys are int32
lane pairs with hi != EMPTY_HI (true of packed k-mers, k <= 31).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

from .types import EMPTY_HI, lane_const

NOT_FOUND = -1


class HashTable(NamedTuple):
    slot_hi: torch.Tensor    # [cap] int32 lane, EMPTY_HI when unused
    slot_lo: torch.Tensor    # [cap] int32 lane
    used: torch.Tensor       # [cap] bool
    max_probe: torch.Tensor  # 0-dim int32: probe bound for lookups

    @property
    def capacity(self) -> int:
        return self.slot_hi.shape[0]


def empty_table(capacity: int, device=None) -> HashTable:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return HashTable(
        slot_hi=torch.full((capacity,), lane_const(EMPTY_HI),
                           dtype=torch.int32, device=device),
        slot_lo=torch.zeros((capacity,), dtype=torch.int32, device=device),
        used=torch.zeros((capacity,), dtype=torch.bool, device=device),
        max_probe=torch.zeros((), dtype=torch.int32, device=device),
    )


def insert(table: HashTable, hi, lo, valid, *, backend=None):
    """Insert [n] keys, deduplicating against existing entries.

    Returns (table', slots): slots[i] is the slot of key i (-1 if invalid
    or the table overflowed for that key).
    """
    slot_hi, slot_lo, used, max_probe, slots = ops.dht_insert(
        table.slot_hi, table.slot_lo, table.used, table.max_probe,
        hi, lo, valid, backend=backend,
    )
    return HashTable(slot_hi, slot_lo, used, max_probe), slots


def build(hi, lo, valid, capacity: int, *, backend=None):
    """Build a fresh table from keys (duplicates collapse to one slot)."""
    return insert(empty_table(capacity, hi.device), hi, lo, valid,
                  backend=backend)


def lookup(table: HashTable, hi, lo, valid=None, *, backend=None):
    """Slot index of each query key; -1 when absent."""
    return ops.dht_lookup(table.slot_hi, table.slot_lo, table.used,
                          table.max_probe, hi, lo, valid, backend=backend)


def contains(table: HashTable, hi, lo, valid=None, *, backend=None):
    return lookup(table, hi, lo, valid, backend=backend) != NOT_FOUND
