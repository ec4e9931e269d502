"""Per-shard capacity budgets for the distributed pipeline (mirrors
`repro.dist.capacity`).

Every distributed stage works on statically shaped, capacity-padded
buffers: the local pre-combine table, the per-destination route buffers
and the owner table each have a size chosen before any data is seen, the
paper's memory discipline (MetaHipMer provisions its hash stores from an
upfront k-mer cardinality estimate, so per-node memory stays flat under
weak scaling, Table II).  Overflow is a reported measurement, never a
silent drop: every stage returns how many items exceeded its budget.
"""
from __future__ import annotations

import dataclasses


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def default_route_capacity(pre_capacity: int, num_shards: int,
                           *, slack: float = 2.0) -> int:
    """Per-(sender, destination) route buffer rows for a k-mer exchange.

    A sender holds at most `pre_capacity` pre-combined entries and hash
    ownership spreads them about evenly over `num_shards` destinations;
    `slack` absorbs the fluctuation, and a buffer never needs more rows
    than the sender holds.
    """
    assert pre_capacity >= 1 and num_shards >= 1
    want = int(slack * pre_capacity / num_shards)
    return max(1, min(pre_capacity, want))


@dataclasses.dataclass(frozen=True)
class KmerBudget:
    """Static buffer plan for one distributed k-mer analysis call.

    pre_capacity:   local pre-combine table rows per shard.
    route_capacity: rows per (sender, destination) pair in the exchange.
    table_capacity: owner-table rows per shard (post-exchange reduce).
    """

    num_shards: int
    pre_capacity: int
    route_capacity: int
    table_capacity: int

    def recv_rows(self) -> int:
        """Rows each shard receives from the exchange (all senders)."""
        return self.num_shards * self.route_capacity

    def bytes_per_shard(self) -> int:
        """Rough working-set bytes per shard (keys + count + two 4-wide
        int32 extension histograms = 48 B a row)."""
        row = 48
        return row * (self.pre_capacity + self.recv_rows()
                      + self.table_capacity)


def plan_kmer_budget(
    num_reads: int,
    read_len: int,
    k: int,
    num_shards: int,
    *,
    unique_rate: float = 0.5,
    slack: float = 2.0,
) -> KmerBudget:
    """Provision a KmerBudget from the dataset shape (§II-B).

    `unique_rate` is the expected unique-kmer : occurrence ratio of one
    shard's slice (~1/coverage for clean data, towards 1 for error-heavy
    data).
    """
    windows = max(read_len - k + 1, 1)
    occ_per_shard = -(-num_reads * windows // num_shards)
    pre = next_pow2(int(slack * unique_rate * occ_per_shard))
    route = default_route_capacity(pre, num_shards, slack=slack)
    # hash ownership splits the global unique population evenly, so the
    # owner table needs the same order of rows as the local pre-table
    table = pre
    return KmerBudget(
        num_shards=num_shards,
        pre_capacity=pre,
        route_capacity=route,
        table_capacity=table,
    )
