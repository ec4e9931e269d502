"""Distributed assembly pipeline: the paper's sharded phases on a leading
shard axis (mirrors `repro.dist.pipeline`).

  * `distributed_kmer_analysis`: §II-A / Alg. 2, each shard extracts and
    pre-combines its k-mer occurrences, routes every entry to its hash
    owner (`core.exchange`), and the owner reduces the partial (count,
    extension histogram) tuples into its shard of the global table.
    Ownership is total, so the per-shard min-count and extension finalize
    is globally correct.
  * `localize_reads`: §II-I / Fig. 3, move each read to the shard that
    owns its aligned contig.
  * `shard_reads` / `gather_ksets`: pad-and-split host data over the
    shards, and merge owner tables back into one key-sorted table.

The reference runs one shard a device under `shard_map`; here the S
shards spread over the W ranks of a `core.exchange.DataMesh`, and a rank
runs its S/W shards one after another on row block i of its shard-major
arrays (`dist.stages`).  A "mesh" argument is the shard count (one
process, every shard), a `DataMesh`, or a `Mesh` context.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import kmer_analysis
from repro_torch.core.kmer_analysis import ExtensionPolicy
from repro_torch.core.types import INVALID_BASE, KmerSet, widen
from repro_torch.kernels import ops
from repro_torch.core.exchange import DataMesh


def data_mesh_of(mesh) -> DataMesh:
    """The `DataMesh` of a mesh argument: a `DataMesh`, a `Mesh` context's
    own, or, for a shard count, one process holding every shard."""
    if isinstance(mesh, DataMesh):
        return mesh
    return getattr(mesh, "data_mesh", None) or DataMesh(int(mesh))


class ShardedReads(NamedTuple):
    """A ReadSet padded to an even per-shard split, plus a validity mask.

    Layout is shard-major: rows [s * (R/S), (s+1) * (R/S)) belong to shard
    s.  Padding rows have `valid=False`, zero length and all-INVALID bases,
    so every downstream consumer ignores them without the mask; the mask
    is for exact accounting.  Mate pointers index the original read order
    and are invalidated (-1) whenever rows move (localization).
    """

    bases: torch.Tensor    # [R, L] uint8
    lengths: torch.Tensor  # [R] int32
    mate: torch.Tensor     # [R] int32
    insert_size: int
    valid: torch.Tensor    # [R] bool

    @property
    def num_reads(self) -> int:
        return self.bases.shape[0]

    @property
    def max_len(self) -> int:
        return self.bases.shape[1]


def shard_reads(reads, num_shards: int, shards: range | None = None,
                device=None) -> ShardedReads:
    """Pad a ReadSet so its rows split evenly over `num_shards` shards.

    `shards`: keep only these shards' row blocks (a rank's shards of a
    mesh; default all), cut before anything moves to `device` (default:
    the reads' device), so a rank never holds the other ranks' rows.
    """
    R, L = reads.bases.shape
    per = -(-R // num_shards)
    shards = range(num_shards) if shards is None else shards
    lo, hi = shards.start * per, shards.stop * per
    pad = hi - max(lo, min(hi, R))
    move = (lambda x: x) if device is None else (lambda x: x.to(device))
    dev = reads.bases.device if device is None else torch.device(device)
    valid = torch.arange(lo, hi, device=dev) < R
    rows = tuple(move(x[lo:min(hi, R)])
                 for x in (reads.bases, reads.lengths, reads.mate))
    if pad == 0:
        return ShardedReads(bases=rows[0], lengths=rows[1], mate=rows[2],
                            insert_size=reads.insert_size, valid=valid)
    return ShardedReads(
        bases=torch.cat([rows[0], torch.full(
            (pad, L), INVALID_BASE, dtype=torch.uint8, device=dev)]),
        lengths=torch.cat([rows[1], torch.zeros(
            (pad,), dtype=torch.int32, device=dev)]),
        mate=torch.cat([rows[2], torch.full(
            (pad,), -1, dtype=torch.int32, device=dev)]),
        insert_size=reads.insert_size,
        valid=valid,
    )


def kmer_owner(hi, lo, num_shards: int):
    """Owner shard of a canonical k-mer: the high half-word of the
    avalanche hash modulo S.  The hash table's home slots take the hash's
    low bits, so owning by the high bits keeps a shard's keys spread over
    all its table's slots.  The hash lane holds uint32 bits in an int32
    tensor: it is widened before the logical shift and the modulo."""
    h = widen(ops.kmer_hash(hi, lo))
    return ((h >> 16) % num_shards).to(torch.int32)


def distributed_kmer_analysis(
    reads,
    mesh,
    *,
    k: int,
    pre_capacity: int,
    capacity: int,
    route_capacity: Optional[int] = None,
    min_count: int = 2,
    policy: ExtensionPolicy = ExtensionPolicy(),
    backend=None,
):
    """Alg. 2: sharded k-mer counting with owner exchange.

    Returns (kset, route_overflow, table_overflow): kset has flat
    [S/W * capacity] arrays, rows [i*capacity, (i+1)*capacity) the owner
    table of the rank's i-th shard with live entries packed to the front
    in key order.
    """
    from . import stages

    m = data_mesh_of(mesh)
    return stages.sharded_kmer_analysis(
        shard_reads(reads, m.num_shards, m.shards), m, k=k,
        pre_capacity=pre_capacity, capacity=capacity,
        route_capacity=route_capacity, min_count=min_count, policy=policy,
        backend=backend,
    )


def gather_ksets(kset: KmerSet, *, capacity: int, mesh=None) -> dict:
    """Merge per-shard owner tables into one key-sorted count table.

    `kset` holds the owner tables of the shards `mesh` puts on this rank
    (all of them without a mesh); they all_gather over the mesh's ranks
    first, so the merged table is replicated.  Ownership is total, so
    each live key is on exactly one shard and the merge is a re-sort;
    `n_unique > capacity` is flagged in the returned dict's `overflow`.
    """
    cols = (kset.hi, kset.lo, kset.count, kset.left_cnt, kset.right_cnt,
            kset.used)
    if mesh is not None:
        cols = tuple(map(data_mesh_of(mesh).gather, cols))
    return kmer_analysis.aggregate_weighted(*cols, capacity=capacity)


def localize_reads(reads, aln_contig, mesh, *, out_factor: int = 2):
    """Fig. 3: move each read to the shard owning its aligned contig
    (contig c is owned by shard c mod S; unaligned reads stay home).

    `reads` (and `aln_contig`) are the rows of the shards `mesh` puts on
    this rank.  Returns (localized ShardedReads of out_factor times as
    many rows, overflow): overflow counts reads cut at the route lanes or
    the receiver block.
    """
    from . import stages

    m = data_mesh_of(mesh)
    R = reads.bases.shape[0]
    dev = reads.bases.device
    assert R % m.local_shards == 0, (
        f"reads rows {R} not divisible by {m.local_shards}; use "
        f"shard_reads")
    valid = getattr(reads, "valid", None)
    if valid is None:
        valid = reads.lengths > 0
    aln = torch.as_tensor(aln_contig, device=dev).to(torch.int32)[:R]
    if aln.shape[0] < R:
        aln = torch.cat([aln, torch.full((R - aln.shape[0],), -1,
                                         dtype=torch.int32, device=dev)])
    mate = getattr(reads, "mate", None)
    if mate is None:
        mate = torch.full((R,), -1, dtype=torch.int32, device=dev)
    sharded = ShardedReads(bases=reads.bases, lengths=reads.lengths,
                           mate=mate, insert_size=reads.insert_size,
                           valid=valid)
    localized, _, overflow = stages.localize_with(
        sharded, aln, (), m, out_factor=out_factor)
    return localized, overflow
