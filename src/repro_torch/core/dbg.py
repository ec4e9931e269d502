"""De Bruijn graph traversal -> contigs (paper §II-C; mirrors
`repro.core.dbg`).

Each canonical k-mer i yields two oriented nodes, u = i (as stored) and
u = i + N (reverse complement).  succ(u) follows the oriented right
extension; an edge survives only if the reverse edge agrees
(succ(rc(v)) == rc(u)).  Chains are contracted by pointer doubling
(`chain`); every chain appears once per strand and the strand with the
smaller head index is emitted.

Where the reference gathers with out-of-range indices (clamped by JAX) or
scatters past the end (`mode="drop"`), the results are masked either way;
here the indices are clamped explicitly and dropped writes are filtered.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import chain, dht, kmer
from .types import ContigSet, KmerSet

NONE = -1


class KmerIndex(NamedTuple):
    """Hash table over the live k-mers of a KmerSet, mapping key -> row."""

    table: dht.HashTable
    slot_to_row: torch.Tensor  # [table_cap] int32


def build_index(kset: KmerSet, table_capacity: int | None = None, *,
                backend=None) -> KmerIndex:
    cap = table_capacity or 2 * kset.capacity
    table, slots = dht.build(kset.hi, kset.lo, kset.used, capacity=cap,
                             backend=backend)
    slot_to_row = torch.full((cap,), NONE, dtype=torch.int32,
                             device=kset.hi.device)
    rows = torch.nonzero(slots >= 0).squeeze(1)
    slot_to_row[slots[rows].to(torch.int64)] = rows.to(torch.int32)
    return KmerIndex(table=table, slot_to_row=slot_to_row)


def lookup_rows(index: KmerIndex, hi, lo, valid=None, *, backend=None):
    slots = dht.lookup(index.table, hi, lo, valid, backend=backend)
    row = index.slot_to_row[slots.clamp(min=0).to(torch.int64)]
    return torch.where(slots >= 0, row, NONE)


def _oriented_code(kset: KmerSet, *, k: int):
    """Packed code of both orientations: [2N] (hi, lo)."""
    rhi, rlo = kmer.reverse_complement(kset.hi, kset.lo, k=k)
    return torch.cat([kset.hi, rhi]), torch.cat([kset.lo, rlo])


def _oriented_ext(kset: KmerSet):
    """Right extension code in each orientation's reading frame: [2N]."""
    rc_right = torch.where(kset.left_ext < 4, (3 - kset.left_ext).to(
        torch.uint8), kset.left_ext)
    return torch.cat([kset.right_ext, rc_right])


def _rc_node(x, n: int):
    return torch.where(x >= 0, (x + n) % (2 * n), NONE)


def oriented_successors(kset: KmerSet, index: KmerIndex, *, k: int,
                        backend=None):
    """succ[u] (int64) for all 2N oriented nodes, after mutual agreement."""
    n = kset.capacity
    ohi, olo = _oriented_code(kset, k=k)
    rext = _oriented_ext(kset)
    alive = torch.cat([kset.used, kset.used])
    has_ext = alive & (rext < 4)
    nhi, nlo = kmer.append_base(ohi, olo, rext & 3, k=k)
    chi, clo, flip = kmer.canonical(nhi, nlo, k=k)
    row = lookup_rows(index, chi, clo, has_ext, backend=backend)
    succ = torch.where((row >= 0) & has_ext,
                       row.to(torch.int64) + flip.to(torch.int64) * n, NONE)
    u = torch.arange(2 * n, dtype=torch.int64, device=succ.device)
    rc_v = _rc_node(succ, n)
    succ_rc_v = torch.where(succ >= 0, succ[rc_v.clamp(min=0)], NONE)
    mutual = (succ >= 0) & (succ_rc_v == _rc_node(u, n))
    return torch.where(mutual, succ, NONE)


class Traversal(NamedTuple):
    contigs: ContigSet
    node_contig: torch.Tensor  # [2N] int64 emitted contig id (-1 if none)
    node_pos: torch.Tensor     # [2N] int32 offset within the contig
    n_contigs: torch.Tensor    # 0-dim int64
    overflow: torch.Tensor     # 0-dim bool (contig count or length cap hit)


def traverse(kset: KmerSet, index: KmerIndex, *, k: int, contig_cap: int,
             max_len: int, backend=None) -> Traversal:
    """Contract unique-extension paths into contigs."""
    n = kset.capacity
    dev = kset.hi.device
    succ = oriented_successors(kset, index, k=k, backend=backend)
    u = torch.arange(2 * n, dtype=torch.int64, device=dev)
    rc = (u + n) % (2 * n)
    succ_rc = succ[rc]
    pred = torch.where(succ_rc >= 0, (succ_rc + n) % (2 * n), NONE)
    alive = torch.cat([kset.used, kset.used])
    chains = chain.form_chains(torch.where(alive, pred, NONE))
    length_nodes = chain.chain_stats(chains, alive)
    keep = alive & (chains.head <= chains.head[rc])
    is_head = keep & (chains.dist == 0)
    cid_of_head = torch.cumsum(is_head, dim=0) - 1
    n_contigs = torch.where(is_head.any(), cid_of_head[-1] + 1, 0)
    cid_all = torch.where(is_head, cid_of_head, NONE)
    node_cid = torch.where(keep, cid_all[chains.head], NONE)
    ohi, olo = _oriented_code(kset, k=k)
    bases = torch.full((contig_cap, max_len), 4, dtype=torch.uint8,
                       device=dev)
    # heads write their k bases (only contigs that fit the buffer)
    heads = torch.nonzero(is_head & (cid_all < contig_cap)).squeeze(1)
    hrow = cid_all[heads]
    kc = min(k, max_len)
    bases[hrow[:, None], torch.arange(kc, device=dev)[None, :]] = kmer.decode(
        ohi[heads], olo[heads], k=k)[:, :kc]
    # every other node writes its last base at column k-1+dist
    col = (k - 1 + chains.dist).to(torch.int64)
    tail = torch.nonzero(keep & (chains.dist > 0) & (node_cid >= 0)
                         & (node_cid < contig_cap) & (col < max_len)
                         ).squeeze(1)
    bases[node_cid[tail], col[tail]] = kmer.last_base(ohi[tail], olo[tail],
                                                      k=k)
    clen_nodes = torch.zeros((contig_cap,), dtype=torch.int32, device=dev)
    clen_nodes[hrow] = length_nodes[heads]
    lengths = torch.where(clen_nodes > 0,
                          torch.clamp(clen_nodes + k - 1, max=max_len), 0)
    # float32 depth sums of integer counts (exact below 2**24)
    counts2 = torch.cat([kset.count, kset.count]).to(torch.float32)
    on = torch.nonzero((node_cid >= 0) & (node_cid < contig_cap)).squeeze(1)
    depth_sum = torch.zeros((contig_cap,), dtype=torch.float32, device=dev)
    depth_sum.index_add_(0, node_cid[on], counts2[on])
    depths = depth_sum / torch.clamp(clen_nodes.to(torch.float32), min=1.0)
    overflow = (n_contigs > contig_cap) | torch.any(keep & (col >= max_len))
    return Traversal(
        contigs=ContigSet(bases=bases, lengths=lengths.to(torch.int32),
                          depths=depths),
        node_contig=node_cid,
        node_pos=chains.dist,
        n_contigs=n_contigs,
        overflow=overflow,
    )


def end_neighbor_forks(kset: KmerSet, index: KmerIndex, trav: Traversal, *,
                       k: int, contig_cap: int, backend=None):
    """For each contig end, the k-mer rows reachable one step past the end.

    Returns [contig_cap, 2, 4] int32 rows (-1 = absent): [c, 0, b] extends
    the contig's head leftward with base b, [c, 1, b] its tail rightward.
    """
    n = kset.capacity
    dev = kset.hi.device
    ohi, olo = _oriented_code(kset, k=k)
    alive = torch.cat([kset.used, kset.used])
    is_end = (trav.node_contig >= 0) & alive & (trav.node_contig < contig_cap)
    out = torch.full((contig_cap, 2, 4), NONE, dtype=torch.int32, device=dev)
    heads_mask = is_end & (trav.node_pos == 0)
    succ = oriented_successors(kset, index, k=k, backend=backend)
    tails_mask = is_end & (succ == NONE)
    for b in range(4):
        bb = torch.full((2 * n,), b, dtype=torch.uint8, device=dev)
        for side, mask, step in ((1, tails_mask, kmer.append_base),
                                 (0, heads_mask, kmer.prepend_base)):
            shi, slo = step(ohi, olo, bb, k=k)
            chi, clo, _ = kmer.canonical(shi, slo, k=k)
            row = lookup_rows(index, chi, clo, mask, backend=backend)
            hit = torch.nonzero(mask & (row >= 0)).squeeze(1)
            out[trav.node_contig[hit], side, b] = row[hit]
    return out
