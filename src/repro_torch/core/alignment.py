"""merAligner (paper §II-F): seed-and-extend alignment (mirrors
`repro.core.alignment`).

Seeds (k-mers of the reads) are looked up in a seed index, a hash table
over the contig k-mers.  Each read votes among its seeds' candidate
placements and keeps the best two distinct-contig candidates
(`kernels.ops.seed_probe`); each candidate is verified by Hamming
extension, or with `gapped=True` by the banded Smith-Waterman extension
of `kernels.ops.sw_extend`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

from . import dht, kmer
from .types import INVALID_BASE, ContigSet, ReadSet, U32_MASK, lane_const, \
    sort_key

NONE = -1


class SeedIndex(NamedTuple):
    table: dht.HashTable
    contig: torch.Tensor  # [cap] int32 contig of the (unique) seed
    pos: torch.Tensor     # [cap] int32 position of seed start on the contig
    flip: torch.Tensor    # [cap] bool: stored canonical form is the RC
    multi: torch.Tensor   # [cap] bool seed occurs at >1 contig position
    seed_len: int


class Alignments(NamedTuple):
    """Top-2 distinct-contig placements per read (orient 1 = RC)."""

    contig: torch.Tensor   # [R, 2] int32 (-1 absent)
    cstart: torch.Tensor   # [R, 2] int32
    orient: torch.Tensor   # [R, 2] uint8
    matches: torch.Tensor  # [R, 2] int32
    overlap: torch.Tensor  # [R, 2] int32


def build_seed_index(contigs: ContigSet, alive, *, seed_len: int,
                     capacity: int, backend=None) -> SeedIndex:
    """Index every unique contig k-mer; multi-occurrence seeds are flagged.

    Among the rows of one key, the first in (key, row-major position)
    order represents it, as the reference's stable sort gives.
    """
    C, Lmax = contigs.bases.shape
    dev = contigs.bases.device
    lengths = torch.where(alive, contigs.lengths, 0)
    W = Lmax - seed_len + 1
    lanes = ops.kmer_extract(contigs.bases, lengths, k=seed_len,
                             backend=backend)
    flat = lambda x: x[:, :W].reshape(-1)
    fhi, flo, fvalid = flat(lanes.hi), flat(lanes.lo), flat(lanes.valid)
    fflip = flat(lanes.flip)
    del lanes
    none = lane_const(U32_MASK)
    shi = torch.where(fvalid, fhi, none)
    slo = torch.where(fvalid, flo, none)
    _, perm = torch.sort(sort_key(shi, slo), stable=True)
    shi_s, slo_s = shi[perm], slo[perm]
    first = torch.ones_like(fvalid)
    first[1:] = (shi_s[1:] != shi_s[:-1]) | (slo_s[1:] != slo_s[:-1])
    valid_s = fvalid[perm]
    seg = torch.cumsum(first, dim=0) - 1
    # a key is multi iff a valid row beyond its first exists
    group_multi = torch.zeros_like(fvalid)
    group_multi[seg[~first & valid_s]] = True
    is_rep = first & valid_s
    table, slots = dht.build(shi_s, slo_s, is_rep, capacity=capacity,
                             backend=backend)
    cap = table.capacity
    # The reference scatters at where(is_rep, slots, cap): a seed the full
    # table refused has slot -1, which its scatter wraps to the last slot.
    # Mirrored: such rows write slot cap-1 too, and the last write wins.
    rep = torch.nonzero(is_rep).squeeze(1)
    sel = slots[rep].to(torch.int64)
    sel = torch.where(sel >= 0, sel, cap - 1)
    at_last = torch.nonzero(sel == cap - 1).squeeze(1)
    if at_last.numel() > 1:
        keep = torch.ones_like(sel, dtype=torch.bool)
        keep[at_last[:-1]] = False
        rep, sel = rep[keep], sel[keep]
    src = perm[rep]
    contig_a = torch.full((cap,), NONE, dtype=torch.int32, device=dev)
    pos_a = torch.full((cap,), NONE, dtype=torch.int32, device=dev)
    flip_a = torch.zeros((cap,), dtype=torch.bool, device=dev)
    multi_a = torch.zeros((cap,), dtype=torch.bool, device=dev)
    contig_a[sel] = torch.div(src, W, rounding_mode="floor").to(torch.int32)
    pos_a[sel] = (src % W).to(torch.int32)
    flip_a[sel] = fflip[src]
    multi_a[sel] = group_multi[seg[rep]]
    return SeedIndex(table=table, contig=contig_a, pos=pos_a, flip=flip_a,
                     multi=multi_a, seed_len=seed_len)


def _seed_positions(read_len_max: int, seed_len: int, stride: int):
    pos = list(range(0, read_len_max - seed_len + 1, stride))
    last = read_len_max - seed_len
    if pos[-1] != last:
        pos.append(last)
    return pos


def _verify(reads: ReadSet, contigs: ContigSet, cid, cstart, orient):
    """Hamming-extension verification of one candidate per read."""
    R, L = reads.bases.shape
    dev = reads.bases.device
    i = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    fwd_cpos = cstart[:, None] + i
    rc_cpos = cstart[:, None] + (reads.lengths[:, None] - 1 - i)
    cpos = torch.where(orient[:, None] == 0, fwd_cpos, rc_cpos)
    crow = cid.clamp(min=0).to(torch.int64)
    clen = torch.where(cid >= 0, contigs.lengths[crow], 0)
    inside = ((cpos >= 0) & (cpos < clen[:, None])
              & (i < reads.lengths[:, None]))
    ccol = cpos.clamp(0, contigs.max_len - 1).to(torch.int64)
    cbase = contigs.bases[crow[:, None], ccol]
    rbase = reads.bases
    rbase_cmp = torch.where(orient[:, None] == 0, rbase,
                            kmer.complement_base(rbase))
    match = inside & (cbase == rbase_cmp) & (rbase < 4)
    return (match.sum(dim=-1).to(torch.int32),
            inside.sum(dim=-1).to(torch.int32))


def _verify_gapped(reads: ReadSet, contigs: ContigSet, cid, cstart, orient,
                   *, backend=None):
    """Banded Smith-Waterman verification of one candidate per read.

    The query is the read oriented onto the contig's forward strand; the
    target is the L-wide contig window starting at cstart, with 4s outside
    the contig.  Returns (score, overlap): the DP score replaces the
    Hamming match count, and the overlap is the Hamming inside-count, so
    downstream consumers see the same geometry either way.
    """
    R, L = reads.bases.shape
    dev = reads.bases.device
    _, ov = _verify(reads, contigs, cid, cstart, orient)
    i = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    rlen = reads.lengths[:, None]
    # reverse-complemented read, front-packed to its live length
    rc_idx = (rlen - 1 - i).clamp(min=0).to(torch.int64)
    rc = kmer.complement_base(torch.gather(reads.bases, 1, rc_idx))
    rc = torch.where(i < rlen, rc, INVALID_BASE)
    q = torch.where(orient[:, None] == 0, reads.bases, rc)
    cpos = cstart[:, None] + i
    crow = cid.clamp(min=0).to(torch.int64)
    clen = torch.where(cid >= 0, contigs.lengths[crow], 0)
    tin = (cpos >= 0) & (cpos < clen[:, None])
    ccol = cpos.clamp(0, contigs.max_len - 1).to(torch.int64)
    t = torch.where(tin, contigs.bases[crow[:, None], ccol], INVALID_BASE)
    qlen = torch.where(cid >= 0, reads.lengths, 0)
    tlen = torch.where(cid >= 0, L, 0).to(torch.int32)
    score, _, _ = ops.sw_extend(q.contiguous(), t.contiguous(), qlen, tlen,
                                backend=backend)
    return score, ov


def align_reads(reads: ReadSet, contigs: ContigSet, index: SeedIndex, *,
                seed_len: int, stride: int = 16, min_frac: float = 0.9,
                gapped: bool = False, backend=None) -> Alignments:
    """Seed-and-extend alignment of a read batch against the seed index.

    The front half is one `ops.seed_probe` call.  Verification is Hamming
    extension: a candidate is kept when matches >= min_frac * overlap and
    overlap >= seed_len.  `gapped=True` scores through `ops.sw_extend`
    instead, with the floor in the DP's units: score >= (2 * min_frac - 1)
    * overlap (equal when gap-free).  Both floors are float32, as the
    reference's weakly typed Python float.
    """
    pos_list = _seed_positions(reads.max_len, seed_len, stride)
    t = index.table
    cc, cs, co = ops.seed_probe(
        reads.bases, reads.lengths, t.slot_hi, t.slot_lo, t.used,
        t.max_probe, index.contig, index.pos, index.flip, index.multi,
        seed_len=seed_len, positions=tuple(pos_list), backend=backend,
    )
    floor = 2.0 * min_frac - 1.0 if gapped else min_frac
    frac = torch.tensor(floor, dtype=torch.float32, device=cc.device)
    cols = []
    for j in range(2):
        c, s, o = cc[:, j], cs[:, j], co[:, j]
        if gapped:
            m, ov = _verify_gapped(reads, contigs, c, s, o, backend=backend)
        else:
            m, ov = _verify(reads, contigs, c, s, o)
        ok = ((c >= 0) & (m >= frac * torch.clamp(ov, min=1))
              & (ov >= index.seed_len))
        cols.append((torch.where(ok, c, NONE), s, o, m, ov))
    return Alignments(*(torch.stack(x, dim=1) for x in zip(*cols)))
