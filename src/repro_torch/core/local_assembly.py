"""Local assembly by mer-walking (paper §II-G; mirrors
`repro.core.local_assembly`).

Contigs are extended past their ends using only the reads localized to each
contig (aligned there, or mates of reads aligned there).  The mer tables
are keyed by (contig, mer): the contig id sits in the spare high bits of
the dual-lane key (`kmer.embed_tag`), so erroneous k-mers of
high-coverage regions cannot contaminate low-depth loci.

Mechanics preserved from the paper:
  * dynamic mer-size ladder: upshift on fork, downshift on dead end;
    terminate on fork-after-downshift / deadend-after-upshift;
  * uncontested low-quality extensions are accepted (min_votes=1).

The walk itself is `kernels.ops.mer_walk`: the CUDA kernel for tensors on
the card, the plain version on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (  # noqa: F401  (status codes)
    ACTIVE, BUF_K, DEADEND, DONE, FORK, HIT,
)

from . import dht, kmer
from .types import ContigSet, ReadSet, narrow

NONE = -1


class WalkTables(NamedTuple):
    """One tagged-mer hash table per ladder rung (mer sizes are passed
    beside it)."""

    tables: tuple            # tuple[dht.HashTable]
    right_hist: tuple        # tuple[[cap, 4] int32]
    left_hist: tuple


class WalkResult(NamedTuple):
    ext_bases: torch.Tensor  # [E, max_ext] uint8 accepted bases (4 pad)
    ext_len: torch.Tensor    # [E] int32
    status: torch.Tensor     # [E] int32 final status code


def localize_reads(reads: ReadSet, aln_contig):
    """Read -> contig assignment: own alignment, else the mate's (§II-G)."""
    mate = torch.where(reads.mate >= 0,
                       aln_contig[reads.mate.clamp(min=0).to(torch.int64)],
                       NONE)
    return torch.where(aln_contig >= 0, aln_contig, mate).to(torch.int32)


def _count_tagged(chi, clo, cleft, cright, valid, tag, *, m: int,
                  tag_bits: int, table: dht.HashTable, lh, rh,
                  backend=None):
    """Tag and histogram canonical (contig, mer) occurrences into a DHT.

    Inserts into `table` (a new table is returned) and adds each
    occurrence's canonical extensions onto `lh` / `rh` in place (they are
    the caller's fresh or accumulating histograms; updating them in place
    saves a copy of [cap, 4] per rung).  Rows that add nothing are dropped
    before the scatter.
    """
    thi, tlo = kmer.embed_tag(chi, clo, tag, k=m, tag_bits=tag_bits)
    table, slots = dht.insert(table, thi, tlo, valid, backend=backend)
    placed = valid & (slots >= 0)
    for hist, ext in ((lh, cleft), (rh, cright)):
        rows = placed & (ext < 4)
        cell = slots[rows].to(torch.int64) * 4 + ext[rows].to(torch.int64)
        hist.view(-1).index_add_(
            0, cell, torch.ones_like(cell, dtype=torch.int32))
    return table, lh, rh


def empty_walk_tables(*, mer_sizes: tuple, capacity: int,
                      device=None) -> WalkTables:
    """Empty per-rung tables, the identity of `accumulate_walk_tables`."""
    n = len(mer_sizes)
    zeros = lambda: torch.zeros((capacity, 4), dtype=torch.int32,
                                device=device)
    return WalkTables(
        tables=tuple(dht.empty_table(capacity, device) for _ in range(n)),
        right_hist=tuple(zeros() for _ in range(n)),
        left_hist=tuple(zeros() for _ in range(n)),
    )


def _fold_walk_tables(wt: WalkTables, reads: ReadSet, read_contig, *,
                      mer_sizes: tuple, tag_bits: int,
                      backend=None) -> WalkTables:
    """Fold one read batch's (contig, mer) occurrences into `wt`, whose
    histograms are updated in place.  Per-rung extraction runs through
    `kernels.ops.kmer_extract`."""
    tables = []
    R, L = reads.bases.shape
    for rung, m in enumerate(mer_sizes):
        lanes = ops.kmer_extract(reads.bases, reads.lengths, k=m,
                                 backend=backend)
        W = L - m + 1
        tag = read_contig[:, None].expand(R, W)
        v = lanes.valid[:, :W] & (read_contig[:, None] >= 0)
        flat = lambda x: x[:, :W].reshape(-1)
        t, _, _ = _count_tagged(
            flat(lanes.hi), flat(lanes.lo), flat(lanes.left),
            flat(lanes.right), v.reshape(-1), tag.reshape(-1), m=m,
            tag_bits=tag_bits, table=wt.tables[rung],
            lh=wt.left_hist[rung], rh=wt.right_hist[rung], backend=backend,
        )
        del lanes
        tables.append(t)
    return wt._replace(tables=tuple(tables))


def accumulate_walk_tables(wt: WalkTables, reads: ReadSet, read_contig, *,
                           mer_sizes: tuple, tag_bits: int,
                           backend=None) -> WalkTables:
    """Fold one read batch's (contig, mer) occurrences into a copy of `wt`;
    `wt` itself is left as it was."""
    wt = wt._replace(right_hist=tuple(h.clone() for h in wt.right_hist),
                     left_hist=tuple(h.clone() for h in wt.left_hist))
    return _fold_walk_tables(wt, reads, read_contig, mer_sizes=mer_sizes,
                             tag_bits=tag_bits, backend=backend)


def build_walk_tables(reads: ReadSet, read_contig, *, mer_sizes: tuple,
                      tag_bits: int, capacity: int,
                      backend=None) -> WalkTables:
    """Walk tables of one read set: folded in place into fresh zeros."""
    return _fold_walk_tables(
        empty_walk_tables(mer_sizes=mer_sizes, capacity=capacity,
                          device=reads.bases.device),
        reads, read_contig, mer_sizes=mer_sizes, tag_bits=tag_bits,
        backend=backend,
    )


def mer_walk(wt: WalkTables, start_hi, start_lo, contig, active0, *,
             mer_sizes: tuple, tag_bits: int, max_ext: int = 64,
             min_votes: int = 1, dominance: int = 4,
             backend=None) -> WalkResult:
    """Dynamic-mer walk for E walkers (2 per contig) through
    `ops.mer_walk`; start_hi/lo are the BUF_K-wide packed suffixes of the
    contig ends, oriented so the walk appends rightward."""
    out = ops.mer_walk(
        wt, start_hi, start_lo, contig, active0,
        mer_sizes=tuple(mer_sizes), tag_bits=tag_bits, max_ext=max_ext,
        min_votes=min_votes, dominance=dominance, backend=backend,
    )
    return WalkResult(ext_bases=out.ext_bases, ext_len=out.ext_len,
                      status=out.status)


def _gather_cols(bases, pos):
    return torch.gather(bases, 1, pos.to(torch.int64))


def contig_end_buffers(contigs: ContigSet, alive):
    """BUF_K-wide packed suffix per contig end, oriented to extend rightward.

    End 0 (left): the RC of the contig prefix; end 1 (right): the suffix.
    Short contigs (< BUF_K) repeat their first base as the reference's
    clamped gather does; walks on contigs shorter than the top rung are
    disabled by the caller.
    """
    C, Lmax = contigs.bases.shape
    dev = contigs.bases.device
    idx = torch.arange(BUF_K, dtype=torch.int32, device=dev)[None, :]
    L = contigs.lengths[:, None]
    suffix = _gather_cols(contigs.bases, (L - BUF_K + idx).clamp(0, Lmax - 1))
    suffix = torch.where(suffix > 3, 0, suffix)  # pad -> A
    s_hi, s_lo = kmer._pack64(suffix, BUF_K)
    prefix = _gather_cols(contigs.bases, idx.clamp(0, Lmax - 1).expand(C, -1))
    prefix = torch.where(prefix > 3, 0, prefix)
    p_hi, p_lo = kmer._pack64(prefix, BUF_K)
    rp_hi, rp_lo = kmer._rc64(p_hi, p_lo, BUF_K)
    return (
        narrow(torch.cat([rp_hi, s_hi])),
        narrow(torch.cat([rp_lo, s_lo])),
        torch.cat([alive, alive]),
    )


def apply_extensions(contigs: ContigSet, alive, walk: WalkResult):
    """Graft the walked bases onto the contigs (left end RC'd back);
    lengths are truncated at the buffer width Lmax."""
    C, Lmax = contigs.bases.shape
    dev = contigs.bases.device
    max_ext = walk.ext_bases.shape[1]
    lext = walk.ext_bases[:C]      # left walks (in RC frame)
    rext = walk.ext_bases[C:]
    nL = torch.where(alive, walk.ext_len[:C], 0)[:, None]
    nR = torch.where(alive, walk.ext_len[C:], 0)[:, None]
    L = contigs.lengths[:, None]
    new_len = torch.minimum(L + nL + nR, torch.tensor(Lmax, device=dev))
    i = torch.arange(Lmax, dtype=torch.int32, device=dev)[None, :]
    z1 = kmer.complement_base(
        _gather_cols(lext, (nL - 1 - i).clamp(0, max_ext - 1)))
    z2 = _gather_cols(contigs.bases, (i - nL).clamp(0, Lmax - 1))
    z3 = _gather_cols(rext, (i - nL - L).clamp(0, max_ext - 1))
    out = torch.where(i < nL, z1, torch.where(
        i < nL + L, z2, torch.where(i < new_len, z3, 4))).to(torch.uint8)
    out = torch.where(alive[:, None], out, contigs.bases)
    new_len = torch.where(alive, new_len[:, 0], contigs.lengths)
    return ContigSet(bases=out, lengths=new_len.to(torch.int32),
                     depths=contigs.depths)


def _tag_bits(mer_sizes, C: int) -> int:
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    if C > 1 << tag_bits:
        raise ValueError(f"contig capacity {C} exceeds tag space "
                         f"{1 << tag_bits}")
    return tag_bits


def extend_with_tables(wt: WalkTables, contigs: ContigSet, alive, *,
                       mer_sizes: tuple, max_ext: int = 64,
                       min_len: int | None = None, backend=None):
    """Walk both ends from prebuilt tables and graft the extensions.
    Returns (extended contigs, WalkResult)."""
    C = contigs.capacity
    tag_bits = _tag_bits(mer_sizes, C)
    bhi, blo, act = contig_end_buffers(contigs, alive)
    min_len = min_len if min_len is not None else max(mer_sizes)
    long_enough = contigs.lengths >= min_len
    act = act & torch.cat([long_enough, long_enough])
    cid = torch.arange(C, dtype=torch.int32, device=contigs.bases.device)
    walk = mer_walk(wt, bhi, blo, torch.cat([cid, cid]), act,
                    mer_sizes=tuple(mer_sizes), tag_bits=tag_bits,
                    max_ext=max_ext, backend=backend)
    return apply_extensions(contigs, alive, walk), walk


def extend_contigs(reads: ReadSet, contigs: ContigSet, alive, aln_contig, *,
                   mer_sizes: tuple = (17, 21, 25), capacity: int = 1 << 16,
                   max_ext: int = 64, min_len: int | None = None,
                   backend=None):
    """Full §II-G stage: localize -> tables -> walk both ends -> graft."""
    tag_bits = _tag_bits(mer_sizes, contigs.capacity)
    read_contig = localize_reads(reads, aln_contig)
    wt = build_walk_tables(reads, read_contig, mer_sizes=mer_sizes,
                           tag_bits=tag_bits, capacity=capacity,
                           backend=backend)
    return extend_with_tables(wt, contigs, alive, mer_sizes=mer_sizes,
                              max_ext=max_ext, min_len=min_len,
                              backend=backend)
