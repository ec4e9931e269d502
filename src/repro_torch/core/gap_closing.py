"""Gap closing (paper §III-D) + scaffold sequence rendering (mirrors
`repro.core.gap_closing`).

Each gap between adjacent scaffold members is attacked with the localized
mer-walk of local assembly: walk rightward from the left member's
inward-facing end, using reads localized to the flanking contigs, until
the walk produces the right member's leading seed.  The target check runs
inside the walk (`ops.mer_walk` with seed_len > 0).  Unclosed gaps render
as N runs sized by the link's gap estimate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

from . import kmer, local_assembly
from .scaffolding import Scaffolds
from .types import ContigSet, ReadSet

NONE = -1


class ScaffoldSeqs(NamedTuple):
    bases: torch.Tensor        # [S, Lmax] uint8 (4 = pad / N)
    lengths: torch.Tensor      # [S] int32
    closed: torch.Tensor       # [S, M] bool gap after member j walk-closed
    n_scaffolds: torch.Tensor  # 0-dim int32


def _member_bases(contigs: ContigSet, cid, orient, Lmax: int,
                  width: int | None = None):
    """Oriented bases of scaffold members ([n] contig ids, -1 none), padded
    to Lmax, and their lengths.  `width` keeps only the first columns (the
    reference's output sliced), without the full-width gather."""
    dev = contigs.bases.device
    row = cid.clamp(min=0).to(torch.int64)[:, None]
    length = torch.where(cid >= 0, contigs.lengths[row[:, 0]], 0)
    i = torch.arange(width or Lmax, dtype=torch.int64, device=dev)[None, :]
    fwd = contigs.bases[row, i]
    # rc: base j = complement(base[len-1-j])
    rc = kmer.complement_base(
        contigs.bases[row, (length[:, None] - 1 - i).clamp(0, Lmax - 1)])
    out = torch.where(orient[:, None] == 0, fwd, rc)
    return torch.where(i < length[:, None], out, 4).to(torch.uint8), length


def _gap_walks(wt: local_assembly.WalkTables, mer_sizes: tuple,
               tag_bits: int, left_tail_hi, left_tail_lo, left_contig,
               target_hi, target_lo, active, *, seed_len: int, max_walk: int,
               backend=None):
    """Walk from each gap's left flank; a walker stops with status HIT when
    the right flank's target seed is produced.  Returns (walk, hit,
    hit_pos)."""
    out = ops.mer_walk(
        wt, left_tail_hi, left_tail_lo, left_contig, active,
        mer_sizes=tuple(mer_sizes), tag_bits=tag_bits, max_ext=max_walk,
        target_hi=target_hi, target_lo=target_lo, seed_len=seed_len,
        backend=backend,
    )
    walk = local_assembly.WalkResult(
        ext_bases=out.ext_bases, ext_len=out.ext_len, status=out.status)
    return walk, out.hit, out.hit_pos


def close_and_render(scaffs: Scaffolds, contigs: ContigSet, reads: ReadSet,
                     aln_contig, *, seed_len: int = 17,
                     mer_sizes: tuple = (17, 21, 25),
                     walk_capacity: int = 1 << 16, max_walk: int = 64,
                     max_scaffold_len: int = 1 << 13, max_n_run: int = 64,
                     backend=None) -> ScaffoldSeqs:
    """Close gaps where possible, then render scaffold sequences."""
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    read_contig = local_assembly.localize_reads(reads, aln_contig)
    wt = local_assembly.build_walk_tables(
        reads, read_contig, mer_sizes=mer_sizes, tag_bits=tag_bits,
        capacity=walk_capacity, backend=backend,
    )
    return close_and_render_with_tables(
        scaffs, contigs, wt, seed_len=seed_len, mer_sizes=mer_sizes,
        max_walk=max_walk, max_scaffold_len=max_scaffold_len,
        max_n_run=max_n_run, backend=backend,
    )


def close_and_render_with_tables(
    scaffs: Scaffolds,
    contigs: ContigSet,
    wt: local_assembly.WalkTables,
    *,
    seed_len: int = 17,
    mer_sizes: tuple = (17, 21, 25),
    max_walk: int = 64,
    max_scaffold_len: int = 1 << 13,
    max_n_run: int = 64,
    backend=None,
) -> ScaffoldSeqs:
    """Gap closure from prebuilt walk tables, then rendering."""
    S, M = scaffs.contig.shape
    C = contigs.capacity
    Lc = contigs.max_len
    dev = contigs.bases.device
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    # per (scaffold, j) gap: left member j, right member j+1
    none_col = torch.full((S, 1), NONE, dtype=torch.int32, device=dev)
    right_c = torch.cat([scaffs.contig[:, 1:], none_col], dim=1)
    right_o = torch.cat([scaffs.orient[:, 1:],
                         torch.zeros((S, 1), dtype=torch.uint8, device=dev)],
                        dim=1)
    gap_active = (scaffs.contig >= 0) & (right_c >= 0)
    lc, lo_ = scaffs.contig.reshape(-1), scaffs.orient.reshape(-1)
    # left flank's inward-facing suffix buffer (oriented reading frame):
    # member fwd (o=0) -> its right end's suffix buffer ([C:]); member rc
    # (o=1) -> its left end's rc'd prefix ([:C])
    bhi, blo, _ = local_assembly.contig_end_buffers(
        contigs, torch.ones((C,), dtype=torch.bool, device=dev))
    lsel = lc.clamp(min=0).to(torch.int64)
    tail_hi = torch.where(lo_ == 0, bhi[C:][lsel], bhi[:C][lsel])
    tail_lo = torch.where(lo_ == 0, blo[C:][lsel], blo[:C][lsel])
    # target: right member's leading seed in scaffold orientation
    rbases, _ = _member_bases(contigs, right_c.reshape(-1),
                              right_o.reshape(-1), Lc, width=seed_len)
    t_hi, t_lo = kmer.pack_window(rbases, k=seed_len)
    walk, hit, hit_pos = _gap_walks(
        wt, mer_sizes=tuple(mer_sizes), tag_bits=tag_bits,
        left_tail_hi=tail_hi, left_tail_lo=tail_lo,
        left_contig=lc.clamp(min=0), target_hi=t_hi, target_lo=t_lo,
        active=gap_active.reshape(-1), seed_len=seed_len, max_walk=max_walk,
        backend=backend,
    )
    # closure bases: the walked bases minus the trailing seed overlap
    fill_len = torch.where(hit, (hit_pos - seed_len).clamp(min=0), NONE)
    fill_len = fill_len.to(torch.int32).reshape(S, M)
    # ---- render ----
    est_gap = scaffs.gap.clamp(1.0, float(max_n_run)).to(torch.int32)
    gap_len = torch.where(fill_len >= 0, fill_len,
                          torch.where(gap_active, est_gap, 0))
    # member lengths + offsets
    lens = torch.where(scaffs.contig >= 0,
                       contigs.lengths[scaffs.contig.clamp(min=0).long()], 0)
    offsets = torch.zeros((S, M), dtype=torch.int64, device=dev)
    offsets[:, 1:] = torch.cumsum(lens + gap_len, dim=1)[:, :-1]
    total = torch.where(scaffs.contig >= 0, offsets + lens, 0).amax(dim=1)
    out = torch.full((S, max_scaffold_len), 4, dtype=torch.uint8, device=dev)
    pos_in_contig = torch.arange(Lc, dtype=torch.int64, device=dev)[None, :]
    n_walk = walk.ext_bases.shape[1]
    wpos = torch.arange(n_walk, dtype=torch.int64, device=dev)[None, :]
    for j in range(M):
        # only scaffolds with a member j write anything for it
        rows = (scaffs.contig[:, j] >= 0).nonzero().squeeze(1)
        if not rows.numel():
            continue
        mb, ml = _member_bases(contigs, scaffs.contig[rows, j],
                               scaffs.orient[rows, j], Lc)
        rowpos = offsets[rows, j, None] + pos_in_contig
        okm = (pos_in_contig < ml[:, None]) & (rowpos < max_scaffold_len)
        r2 = rows[:, None].expand(-1, Lc)
        out[r2[okm], rowpos[okm]] = mb[okm]
        # walked closure bases after member j (flat gap index = s*M + j)
        wbases = walk.ext_bases[rows * M + j]
        fl = fill_len[rows, j]
        growpos = offsets[rows, j, None] + ml[:, None] + wpos
        okw = ((wpos < fl.clamp(min=0)[:, None]) & (fl >= 0)[:, None]
               & (growpos < max_scaffold_len))
        r2 = rows[:, None].expand(-1, n_walk)
        out[r2[okw], growpos[okw]] = wbases[okw]
    lengths = total.clamp(max=max_scaffold_len)
    lengths = torch.where(scaffs.n_members > 0, lengths, 0).to(torch.int32)
    return ScaffoldSeqs(bases=out, lengths=lengths, closed=fill_len >= 0,
                        n_scaffolds=scaffs.n_scaffolds)
