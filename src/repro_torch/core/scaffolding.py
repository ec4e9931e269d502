"""Scaffolding (paper §III, Algorithm 3; mirrors `repro.core.scaffolding`).

  1. splint detection: reads whose two alignment hits land on different
     contigs (§III-B);
  2. span detection: mate pairs on different contigs, gap estimated from
     the library insert size (§III-B);
  3. link aggregation: a stable sort + segment reduce over (endA, endB);
  4. repeat suspension: span links that jump over a short repeat contig
     suspend it (§III-C);
  5. traversal as parallel greedy matching: every end proposes its best
     incident link, a link locks iff both ends chose it, repeat;
  6. connected components (`cc`) of the contig graph;
  7. chain formation: matched ends form an oriented functional graph that
     `chain` contracts.

JAX scatters drop out-of-range rows and wrap -1 to the last row
(`types.drop_rows`); every scatter here filters its rows first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cc, chain
from .types import ContigSet, ReadSet, drop_rows

NONE = -1
BIG = 0x7FFFFFFF
MAX_LINKS_PER_END = 4


class Links(NamedTuple):
    """Aggregated contig-end links, dense [Emax]."""

    end_a: torch.Tensor    # [E] int32 packed end id (contig*2 + end), a < b
    end_b: torch.Tensor    # [E] int32
    gap: torch.Tensor      # [E] float32 estimated gap (can be negative)
    support: torch.Tensor  # [E] int32 #splints + #spans
    splints: torch.Tensor  # [E] int32 #splint witnesses
    valid: torch.Tensor    # [E] bool


class Scaffolds(NamedTuple):
    """Chains of oriented contigs."""

    contig: torch.Tensor      # [S, M] int32 member contig ids (-1 pad)
    orient: torch.Tensor      # [S, M] uint8 0=fwd, 1=rc within the scaffold
    gap: torch.Tensor         # [S, M] float32 gap AFTER member j (last = 0)
    n_members: torch.Tensor   # [S] int32
    n_scaffolds: torch.Tensor  # 0-dim int32


def _half(x):
    """x // 2 rounded down, as jnp's floor division."""
    return torch.div(x, 2, rounding_mode="floor")


def _at(x, idx):
    """x[idx] for indices the reference clips at 0 (int64 for indexing)."""
    return x[idx.clamp(0, x.shape[0] - 1).to(torch.int64)]


def _hit_read_interval(cstart, orient, clen, read_len):
    """Read-frame interval [a, b) covered by the contig in this hit."""
    a = torch.where(orient == 0, -cstart, read_len - cstart - clen)
    b = torch.where(orient == 0, clen - cstart, read_len - cstart)
    return a, b


def find_splints(al, reads: ReadSet, contig_lengths):
    """Per-read splint candidate: (endA, endB, gap, valid)."""
    c0, c1 = al.contig[:, 0], al.contig[:, 1]
    both = (c0 >= 0) & (c1 >= 0) & (c0 != c1)
    L = reads.lengths
    a0, b0 = _hit_read_interval(al.cstart[:, 0], al.orient[:, 0],
                                _at(contig_lengths, c0), L)
    a1, b1 = _hit_read_interval(al.cstart[:, 1], al.orient[:, 1],
                                _at(contig_lengths, c1), L)
    # order along the read; require a real bridge (no containment)
    first_is_0 = a0 <= a1
    gap = torch.where(first_is_0, a1 - b0, a0 - b1)
    cf = torch.where(first_is_0, c0, c1)
    cs = torch.where(first_is_0, c1, c0)
    of = torch.where(first_is_0, al.orient[:, 0], al.orient[:, 1])
    os_ = torch.where(first_is_0, al.orient[:, 1], al.orient[:, 0])
    # end of the first contig facing read-right; end of second facing left
    end_f = cf * 2 + (of == 0).to(torch.int32)
    end_s = cs * 2 + (os_ != 0).to(torch.int32)
    max_len = reads.max_len
    valid = both & (gap > -max_len) & (gap < max_len)
    ea = torch.minimum(end_f, end_s)
    eb = torch.maximum(end_f, end_s)
    return ea, eb, gap.to(torch.float32), valid


def find_spans(al, reads: ReadSet, contig_lengths):
    """Per-pair span candidate from mate alignments (counted once)."""
    m = reads.mate
    r = torch.arange(reads.num_reads, dtype=m.dtype, device=m.device)
    has_mate = (m >= 0) & (r < m)  # count each pair once
    mi = m.clamp(min=0).to(torch.int64)
    c_r = al.contig[:, 0]
    c_m = torch.where(m >= 0, al.contig[mi, 0], NONE)
    both = has_mate & (c_r >= 0) & (c_m >= 0) & (c_r != c_m)
    L = reads.lengths
    cl_r = _at(contig_lengths, c_r)
    cl_m = _at(contig_lengths, c_m)
    o_r, o_m = al.orient[:, 0], al.orient[mi, 0]
    s_r, s_m = al.cstart[:, 0], al.cstart[mi, 0]
    # distance from fragment start to the contig end in fragment direction
    d_r = torch.where(o_r == 0, cl_r - s_r, s_r + L)
    d_m = torch.where(o_m == 0, cl_m - s_m,
                      s_m + torch.where(m >= 0, L[mi], 0))
    gap = reads.insert_size - d_r - d_m
    e_r = c_r * 2 + (o_r == 0).to(torch.int32)
    e_m = c_m * 2 + (o_m == 0).to(torch.int32)
    ea = torch.minimum(e_r, e_m)
    eb = torch.maximum(e_r, e_m)
    span = 2.0 * reads.insert_size
    valid = both & (gap > -span) & (gap < span)
    return ea, eb, gap.to(torch.float32), valid


def aggregate_links(ea, eb, gap, valid, is_splint, *, capacity: int) -> Links:
    """Stable sort + segment-reduce witnesses into per-pair links (§III-B).

    Every witness gap is an integer and the sums stay far below 2**24, so
    the float32 gap sums are exact in any order of addition.
    """
    dev = ea.device
    key_a = torch.where(valid, ea, BIG).to(torch.int64)
    key_b = torch.where(valid, eb, BIG).to(torch.int64)
    perm = torch.argsort(key_a * (1 << 32) + key_b, stable=True)
    ka, kb = key_a[perm], key_b[perm]
    g, sp, v = gap[perm], is_splint[perm], valid[perm]
    first = torch.ones_like(v)
    first[1:] = (ka[1:] != ka[:-1]) | (kb[1:] != kb[:-1])
    new_grp = v & first
    seg = torch.cumsum(new_grp.to(torch.int64), 0) - 1
    keep, row = drop_rows(torch.where(v, seg, capacity), capacity)
    seg_v = row[keep]
    support = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    support.index_add_(0, seg_v, torch.ones_like(seg_v, dtype=torch.int32))
    splints = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    splints.index_add_(0, seg_v, sp[keep].to(torch.int32))
    gap_sum = torch.zeros((capacity,), dtype=torch.float32, device=dev)
    gap_sum.index_add_(0, seg_v, g[keep])
    keep, row = drop_rows(torch.where(new_grp, seg, capacity), capacity)
    out_a = torch.full((capacity,), NONE, dtype=torch.int32, device=dev)
    out_b = torch.full((capacity,), NONE, dtype=torch.int32, device=dev)
    out_a[row[keep]] = ka[keep].to(torch.int32)
    out_b[row[keep]] = kb[keep].to(torch.int32)
    return Links(
        end_a=out_a,
        end_b=out_b,
        gap=gap_sum / support.to(torch.float32).clamp(min=1.0),
        support=support,
        splints=splints,
        valid=support > 0,
    )


def candidate_links(al, reads: ReadSet, contig_lengths):
    """Per-read link witnesses: splints + spans as flat candidate arrays
    (end_a, end_b, gap, valid, is_splint)."""
    sa, sb, sg, sv = find_splints(al, reads, contig_lengths)
    pa, pb, pg, pv = find_spans(al, reads, contig_lengths)
    return (torch.cat([sa, pa]), torch.cat([sb, pb]), torch.cat([sg, pg]),
            torch.cat([sv, pv]),
            torch.cat([torch.ones_like(sv), torch.zeros_like(pv)]))


def links_from_candidates(ea, eb, gap, valid, is_splint, alive, *,
                          capacity: int, min_support: int = 2) -> Links:
    """Aggregate candidate witnesses into the link store (contig scale)."""
    # drop links touching dead contigs
    valid = valid & _at(alive, _half(ea)) & _at(alive, _half(eb))
    links = aggregate_links(ea, eb, gap, valid, is_splint, capacity=capacity)
    # low-multiplicity links are pruned BEFORE CC to expose parallelism
    return links._replace(valid=links.valid & (links.support >= min_support))


def build_links(al, reads: ReadSet, contigs: ContigSet, alive, *,
                capacity: int, min_support: int = 2) -> Links:
    clens = torch.where(alive, contigs.lengths, 0)
    cands = candidate_links(al, reads, clens)
    return links_from_candidates(*cands, alive, capacity=capacity,
                                 min_support=min_support)


def _per_end_links(links: Links, n_ends: int):
    """Top-MAX_LINKS_PER_END incident links per end, by gap ascending.

    Returns (link_idx [n_ends, K] int32, count [n_ends] int32).  The rows
    are sorted stably by (end, gap), as the reference's `lax.sort`.
    """
    E = links.end_a.shape[0]
    dev = links.end_a.device
    K = MAX_LINKS_PER_END
    # each link appears at both ends
    ends = torch.cat([links.end_a, links.end_b])
    lidx = torch.arange(E, dtype=torch.int32, device=dev).repeat(2)
    key_end = torch.where(links.valid.repeat(2), ends, BIG)
    gap_q = links.gap.repeat(2).clamp(-1e6, 1e6)
    by_gap = torch.argsort(gap_q, stable=True)
    perm = by_gap[torch.argsort(key_end[by_gap], stable=True)]
    sk_end, s_lidx = key_end[perm], lidx[perm]
    first = torch.ones_like(sk_end, dtype=torch.bool)
    first[1:] = sk_end[1:] != sk_end[:-1]
    # rank within the end group
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    pos = torch.arange(2 * E, dtype=torch.int64, device=dev)
    start = torch.zeros((2 * E,), dtype=torch.int64, device=dev)
    start[seg[first]] = pos[first]
    pos_in_seg = pos - start[seg]
    valid_row = sk_end < BIG
    out = torch.full((n_ends, K), NONE, dtype=torch.int32, device=dev)
    keep, row = drop_rows(
        torch.where(valid_row & (pos_in_seg < K), sk_end, n_ends), n_ends)
    out[row[keep], pos_in_seg.clamp(0, K - 1)[keep]] = s_lidx[keep]
    count = torch.zeros((n_ends,), dtype=torch.int32, device=dev)
    keep, row = drop_rows(torch.where(valid_row, sk_end, n_ends), n_ends)
    count.index_add_(0, row[keep], torch.ones_like(row[keep],
                                                    dtype=torch.int32))
    return out, count


def suspend_repeats(links: Links, contig_lengths, insert_size, n_ends: int):
    """§III-C repeat suspension: a span jumping x—z over a short contig y
    (linked x—y and y—z) suspends y, removing its competing links."""
    end_links, _ = _per_end_links(links, n_ends)
    dev = links.end_a.device

    def other_end(lidx, my_end):
        a, b = _at(links.end_a, lidx), _at(links.end_b, lidx)
        return torch.where(a == my_end, b, a)

    ends = torch.arange(n_ends, dtype=torch.int32, device=dev)
    # the two closest links per end: y = closest, z = next
    l0, l1 = end_links[:, 0], end_links[:, 1]
    have2 = (l0 >= 0) & (l1 >= 0)
    y_end = other_end(l0, ends)      # near partner end
    z_end = other_end(l1, ends)
    y_c = _half(y_end)
    y_far_end = y_c * 2 + (1 - (y_end & 1))
    y_len = _at(contig_lengths, y_c).to(torch.float32)
    g_y, g_z = _at(links.gap, l0), _at(links.gap, l1)
    # geometric consistency: z sits roughly one y further out
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    consistent = (g_z - (g_y + y_len)).abs() <= f32(0.75 * insert_size)
    short_enough = y_len <= f32(insert_size)
    # require an existing link between y's far end and z's end
    far = _at(end_links, y_far_end)
    has_yz = torch.zeros((n_ends,), dtype=torch.bool, device=dev)
    for k in range(MAX_LINKS_PER_END):
        lk = far[:, k]
        has_yz = has_yz | ((lk >= 0) & (other_end(lk, y_far_end) == z_end))
    suspend_y = have2 & consistent & short_enough & has_yz
    C = n_ends // 2
    suspended = torch.zeros((C,), dtype=torch.bool, device=dev)
    keep, row = drop_rows(torch.where(suspend_y, y_c, C), C)
    suspended[row[keep]] = True
    # drop all links touching suspended contigs
    new_valid = (links.valid & ~_at(suspended, _half(links.end_a))
                 & ~_at(suspended, _half(links.end_b)))
    return links._replace(valid=new_valid), suspended


def greedy_matching(links: Links, contig_lengths, hmm_hit, *, n_ends: int,
                    rounds: int = 16):
    """Parallel greedy matching = the paper's longest-seed-first traversal.

    Link priority: longer min-member first, then closer gap, then higher
    support, as one float32 score in the reference's order of operations,
    ranked by a stable sort.  Ends with competing links are not extendable
    unless their contig is an HMM hit (§III-C rRNA rule).  Returns
    (matched_end [n_ends] int32, end_gap [n_ends] float32).
    """
    E = links.end_a.shape[0]
    dev = links.end_a.device
    _, end_cnt = _per_end_links(links, n_ends)
    minlen = torch.minimum(_at(contig_lengths, _half(links.end_a)),
                           _at(contig_lengths, _half(links.end_b)))
    score = (-(minlen.to(torch.float32) * 1e6) + links.gap.clamp(0, 1e5)
             - links.support.to(torch.float32) * 10.0)
    order = torch.argsort(score, stable=True)
    rank = torch.empty((E,), dtype=torch.int32, device=dev)
    rank[order] = torch.arange(E, dtype=torch.int32, device=dev)
    # extendability: <= 1 live link, or HMM-hit contig
    contig_of_end = torch.arange(n_ends, dtype=torch.int64, device=dev) // 2
    extendable = (end_cnt <= 1) | hmm_hit[contig_of_end]
    eligible = (links.valid & _at(extendable, links.end_a)
                & _at(extendable, links.end_b))
    rank = torch.where(eligible, rank, BIG)
    matched_end = torch.full((n_ends,), NONE, dtype=torch.int32, device=dev)
    link_used = torch.zeros((E,), dtype=torch.bool, device=dev)
    for _ in range(rounds):
        live = (eligible & ~link_used & (_at(matched_end, links.end_a) == NONE)
                & (_at(matched_end, links.end_b) == NONE))
        r = torch.where(live, rank, BIG)
        # each end's best live incident link (scatter-min)
        best = torch.full((n_ends,), BIG, dtype=torch.int32, device=dev)
        for e in (links.end_a, links.end_b):
            keep, row = drop_rows(torch.where(live, e, n_ends), n_ends)
            best.scatter_reduce_(0, row[keep], r[keep], "amin")
        win = (live & (_at(best, links.end_a) == r)
               & (_at(best, links.end_b) == r))
        for e, partner in ((links.end_a, links.end_b),
                           (links.end_b, links.end_a)):
            keep, row = drop_rows(torch.where(win, e, n_ends), n_ends)
            matched_end[row[keep]] = partner[keep]
        link_used = link_used | win
    # gap per matched end
    end_gap = torch.zeros((n_ends,), dtype=torch.float32, device=dev)
    for e in (links.end_a, links.end_b):
        keep, row = drop_rows(torch.where(link_used, e, n_ends), n_ends)
        end_gap[row[keep]] = links.gap[keep]
    return matched_end, end_gap


def form_scaffolds(matched_end, end_gap, alive, *, n_contigs: int,
                   max_members: int) -> Scaffolds:
    """Contract matched contig ends into oriented scaffold chains."""
    C, M = n_contigs, max_members
    dev = matched_end.device
    # oriented contig nodes: dir 0 = ->, exits end 1; dir 1 = <-, exits end 0
    cidx = torch.arange(C, dtype=torch.int64, device=dev)
    exit_end = torch.cat([cidx * 2 + 1, cidx * 2])           # dir0, dir1
    partner = matched_end[exit_end].to(torch.int64)           # [2C]
    alive2 = alive.repeat(2)
    has = (partner >= 0) & alive2
    p = partner.clamp(min=0)
    p_c, p_entry = p // 2, p & 1
    succ = torch.where(has & alive[p_c], p_c + p_entry * C, NONE)
    u = torch.arange(2 * C, dtype=torch.int64, device=dev)
    rc = (u + C) % (2 * C)
    succ_rc = succ[rc]
    pred = torch.where(succ_rc >= 0, (succ_rc + C) % (2 * C), NONE)
    chains = chain.form_chains(torch.where(alive2, pred, NONE))
    keep = alive2 & (chains.head <= chains.head[rc])
    is_head = keep & (chains.dist == 0)
    sid_of_head = torch.cumsum(is_head.to(torch.int64), 0) - 1
    n_scaffolds = (sid_of_head[-1] + 1 if bool(is_head.any())
                   else torch.zeros((), dtype=torch.int64, device=dev))
    sid_all = torch.where(is_head, sid_of_head, NONE)
    node_sid = torch.where(keep, sid_all[chains.head], NONE)
    S = C  # scaffold capacity = contig capacity
    contig_arr = torch.full((S, M), NONE, dtype=torch.int32, device=dev)
    orient_arr = torch.zeros((S, M), dtype=torch.uint8, device=dev)
    gap_arr = torch.zeros((S, M), dtype=torch.float32, device=dev)
    ok = keep & (node_sid >= 0) & (chains.dist < M)
    ok, row = drop_rows(torch.where(ok, node_sid, S), S)
    row, col = row[ok], chains.dist.clamp(0, M - 1)[ok].to(torch.int64)
    contig_arr[row, col] = (u % C)[ok].to(torch.int32)
    orient_arr[row, col] = (u // C)[ok].to(torch.uint8)
    # gap after member = gap recorded at its exit end
    gap_arr[row, col] = end_gap[exit_end][ok]
    n_members = torch.zeros((S,), dtype=torch.int32, device=dev)
    n_members.index_add_(0, row, torch.ones_like(row, dtype=torch.int32))
    return Scaffolds(contig=contig_arr, orient=orient_arr, gap=gap_arr,
                     n_members=n_members,
                     n_scaffolds=n_scaffolds.to(torch.int32))


def scaffold_from_links(links: Links, contigs: ContigSet, alive,
                        insert_size: float, *, max_members: int = 32,
                        hmm_hit=None):
    """Contig-scale half of Algorithm 3: suspension -> CC -> matching ->
    chain formation.  Returns (scaffolds, links, suspended, components)."""
    C = contigs.capacity
    n_ends = 2 * C
    links, suspended = suspend_repeats(links, contigs.lengths,
                                       float(insert_size), n_ends)
    if hmm_hit is None:
        hmm_hit = torch.zeros((C,), dtype=torch.bool, device=alive.device)
    alive_eff = alive & ~suspended
    # component labels (bound matching rounds, place components)
    comp = cc.connected_components(
        _half(links.end_a).clamp(min=0), _half(links.end_b).clamp(min=0),
        links.valid, C)
    matched_end, end_gap = greedy_matching(
        links, torch.where(alive_eff, contigs.lengths, 0), hmm_hit,
        n_ends=n_ends)
    scaffs = form_scaffolds(matched_end, end_gap, alive_eff, n_contigs=C,
                            max_members=max_members)
    return scaffs, links, suspended, comp


def scaffold(al, reads: ReadSet, contigs: ContigSet, alive, *,
             link_capacity: int = 1 << 12, min_support: int = 2,
             max_members: int = 32, hmm_hit=None):
    """Algorithm 3 minus gap closing (see gap_closing.py)."""
    links = build_links(al, reads, contigs, alive, capacity=link_capacity,
                        min_support=min_support)
    return scaffold_from_links(links, contigs, alive,
                               float(reads.insert_size),
                               max_members=max_members, hmm_hit=hmm_hit)
