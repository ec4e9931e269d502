"""Distributed pipeline stages (mirrors `repro.dist.stages`).

Each `shard_map` body of the reference is the same per-shard function
here, called for s in range(S) on row block s of the shard-major arrays:
the reference's sharded inputs are sliced a shard, its replicated inputs
are shared (one copy), `axis_index` is s and `psum` is a sum over the
shards.  A stage with an exchange runs in two halves, every sender's
bucketing, then the transpose of `core.exchange.exchange`, then every
owner's reduce, so each shard's arithmetic is the reference's own and the
outputs are the reference's bit for bit.  Overflow counters stay on the
device, summed over shards; callers read them once a stage.

  * `sharded_kmer_analysis`: Alg. 2 owner exchange, also carrying the
    previous round's contig k-mers (§II-H);
  * `sharded_bloom_observe` / `sharded_stream_fold`: the streamed
    two-sighting passes on owner-partitioned filters and running table;
  * `sharded_align`: each shard's read block against the one contig set
    and seed index;
  * `localize_with`: Fig. 3 localization carrying per-read payload;
  * `sharded_extend`: §II-G local assembly after localization, shard s
    walking the contig ends it owns (c mod S);
  * `sharded_link_candidates`: read pairs routed together to the owner of
    their first aligned contig, splint/span witnesses a shard.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import alignment, bloom, exchange, kmer_analysis, \
    local_assembly
from repro_torch.core.kmer_analysis import ExtensionPolicy
from repro_torch.core.scaffolding import candidate_links
from repro_torch.core.types import ContigSet, INVALID_BASE, KmerSet, ReadSet

from . import capacity as cap_lib
from .pipeline import ShardedReads, kmer_owner, mesh_shards, shard_reads


def _pad_rows(x, rows: int, fill):
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def _block(x, s: int, S: int):
    """Row block s of S of a shard-major array."""
    per = x.shape[0] // S
    return x[s * per:(s + 1) * per]


def _local_reads(bases, lengths, insert_size: int = 0) -> ReadSet:
    return ReadSet(bases=bases, lengths=lengths,
                   mate=torch.full(lengths.shape, -1, dtype=torch.int32,
                                   device=lengths.device),
                   insert_size=insert_size)


def _occurrence_table(bases, lengths, *, k: int, capacity: int, backend):
    """A shard's pre-combined count table of its read block."""
    hi, lo, left, right, valid = kmer_analysis.occurrences(
        _local_reads(bases, lengths), k=k, backend=backend)
    return kmer_analysis.count_occurrences(hi, lo, left, right, valid,
                                           capacity=capacity)


def _cat(parts):
    return torch.cat(list(parts))


# ---------------------------------------------------------------------------
# k-mer analysis with contig-kmer owner exchange (§II-A + §II-H)
# ---------------------------------------------------------------------------


def sharded_kmer_analysis(
    reads,
    mesh,
    *,
    k: int,
    pre_capacity: int,
    capacity: int,
    route_capacity: Optional[int] = None,
    min_count: int = 2,
    policy: ExtensionPolicy = ExtensionPolicy(),
    prev_contigs=None,
    contig_weight: int = 4,
    backend=None,
):
    """Alg. 2 with optional §II-H contig-kmer injection.

    reads: ShardedReads (or any ReadSet whose rows divide by S).
    prev_contigs: optional (ContigSet, alive) of the previous round; its
      k-mers enter the exchange as partials weighted by `contig_weight`,
      shard s taking row block s of the contig rows padded to a multiple
      of S.
    Returns (kset, route_overflow, table_overflow): kset with flat
    [S * capacity] arrays, shard s's owner table in rows [s*capacity,
    (s+1)*capacity); the overflows as device scalars summed over shards.
    """
    S = mesh_shards(mesh)
    has_contigs = prev_contigs is not None
    if route_capacity is None:
        # contig-carrying rounds route two pre-combined tables a sender
        # (reads + §II-H pseudo-counts): lanes sized for both
        route_capacity = cap_lib.default_route_capacity(
            (2 if has_contigs else 1) * pre_capacity, S)
    assert reads.bases.shape[0] % S == 0, (
        f"reads rows {reads.bases.shape[0]} not divisible by {S}; "
        f"use shard_reads")
    if has_contigs:
        contigs, calive = prev_contigs
        c_pad = -(-contigs.capacity // S) * S
        cbases = _pad_rows(contigs.bases, c_pad, INVALID_BASE)
        clens = _pad_rows(torch.where(calive, contigs.lengths, 0), c_pad, 0)

    sends, local_ovf = [], []
    for s in range(S):
        pre = _occurrence_table(_block(reads.bases, s, S),
                                _block(reads.lengths, s, S), k=k,
                                capacity=pre_capacity, backend=backend)
        streams = [pre]
        ovf = pre["overflow"].to(torch.int32)
        if has_contigs:
            ctab = kmer_analysis.pseudo_count_table(
                _block(cbases, s, S), _block(clens, s, S), k=k,
                capacity=pre_capacity, weight=contig_weight,
                backend=backend)
            streams.append(ctab)
            ovf = ovf + ctab["overflow"].to(torch.int32)
        cat = lambda key: _cat(t[key] for t in streams)
        phi, plo = cat("hi"), cat("lo")
        pcnt = cat("count")
        sends.append(exchange.send(
            kmer_owner(phi, plo, S),
            (phi, plo, pcnt, cat("left_cnt"), cat("right_cnt")), pcnt != 0,
            num_shards=S, capacity=route_capacity, src_shard=s))
        local_ovf.append(ovf)
        del streams, pre
    recv = exchange.exchange(sends)
    del sends
    ksets, table_ovf = [], torch.stack(local_ovf).sum()
    for res in recv:
        rhi, rlo, rcnt, rl, rr = res.payload
        tab = kmer_analysis.aggregate_weighted(rhi, rlo, rcnt, rl, rr,
                                               res.valid, capacity=capacity)
        table_ovf = table_ovf + tab["overflow"].to(torch.int32)
        ksets.append(kmer_analysis.finalize(tab, min_count=min_count,
                                            policy=policy))
    kset = KmerSet(*(_cat(getattr(ks, f) for ks in ksets)
                     for f in KmerSet._fields))
    return kset, recv[0].overflow, table_ovf


# ---------------------------------------------------------------------------
# streaming ingest: sharded Bloom pass + running owner-partitioned fold
# ---------------------------------------------------------------------------


def _route_pre_tables(reads, S: int, *, k: int, pre_capacity: int,
                      route_capacity: int, keys: tuple, backend):
    """Every shard pre-combines its block of a batch and routes the
    `keys` columns of its table to their owners.  Returns (received
    RouteResults a shard, the pre tables)."""
    sends, pres = [], []
    for s in range(S):
        pre = _occurrence_table(_block(reads.bases, s, S),
                                _block(reads.lengths, s, S), k=k,
                                capacity=pre_capacity, backend=backend)
        sends.append(exchange.send(
            kmer_owner(pre["hi"], pre["lo"], S),
            tuple(pre[key] for key in keys), pre["count"] > 0,
            num_shards=S, capacity=route_capacity, src_shard=s))
        pres.append(pre)
    return exchange.exchange(sends), pres


def sharded_bloom_observe(
    batch,
    mesh,
    f1_bits,
    f2_bits,
    *,
    k: int,
    pre_capacity: int,
    route_capacity: Optional[int] = None,
    num_hashes: int = 3,
    backend=None,
):
    """Pass 1 of the streamed two-sighting rule for one batch.

    The filters are owner-partitioned ([S, bloom_bits]; shard s holds the
    bits of the keys it owns): each shard pre-combines its block of the
    batch and routes (key, count) entries to the owners; an owner, after
    an exact cross-sender aggregate, marks in f2 the keys already in its
    f1 or arriving with a batch count >= 2, then inserts all of them into
    f1.  Returns (f1_bits, f2_bits, route_overflow, table_overflow).
    """
    S = mesh_shards(mesh)
    reads = shard_reads(batch, S)
    if route_capacity is None:
        route_capacity = cap_lib.default_route_capacity(pre_capacity, S)
    recv_cap = S * route_capacity
    recv, pres = _route_pre_tables(
        reads, S, k=k, pre_capacity=pre_capacity,
        route_capacity=route_capacity, keys=("hi", "lo", "count"),
        backend=backend)
    f1_out, f2_out = [], []
    for s, res in enumerate(recv):
        rhi, rlo, rcnt = res.payload
        # exact cross-sender dedupe: a key split over senders arrives as
        # several rows; their sum makes "count >= 2 in this batch" a
        # per-key truth before it touches the (lossy) filter
        zeros4 = torch.zeros((rhi.shape[0], 4), dtype=torch.int32,
                             device=rhi.device)
        agg = kmer_analysis.aggregate_weighted(
            rhi, rlo, rcnt, zeros4, zeros4, res.valid, capacity=recv_cap)
        keys_ok = agg["count"] > 0
        f1 = bloom.BloomFilter(bits=f1_bits[s], num_hashes=num_hashes)
        f2 = bloom.BloomFilter(bits=f2_bits[s], num_hashes=num_hashes)
        seen = bloom.query(f1, agg["hi"], agg["lo"]) | (agg["count"] >= 2)
        f2_out.append(bloom.insert(f2, agg["hi"], agg["lo"],
                                   keys_ok & seen).bits)
        f1_out.append(bloom.insert(f1, agg["hi"], agg["lo"], keys_ok).bits)
    table_ovf = torch.stack([p["overflow"].to(torch.int32)
                             for p in pres]).sum()
    return (torch.stack(f1_out), torch.stack(f2_out), recv[0].overflow,
            table_ovf)


RUN_KEYS = ("hi", "lo", "count", "left_cnt", "right_cnt")


def sharded_stream_fold(
    batch,
    mesh,
    f2_bits,
    run: dict,
    *,
    k: int,
    capacity: int,
    pre_capacity: int,
    route_capacity: Optional[int] = None,
    num_hashes: int = 3,
    backend=None,
):
    """Pass 2 for one batch: admit at the owner, fold into its slice of
    the running table.

    Each shard pre-combines its block (counts and extension histograms)
    and routes entries to their owners; an owner admits only keys its f2
    has seen twice and segment-reduces the admitted partials into its
    slice of the running table (`aggregate_weighted` over the
    concatenation).  The running table is the flat [S * capacity] owner
    layout of `sharded_kmer_analysis`.  Returns (run', (occ_total,
    occ_admitted), route_overflow, table_overflow), device scalars.
    """
    S = mesh_shards(mesh)
    reads = shard_reads(batch, S)
    if route_capacity is None:
        route_capacity = cap_lib.default_route_capacity(pre_capacity, S)
    recv, pres = _route_pre_tables(
        reads, S, k=k, pre_capacity=pre_capacity,
        route_capacity=route_capacity, keys=RUN_KEYS, backend=backend)
    occ_total = torch.stack([torch.where(p["count"] > 0, p["count"], 0)
                             .sum() for p in pres]).sum()
    table_ovf = torch.stack([p["overflow"].to(torch.int32)
                             for p in pres]).sum()
    del pres
    news, admitted_sum = [], []
    for s, res in enumerate(recv):
        rhi, rlo, rcnt, rl, rr = res.payload
        f2 = bloom.BloomFilter(bits=f2_bits[s], num_hashes=num_hashes)
        admitted = res.valid & bloom.query(f2, rhi, rlo)
        admitted_sum.append(torch.where(admitted, rcnt, 0).sum())
        mine = {key: _block(run[key], s, S) for key in RUN_KEYS}
        new = kmer_analysis.aggregate_weighted(
            torch.cat([mine["hi"], rhi]), torch.cat([mine["lo"], rlo]),
            torch.cat([mine["count"], rcnt]),
            torch.cat([mine["left_cnt"], rl]),
            torch.cat([mine["right_cnt"], rr]),
            torch.cat([mine["count"] > 0, admitted]), capacity=capacity)
        table_ovf = table_ovf + new["overflow"].to(torch.int32)
        news.append(new)
    new_run = {key: _cat(n[key] for n in news) for key in RUN_KEYS}
    occ_admitted = torch.stack(admitted_sum).sum()
    return new_run, (occ_total, occ_admitted), recv[0].overflow, table_ovf


# ---------------------------------------------------------------------------
# per-shard alignment against the one contig set
# ---------------------------------------------------------------------------


def sharded_align(
    sharded: ShardedReads,
    contigs: ContigSet,
    sidx: alignment.SeedIndex,
    mesh,
    *,
    seed_len: int,
    stride: int = 16,
    gapped: bool = False,
    backend=None,
):
    """Align every read to the live contigs, one shard a read block,
    against the one contig set and seed index (the reference replicates
    them; one copy serves every shard here).  Output in the global
    shard-major layout."""
    S = mesh_shards(mesh)
    assert sharded.num_reads % S == 0
    insert_size = int(sharded.insert_size)
    parts = [alignment.align_reads(
        _local_reads(_block(sharded.bases, s, S),
                     _block(sharded.lengths, s, S), insert_size),
        contigs, sidx, seed_len=seed_len, stride=stride, gapped=gapped,
        backend=backend) for s in range(S)]
    return alignment.Alignments(*(_cat(getattr(p, f) for p in parts)
                                  for f in alignment.Alignments._fields))


# ---------------------------------------------------------------------------
# read localization carrying payload (§II-I)
# ---------------------------------------------------------------------------


def localize_with(
    sharded: ShardedReads,
    dest_contig,
    payload: tuple,
    mesh,
    *,
    out_factor: int = 2,
):
    """Fig. 3 localization that carries per-read payload to the new shard.

    Each read routes to the shard owning `dest_contig[r]` (c mod S; rows
    with dest < 0 stay home), with the `payload` columns.  Returns
    (localized ShardedReads, routed payload tuple, overflow): overflow
    counts reads cut at the route lanes or the receiver block.
    """
    S = mesh_shards(mesh)
    R = sharded.num_reads
    assert R % S == 0
    per = R // S
    out_per = out_factor * per
    route_cap = min(per, -(-2 * out_per // S))
    dest_contig = dest_contig.to(torch.int32)[:R]
    insert_size = int(sharded.insert_size)
    cols = (sharded.bases, sharded.lengths) + tuple(payload)
    sends = []
    for s in range(S):
        dc = _block(dest_contig, s, S)
        dest = torch.where(dc >= 0, dc % S, s).to(torch.int32)
        sends.append(exchange.send(
            dest, tuple(_block(c, s, S) for c in cols),
            _block(sharded.valid, s, S), num_shards=S, capacity=route_cap,
            src_shard=s))
    recv = exchange.exchange(sends)
    del sends
    outs, valids, compact_ovf = [], [], []
    for res in recv:
        routed, rv, ovf = exchange.compact(res.payload, res.valid,
                                           capacity=out_per)
        rb = torch.where(rv[:, None], routed[0], INVALID_BASE).to(
            torch.uint8)
        outs.append((rb,) + tuple(routed[1:]))
        valids.append(rv)
        compact_ovf.append(ovf)
    overflow = recv[0].overflow + torch.stack(compact_ovf).sum()
    merged = [_cat(o[i] for o in outs) for i in range(len(cols))]
    dev = sharded.bases.device
    localized = ShardedReads(
        bases=merged[0], lengths=merged[1],
        mate=torch.full((S * out_per,), -1, dtype=torch.int32, device=dev),
        insert_size=insert_size, valid=_cat(valids))
    return localized, tuple(merged[2:]), overflow


# ---------------------------------------------------------------------------
# per-shard local assembly of owned contigs (§II-G)
# ---------------------------------------------------------------------------


def sharded_extend(
    sharded: ShardedReads,
    contigs: ContigSet,
    alive,
    al,
    mesh,
    *,
    mer_sizes: tuple,
    capacity: int,
    max_ext: int = 64,
    out_factor: int = 2,
    backend=None,
):
    """Localize reads to their contig's owner, mer-walk owned contig ends.

    Contig c is owned by shard c mod S.  A read's effective contig is its
    own best hit, else its mate's (the §II-G mate projection, computed on
    the global layout before localization so mate evidence survives the
    move).  Shard s builds (contig, mer) walk tables from its localized
    block only and extends only the live contigs it owns; each contig's
    row comes from its owner.  Returns (ContigSet, overflow).
    """
    S = mesh_shards(mesh)
    C = contigs.capacity
    R = sharded.num_reads
    dev = contigs.bases.device
    aln0 = al.contig[:, 0].to(torch.int32)[:R]
    global_reads = ReadSet(bases=sharded.bases, lengths=sharded.lengths,
                           mate=sharded.mate,
                           insert_size=sharded.insert_size)
    eff = local_assembly.localize_reads(global_reads, aln0)
    localized, (eff_loc,), overflow = localize_with(
        sharded, eff, (eff,), S, out_factor=out_factor)
    insert_size = int(sharded.insert_size)
    owner = torch.arange(C, dtype=torch.int32, device=dev) % S
    bases, lengths = contigs.bases.clone(), contigs.lengths.clone()
    depths = contigs.depths.clone()
    for s in range(S):
        owned = owner == s
        ext, _walk = local_assembly.extend_contigs(
            _local_reads(_block(localized.bases, s, S),
                         _block(localized.lengths, s, S), insert_size),
            contigs, alive & owned, _block(eff_loc, s, S),
            mer_sizes=tuple(mer_sizes), capacity=capacity, max_ext=max_ext,
            backend=backend)
        bases[owned] = ext.bases[owned]
        lengths[owned] = ext.lengths[owned]
        depths[owned] = ext.depths[owned]
        del ext, _walk
    return ContigSet(bases=bases, lengths=lengths, depths=depths), overflow


# ---------------------------------------------------------------------------
# post-localization per-shard scaffolding witnesses (§III-B)
# ---------------------------------------------------------------------------


def sharded_link_candidates(
    sharded: ShardedReads,
    al,
    contigs: ContigSet,
    alive,
    mesh,
    *,
    out_factor: int = 2,
):
    """Per-shard splint/span witnesses over pair-atomically localized
    reads.

    Read pairs route together to the owner of their first aligned contig,
    carrying both alignment rows and their global indices; mate pointers
    are rebuilt on arrival from the carried indices (a dropped mate
    invalidates the pair, counted in the overflow).  Each shard runs
    `candidate_links` on its block; the flat witness arrays are in the
    global layout for `links_from_candidates`.  Returns (candidates,
    overflow).
    """
    S = mesh_shards(mesh)
    R = sharded.num_reads
    assert R % S == 0
    insert_size = int(sharded.insert_size)
    dev = sharded.bases.device
    aln = al.contig[:, :2].to(torch.int32)[:R]
    mate = sharded.mate.to(torch.int32)[:R]
    r = torch.arange(R, dtype=torch.int32, device=dev)
    # pair representative = lower index of the pair (self if unpaired)
    rep = torch.where(mate >= 0, torch.minimum(r, mate), r).to(torch.int64)
    other = torch.where(mate >= 0, torch.maximum(r, mate), r).to(torch.int64)
    a_rep = aln[:, 0][rep]
    a_other = aln[:, 0][other]
    # destination contig: the first aligned member of the pair; unaligned
    # pairs stay on the representative's home shard
    dest_c = torch.where(a_rep >= 0, a_rep, a_other)
    localized, routed, overflow = localize_with(
        sharded, dest_c,
        (r, mate, aln, al.cstart[:, :2].to(torch.int32)[:R],
         al.orient[:, :2].to(torch.uint8)[:R]),
        S, out_factor=out_factor)
    clens = torch.where(alive, contigs.lengths, 0)
    parts = []
    for s in range(S):
        bases, lengths, rv = (_block(x, s, S) for x in (
            localized.bases, localized.lengths, localized.valid))
        g, mg, c2, s2, o2 = (_block(x, s, S) for x in routed)
        n = g.shape[0]
        # rebuild mate pointers: local position of the carried global index
        inv = torch.full((R,), -1, dtype=torch.int32, device=dev)
        inv[g[rv].to(torch.int64)] = torch.arange(
            n, dtype=torch.int32, device=dev)[rv]
        new_mate = torch.where(rv & (mg >= 0),
                               inv[mg.clamp(min=0).to(torch.int64)], -1)
        local = ReadSet(bases=bases, lengths=torch.where(rv, lengths, 0),
                        mate=new_mate.to(torch.int32),
                        insert_size=insert_size)
        al_loc = alignment.Alignments(
            contig=torch.where(rv[:, None], c2, -1), cstart=s2, orient=o2,
            matches=torch.zeros_like(c2), overlap=torch.zeros_like(c2))
        parts.append(candidate_links(al_loc, local, clens))
    cands = tuple(_cat(p[i] for p in parts) for i in range(5))
    return cands, overflow
