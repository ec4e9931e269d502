"""Distributed pipeline stages (mirrors `repro.dist.stages`).

Each `shard_map` body of the reference is the same per-shard function
here.  The S shards spread over the W ranks of a `core.exchange.DataMesh`
(one process holding all S without a group): a rank calls it for each of
its shards s, the i-th, on row block i of its shard-major arrays.  The
reference's sharded inputs are sliced a shard, its replicated inputs are
shared (one copy a rank), `axis_index` is s and `psum` is a sum over the
rank's shards, then over the ranks (`DataMesh.sum`).  A stage with an
exchange runs in two halves, every local sender's bucketing, then the
all-to-all of `core.exchange.exchange`, then every local owner's reduce,
so each shard's arithmetic is the reference's own and the outputs are
the reference's bit for bit.  Where the reference's out_specs are
sharded and the consumer is replicated contig-scale code, the rank's
rows all_gather at the stage's end (`DataMesh.gather`).  Overflow
counters stay on the device; callers read them once a stage.

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
from .pipeline import ShardedReads, data_mesh_of, kmer_owner, shard_reads


def _pad_rows(x, rows: int, fill):
    pad = rows - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                    dtype=x.dtype, device=x.device)])


def _block(x, i: int, n: int):
    """Row block i of n of a shard-major array."""
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


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

    reads: ShardedReads of the rank's shards (or any ReadSet whose rows
      divide by S/W).
    prev_contigs: optional (ContigSet, alive) of the previous round
      (replicated); its k-mers enter the exchange as partials weighted by
      `contig_weight`, shard s taking row block s of the contig rows
      padded to a multiple of S.
    Returns (kset, route_overflow, table_overflow): kset with flat
    [S/W * capacity] arrays, the rank's i-th shard's owner table in rows
    [i*capacity, (i+1)*capacity); the overflows as device scalars summed
    over all shards.
    """
    m = data_mesh_of(mesh)
    S, n = m.num_shards, m.local_shards
    has_contigs = prev_contigs is not None
    if route_capacity is None:
        # contig-carrying rounds route two pre-combined tables a sender
        # (reads + §II-H pseudo-counts): lanes sized for both
        route_capacity = cap_lib.default_route_capacity(
            (2 if has_contigs else 1) * pre_capacity, S)
    assert reads.bases.shape[0] % n == 0, (
        f"reads rows {reads.bases.shape[0]} not divisible by {n}; "
        f"use shard_reads")
    if has_contigs:
        contigs, calive = prev_contigs
        c_pad = -(-contigs.capacity // S) * S
        cbases = _pad_rows(contigs.bases, c_pad, INVALID_BASE)
        clens = _pad_rows(torch.where(calive, contigs.lengths, 0), c_pad, 0)

    sends, local_ovf = [], []
    for i, s in enumerate(m.shards):
        pre = _occurrence_table(_block(reads.bases, i, n),
                                _block(reads.lengths, i, n), k=k,
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
    recv = exchange.exchange(sends, m)
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
    return kset, recv[0].overflow, m.sum(table_ovf)


# ---------------------------------------------------------------------------
# streaming ingest: sharded Bloom pass + running owner-partitioned fold
# ---------------------------------------------------------------------------


def _route_pre_tables(batch, m, *, k: int, pre_capacity: int,
                      route_capacity: int, keys: tuple, backend):
    """Every shard of the rank pre-combines its block of a batch (every
    rank holds the whole batch) and routes the `keys` columns of its
    table to their owners.  Returns (received RouteResults a local
    shard, the local pre tables)."""
    S, n = m.num_shards, m.local_shards
    reads = shard_reads(batch, S, m.shards)
    sends, pres = [], []
    for i, s in enumerate(m.shards):
        pre = _occurrence_table(_block(reads.bases, i, n),
                                _block(reads.lengths, i, n), k=k,
                                capacity=pre_capacity, backend=backend)
        sends.append(exchange.send(
            kmer_owner(pre["hi"], pre["lo"], S),
            tuple(pre[key] for key in keys), pre["count"] > 0,
            num_shards=S, capacity=route_capacity, src_shard=s))
        pres.append(pre)
    return exchange.exchange(sends, m), pres


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

    The filters are owner-partitioned ([S/W, bloom_bits] on a rank; its
    i-th row holds the bits of the keys its i-th shard owns): each shard
    pre-combines its block of the batch and routes (key, count) entries
    to the owners; an owner, after an exact cross-sender aggregate, marks
    in f2 the keys already in its f1 or arriving with a batch count >= 2,
    then inserts all of them into f1.  Returns (f1_bits, f2_bits,
    route_overflow, table_overflow).
    """
    m = data_mesh_of(mesh)
    S = m.num_shards
    if route_capacity is None:
        route_capacity = cap_lib.default_route_capacity(pre_capacity, S)
    recv_cap = S * route_capacity
    recv, pres = _route_pre_tables(
        batch, m, k=k, pre_capacity=pre_capacity,
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
    table_ovf = m.sum(torch.stack([p["overflow"].to(torch.int32)
                                   for p in pres]).sum())
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
    concatenation).  The running table is the rank's flat [S/W *
    capacity] owner layout of `sharded_kmer_analysis`.  Returns (run',
    (occ_total, occ_admitted), route_overflow, table_overflow), device
    scalars summed over all shards.
    """
    m = data_mesh_of(mesh)
    S, n = m.num_shards, m.local_shards
    if route_capacity is None:
        route_capacity = cap_lib.default_route_capacity(pre_capacity, S)
    recv, pres = _route_pre_tables(
        batch, m, k=k, pre_capacity=pre_capacity,
        route_capacity=route_capacity, keys=RUN_KEYS, backend=backend)
    occ_total = torch.stack([torch.where(p["count"] > 0, p["count"], 0)
                             .sum() for p in pres]).sum()
    table_ovf = torch.stack([p["overflow"].to(torch.int32)
                             for p in pres]).sum()
    del pres
    news, admitted_sum = [], []
    for i, res in enumerate(recv):
        rhi, rlo, rcnt, rl, rr = res.payload
        f2 = bloom.BloomFilter(bits=f2_bits[i], num_hashes=num_hashes)
        admitted = res.valid & bloom.query(f2, rhi, rlo)
        admitted_sum.append(torch.where(admitted, rcnt, 0).sum())
        mine = {key: _block(run[key], i, n) for key in RUN_KEYS}
        new = kmer_analysis.aggregate_weighted(
            torch.cat([mine["hi"], rhi]), torch.cat([mine["lo"], rlo]),
            torch.cat([mine["count"], rcnt]),
            torch.cat([mine["left_cnt"], rl]),
            torch.cat([mine["right_cnt"], rr]),
            torch.cat([mine["count"] > 0, admitted]), capacity=capacity)
        table_ovf = table_ovf + new["overflow"].to(torch.int32)
        news.append(new)
    new_run = {key: _cat(t[key] for t in news) for key in RUN_KEYS}
    occ_admitted = torch.stack(admitted_sum).sum()
    return (new_run, (m.sum(occ_total), m.sum(occ_admitted)),
            recv[0].overflow, m.sum(table_ovf))


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
    them; one copy a rank serves its shards here).  Output in the global
    shard-major layout, gathered over the ranks."""
    m = data_mesh_of(mesh)
    n = m.local_shards
    assert sharded.num_reads % n == 0
    insert_size = int(sharded.insert_size)
    parts = [alignment.align_reads(
        _local_reads(_block(sharded.bases, i, n),
                     _block(sharded.lengths, i, n), insert_size),
        contigs, sidx, seed_len=seed_len, stride=stride, gapped=gapped,
        backend=backend) for i in range(n)]
    return alignment.Alignments(*(m.gather(_cat(getattr(p, f) for p in parts))
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
    with dest < 0 stay home), with the `payload` columns.  `sharded`,
    `dest_contig` and the payload are the rows of the rank's shards, and
    so is what returns: (localized ShardedReads, routed payload tuple,
    overflow): overflow counts reads cut at the route lanes or the
    receiver block, over all shards.
    """
    m = data_mesh_of(mesh)
    S, n = m.num_shards, m.local_shards
    R = sharded.num_reads
    assert R % n == 0
    per = R // n
    out_per = out_factor * per
    route_cap = min(per, -(-2 * out_per // S))
    dest_contig = dest_contig.to(torch.int32)[:R]
    insert_size = int(sharded.insert_size)
    cols = (sharded.bases, sharded.lengths) + tuple(payload)
    sends = []
    for i, s in enumerate(m.shards):
        dc = _block(dest_contig, i, n)
        dest = torch.where(dc >= 0, dc % S, s).to(torch.int32)
        sends.append(exchange.send(
            dest, tuple(_block(c, i, n) for c in cols),
            _block(sharded.valid, i, n), num_shards=S, capacity=route_cap,
            src_shard=s))
    recv = exchange.exchange(sends, m)
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
    overflow = recv[0].overflow + m.sum(torch.stack(compact_ovf).sum())
    merged = [_cat(o[j] for o in outs) for j in range(len(cols))]
    dev = sharded.bases.device
    localized = ShardedReads(
        bases=merged[0], lengths=merged[1],
        mate=torch.full((n * out_per,), -1, dtype=torch.int32, device=dev),
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
    row comes from its owner's rank.  `sharded` holds the rank's shards'
    rows, `al` and the contigs are replicated.  Returns (ContigSet,
    overflow).
    """
    m = data_mesh_of(mesh)
    S, n = m.num_shards, m.local_shards
    C = contigs.capacity
    R = sharded.num_reads
    dev = contigs.bases.device
    first = m.shards.start * (R // n)  # global index of the rank's row 0
    aln0 = al.contig[:, 0].to(torch.int32)
    own = aln0[first:first + R]
    mate = torch.where(sharded.mate >= 0,
                       aln0[sharded.mate.clamp(min=0).to(torch.int64)],
                       local_assembly.NONE)
    # `local_assembly.localize_reads` on the rank's rows: the mates index
    # the replicated global alignments
    eff = torch.where(own >= 0, own, mate).to(torch.int32)
    localized, (eff_loc,), overflow = localize_with(
        sharded, eff, (eff,), m, out_factor=out_factor)
    insert_size = int(sharded.insert_size)
    owner = torch.arange(C, dtype=torch.int32, device=dev) % S
    bases, lengths = contigs.bases.clone(), contigs.lengths.clone()
    depths = contigs.depths.clone()
    for i, s in enumerate(m.shards):
        owned = owner == s
        ext, _walk = local_assembly.extend_contigs(
            _local_reads(_block(localized.bases, i, n),
                         _block(localized.lengths, i, n), insert_size),
            contigs, alive & owned, _block(eff_loc, i, n),
            mer_sizes=tuple(mer_sizes), capacity=capacity, max_ext=max_ext,
            backend=backend)
        bases[owned] = ext.bases[owned]
        lengths[owned] = ext.lengths[owned]
        depths[owned] = ext.depths[owned]
        del ext, _walk
    if m.group is not None:
        bases, lengths, depths = _from_owners(
            m, owner, (bases, lengths, depths))
    return ContigSet(bases=bases, lengths=lengths, depths=depths), overflow


def _from_owners(m, owner, cols):
    """Each contig row from the rank that owns it (its owner shard's
    rank): every rank's owned rows, padded to one count, all_gather in
    rank order and land in place on every rank."""
    rank_of = owner // m.local_shards
    rows = [torch.nonzero(rank_of == r).squeeze(1)
            for r in range(m.world_size)]
    width = max(len(r) for r in rows)
    out = []
    for x in cols:
        got = m.gather(_pad_rows(x[rows[m.rank]], width, 0)).reshape(
            (m.world_size, width) + tuple(x.shape[1:]))
        for r, idx in enumerate(rows):
            x[idx] = got[r, :len(idx)]
        out.append(x)
    return out


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
    `candidate_links` on its block; the flat witness arrays gather over
    the ranks into the global layout for `links_from_candidates`.
    `sharded` holds the rank's shards' rows, `al` is replicated.  Returns
    (candidates, overflow).
    """
    m = data_mesh_of(mesh)
    n = m.local_shards
    R = sharded.num_reads
    assert R % n == 0
    first = m.shards.start * (R // n)  # global index of the rank's row 0
    R_all = m.num_shards * (R // n)
    insert_size = int(sharded.insert_size)
    dev = sharded.bases.device
    aln = al.contig[:, :2].to(torch.int32)[:R_all]
    mate = sharded.mate.to(torch.int32)[:R]
    r = torch.arange(first, first + R, dtype=torch.int32, device=dev)
    # pair representative = lower index of the pair (self if unpaired)
    rep = torch.where(mate >= 0, torch.minimum(r, mate), r).to(torch.int64)
    other = torch.where(mate >= 0, torch.maximum(r, mate), r).to(torch.int64)
    a_rep = aln[:, 0][rep]
    a_other = aln[:, 0][other]
    # destination contig: the first aligned member of the pair; unaligned
    # pairs stay on the representative's home shard
    dest_c = torch.where(a_rep >= 0, a_rep, a_other)
    rows = slice(first, first + R)
    localized, routed, overflow = localize_with(
        sharded, dest_c,
        (r, mate, aln[rows], al.cstart[rows, :2].to(torch.int32),
         al.orient[rows, :2].to(torch.uint8)),
        m, out_factor=out_factor)
    clens = torch.where(alive, contigs.lengths, 0)
    parts = []
    for i in range(n):
        bases, lengths, rv = (_block(x, i, n) for x in (
            localized.bases, localized.lengths, localized.valid))
        g, mg, c2, s2, o2 = (_block(x, i, n) for x in routed)
        nb = g.shape[0]
        # rebuild mate pointers: local position of the carried global index
        inv = torch.full((R_all,), -1, dtype=torch.int32, device=dev)
        inv[g[rv].to(torch.int64)] = torch.arange(
            nb, dtype=torch.int32, device=dev)[rv]
        new_mate = torch.where(rv & (mg >= 0),
                               inv[mg.clamp(min=0).to(torch.int64)], -1)
        local = ReadSet(bases=bases, lengths=torch.where(rv, lengths, 0),
                        mate=new_mate.to(torch.int32),
                        insert_size=insert_size)
        al_loc = alignment.Alignments(
            contig=torch.where(rv[:, None], c2, -1), cstart=s2, orient=o2,
            matches=torch.zeros_like(c2), overlap=torch.zeros_like(c2))
        parts.append(candidate_links(al_loc, local, clens))
    cands = tuple(m.gather(_cat(p[j] for p in parts)) for j in range(5))
    return cands, overflow
