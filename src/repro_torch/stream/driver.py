"""Streamed Algorithm 1 + Algorithm 3: assemble from a batch source
(mirrors `repro.stream.driver`).

`Assembler.assemble_stream(batches)` lands here.  The loop is the
in-memory driver's, stage for stage (same k schedule, contig-scale graph
work and scaffolding), but every read-proportional stage consumes one
fixed-shape batch at a time, moved to the contigs' device for the time
it is processed:

  * k-mer analysis: two-pass Bloom admission and a running count table
    (`stream.analysis`), checkpointable at batch boundaries;
  * alignment: per batch against the seed index; the [R, 2] alignment
    rows gather on the host (the O(R) summary of the reads; the O(R*L)
    bases stay out of core) and the result keeps them there;
  * local assembly and gap closing: each batch's (contig, mer)
    occurrences fold into fixed-capacity walk tables, and the walks run
    once from the folded tables;
  * scaffolding: per-batch splint/span witnesses gather on the host and go
    to the device once, for one `links_from_candidates`.
"""
from __future__ import annotations

import torch

from repro_torch.core import alignment, gap_closing, local_assembly, \
    scaffolding

from .batches import check_batch_shapes


def _concat_alignments(parts):
    """Per-batch alignment rows (on the host) in the global layout."""
    return alignment.Alignments(*(
        torch.cat([getattr(p, f) for p in parts])
        for f in alignment.Alignments._fields))


def _align_and_tables(ctx, batches, contigs, sidx, seed_len, *,
                      wt=None, mer_sizes=None, tag_bits=None,
                      witnesses=None, clens=None, backend=None,
                      stage="align", info=None):
    """One pass over the batches: align each, optionally fold walk tables
    and link witnesses.  A generator: yields a `(stage, info)` event after
    every batch and returns (alignments, wt, witness arrays, counts)."""
    dev = contigs.bases.device
    parts = []
    wit = []
    aligned = 0
    valid_rows = 0
    for i, batch in enumerate(batches):
        batch = batch.to(dev)
        al_b = ctx.align_batch(batch, contigs, sidx, seed_len)
        aln0 = al_b.contig[:, 0]
        aligned += int((aln0 >= 0).sum())
        valid_rows += int((batch.lengths > 0).sum())
        if wt is not None:
            rc = local_assembly.localize_reads(batch, aln0)
            wt = local_assembly.accumulate_walk_tables(
                wt, batch, rc, mer_sizes=mer_sizes, tag_bits=tag_bits,
                backend=backend)
        if witnesses is not None:
            wit.append(tuple(w.cpu() for w in scaffolding.candidate_links(
                al_b, batch, clens)))
        parts.append(alignment.Alignments(*(x.cpu() for x in al_b)))
        del batch, al_b, aln0
        yield stage, {**(info or {}), "batch": i}
    al = _concat_alignments(parts)
    if witnesses is not None:
        wit = tuple(torch.cat([w[i] for w in wit]).to(dev) for i in range(5))
    return al, wt, wit, (aligned, valid_rows)


def assemble_stream(plan, ctx, batches, *, hmm_hit=None,
                    checkpoint_dir=None, hook=None) -> dict:
    """Full out-of-core pipeline over a re-iterable batch source."""
    from repro_torch.api.assembler import drive

    return drive(iter_assemble_stream(plan, ctx, batches, hmm_hit=hmm_hit,
                                      checkpoint_dir=checkpoint_dir), hook)


def _live_bases(contigs, alive) -> int:
    return int(torch.where(alive, contigs.lengths, 0).sum())


def iter_assemble_stream(plan, ctx, batches, *, hmm_hit=None,
                         checkpoint_dir=None):
    """Generator form of the out-of-core pipeline.

    Yields `(stage, info)` events (stage from `api.assembler.STAGES`)
    after each per-k streamed analysis ("analyze"), after every aligned
    batch and completed round ("contig_rounds"), after every batch of the
    final alignment pass ("align") and after link aggregation
    ("scaffold"); returns the result dict of `assemble` plus per-k
    "stream_stats".
    """
    from repro_torch.api.assembler import IterationStats, contig_stage
    from repro_torch.api.plan import PlanError

    if plan.min_count < 2:
        raise PlanError(
            f"assemble_stream requires min_count >= 2 (got "
            f"{plan.min_count}): the streamed path admits k-mers through "
            f"the two-sighting Bloom rule, which by construction drops "
            f"single-occurrence k-mers — with min_count=1 it would "
            f"silently diverge from the in-memory path; use assemble() "
            f"to keep singletons"
        )
    check_batch_shapes(batches)
    ctx.prepare_stream(plan, checkpoint_dir=checkpoint_dir)
    plan = ctx.plan  # a Mesh re-derives the per-shard capacities
    backend = plan.kernel_backend
    insert_size = None
    prev = None
    contigs = alive = None
    all_stats = []
    stream_stats = {}
    for k in plan.ks():
        kset, kovf, sstats = ctx.stream_kmer_set(k, batches, prev)
        stream_stats[k] = sstats
        yield "analyze", {"k": k, "batches": sstats.batches_pass2}
        contigs, alive, trav, bub, prn = contig_stage(kset, k, plan)
        n_kmers = int(kset.used.sum())
        del kset
        dev = contigs.bases.device
        seed_len = min(k, 27)
        sidx = alignment.build_seed_index(
            contigs, alive, seed_len=seed_len, capacity=plan.seed_cap,
            backend=backend)
        wt = None
        mer_sizes = tag_bits = None
        if plan.run_local_assembly:
            mer_sizes = plan.ladder(k)
            tag_bits = min(16, 62 - 2 * max(mer_sizes))
            wt = local_assembly.empty_walk_tables(
                mer_sizes=mer_sizes, capacity=plan.walk_capacity, device=dev)
        al, wt, _, (aligned, valid_rows) = yield from _align_and_tables(
            ctx, batches, contigs, sidx, seed_len,
            wt=wt, mer_sizes=mer_sizes, tag_bits=tag_bits, backend=backend,
            stage="contig_rounds", info={"k": k})
        del sidx
        if insert_size is None:
            for batch in batches:
                insert_size = int(batch.insert_size)
                break
        ext_bases = 0
        if plan.run_local_assembly:
            old_total = _live_bases(contigs, alive)
            contigs, _walk = local_assembly.extend_with_tables(
                wt, contigs, alive, mer_sizes=mer_sizes,
                max_ext=plan.max_ext, backend=backend)
            ext_bases = _live_bases(contigs, alive) - old_total
        del wt
        all_stats.append(IterationStats(
            k=k,
            n_kmers=n_kmers,
            n_contigs=int(alive.sum()),
            n_bubbles=int(bub.merged_away.sum()),
            n_hair=int(bub.hair.sum()),
            n_pruned=int(prn.pruned),
            # the reference's Python division (not the float32 mean of
            # the in-memory path): aligned over non-empty rows
            aligned_frac=aligned / max(valid_rows, 1),
            extended_bases=ext_bases,
            overflow=bool(kovf.get("table")) or bool(trav.overflow),
            route_overflow=int(kovf.get("route", 0)),
        ))
        prev = (contigs, alive)
        yield "contig_rounds", {"k": k, "n_contigs": int(alive.sum())}

    # ---- Algorithm 3 over the final contigs ----
    k_last = plan.ks()[-1]
    seed_len = min(k_last, 27)
    dev = contigs.bases.device
    sidx = alignment.build_seed_index(
        contigs, alive, seed_len=seed_len, capacity=plan.seed_cap,
        backend=backend)
    gap_mers = plan.ladder(k_last)
    gap_tag_bits = min(16, 62 - 2 * max(gap_mers))
    wt_gap = local_assembly.empty_walk_tables(
        mer_sizes=gap_mers, capacity=plan.walk_capacity, device=dev)
    clens = torch.where(alive, contigs.lengths, 0)
    al, wt_gap, cands, _ = yield from _align_and_tables(
        ctx, batches, contigs, sidx, seed_len,
        wt=wt_gap, mer_sizes=gap_mers, tag_bits=gap_tag_bits,
        witnesses=True, clens=clens, backend=backend,
        stage="align", info={"k": k_last})
    del sidx
    ea, eb, gap, valid, is_splint = cands
    links = scaffolding.links_from_candidates(
        ea, eb, gap, valid, is_splint, alive,
        capacity=plan.link_capacity, min_support=plan.min_link_support)
    del cands, ea, eb, gap, valid, is_splint
    if hmm_hit is not None:
        hmm_hit = hmm_hit.to(dev)
    scaffs, links, suspended, comp = scaffolding.scaffold_from_links(
        links, contigs, alive, float(insert_size),
        max_members=plan.max_members, hmm_hit=hmm_hit)
    yield "scaffold", {"n_links": int(links.valid.sum())}
    seqs = gap_closing.close_and_render_with_tables(
        scaffs, contigs, wt_gap, seed_len=min(k_last, 25),
        mer_sizes=gap_mers, max_scaffold_len=plan.max_scaffold_len,
        backend=backend)
    return {
        "contigs": contigs,
        "alive": alive,
        "alignments": al,
        "scaffolds": scaffs,
        "scaffold_seqs": seqs,
        "links": links,
        "suspended": suspended,
        "components": comp,
        "stats": all_stats,
        "stream_stats": stream_stats,
        "plan": plan,
        "overflow": ctx.overflow(),
    }
