"""`Assembler`: the front door to the pipeline (mirrors
`repro.api.assembler`).

    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4))
    out = Assembler(plan, Local()).assemble(reads)
    plan8 = AssemblyPlan.from_dataset(reads, (17, 21, 4), num_shards=8)
    out = Assembler(plan8, Mesh(8)).assemble(reads)     # 8 shards
    contigs, alive, al, stats = Assembler(plan, Local()).contig_rounds(reads)
    splan = AssemblyPlan.from_stream(32768, 150, unique_kmers=500_000)
    out = Assembler(splan, Local()).assemble_stream(batch_source)

Algorithm 1 (iterative contig generation): per k of the plan, k-mer
analysis with the previous round's contig k-mers as pseudo-counted
evidence (§II-H), dBG traversal, bubble merging and pruning, read
alignment against the new contigs, and local assembly of the contig ends
(§II-G) when the plan asks for it.  `assemble` adds Algorithm 3: a fresh
alignment, link witnesses, scaffolding and gap closing (§III).
`assemble_stream` runs the same algorithms out of core, over a
re-iterable source of fixed-shape read batches (`repro_torch.stream`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bubble, dbg, gap_closing, kmer_analysis, \
    pruning, scaffolding

from .context import ExecutionContext, Local
from .plan import AssemblyPlan


@dataclasses.dataclass
class IterationStats:
    k: int
    n_kmers: int
    n_contigs: int
    n_bubbles: int
    n_hair: int
    n_pruned: int
    aligned_frac: float
    extended_bases: int
    overflow: bool
    route_overflow: int = 0


def extract_contig_kmers(contigs, alive, *, k: int, capacity: int,
                         weight: int, backend=None):
    """(k+s)-mer pseudo-count table from a contig set (§II-H)."""
    return kmer_analysis.pseudo_count_table(
        contigs.bases, torch.where(alive, contigs.lengths, 0),
        k=k, capacity=capacity, weight=weight, backend=backend,
    )


def contig_stage(kset, k: int, plan: AssemblyPlan):
    """dBG traversal -> bubbles -> pruning (contig scale)."""
    backend = plan.kernel_backend
    index = dbg.build_index(kset, backend=backend)
    trav = dbg.traverse(kset, index, k=k, contig_cap=plan.contig_cap,
                        max_len=plan.max_contig_len, backend=backend)
    contigs = trav.contigs
    ends = dbg.end_neighbor_forks(kset, index, trav, k=k,
                                  contig_cap=plan.contig_cap, backend=backend)
    bub = bubble.merge_bubbles(contigs.lengths, contigs.depths, ends, k=k)
    prn = pruning.prune(contigs.lengths, contigs.depths, ends, bub.alive,
                        k=k, num_kmers=plan.kmer_capacity,
                        alpha=plan.prune_alpha, beta=plan.prune_beta)
    return contigs, prn.alive, trav, bub, prn


#: Ordered stage labels of the staged-assembly event protocol: every event
#: the `*_iter` generators yield is `(stage, info)` with `stage` from here.
STAGES = ("analyze", "contig_rounds", "align", "scaffold")


def aligned_frac(n_aligned: int, n_reads: int) -> float:
    """The reference's float32 mean of the aligned-read column: XLA turns
    its division by the constant row count into a product with the
    float32 reciprocal, which can differ from a division by one ulp."""
    return float(np.float32(n_aligned) * (np.float32(1)
                                          / np.float32(n_reads)))


def _live_bases(contigs, alive) -> int:
    return int(torch.where(alive, contigs.lengths, 0).sum())


def drive(gen, hook=None):
    """Drain a staged generator; forward each (stage, info) event to
    `hook`, which may raise to abort at that boundary.  Returns the
    generator's return value."""
    while True:
        try:
            stage, info = next(gen)
        except StopIteration as stop:
            return stop.value
        if hook is not None:
            hook(stage, info)


class Assembler:
    """One entry point; execution strategy comes from the context."""

    def __init__(self, plan: AssemblyPlan,
                 ctx: Optional[ExecutionContext] = None):
        self.plan = plan
        self.ctx = ctx if ctx is not None else Local()

    def _round(self, k: int, prev):
        """One contig-generation iteration: (contigs, alive, al, stats)."""
        plan, ctx = self.plan, self.ctx
        kset, kovf = ctx.kmer_set(k, prev)
        contigs, alive, trav, bub, prn = contig_stage(kset, k, plan)
        al = ctx.align(contigs, alive, k)
        ext_bases = 0
        if plan.run_local_assembly:
            old_total = _live_bases(contigs, alive)
            contigs = ctx.extend(contigs, alive, al, k)
            ext_bases = _live_bases(contigs, alive) - old_total
        n_aligned = int((al.contig[:, 0] >= 0).sum())
        stats = IterationStats(
            k=k,
            n_kmers=int(kset.used.sum()),
            n_contigs=int(alive.sum()),
            n_bubbles=int(bub.merged_away.sum()),
            n_hair=int(bub.hair.sum()),
            n_pruned=int(prn.pruned),
            aligned_frac=aligned_frac(n_aligned, al.contig.shape[0]),
            extended_bases=ext_bases,
            overflow=bool(kovf.get("table")) or bool(trav.overflow),
            route_overflow=int(kovf.get("route", 0)),
        )
        return contigs, alive, al, stats

    def contig_rounds_iter(self, reads, *, prev=None):
        """Generator twin of `contig_rounds`: yields a ("contig_rounds",
        info) event after every k-round.  Returns (contigs, alive, al,
        stats)."""
        self.ctx.prepare(reads, self.plan)
        contigs = alive = al = None
        all_stats = []
        for k in self.plan.ks():
            contigs, alive, al, stats = self._round(k, prev)
            all_stats.append(stats)
            prev = (contigs, alive)
            yield "contig_rounds", {"k": k, "n_contigs": stats.n_contigs}
        return contigs, alive, al, all_stats

    def contig_rounds(self, reads, *, prev=None, hook=None):
        """Algorithm 1: iterate k over the plan's schedule."""
        return drive(self.contig_rounds_iter(reads, prev=prev), hook)

    # ---- Algorithm 1 + Algorithm 3 ----

    def assemble_iter(self, reads, hmm_hit=None):
        """Generator twin of `assemble`: yields (stage, info) events at
        every stage boundary (between contig rounds, after the final
        alignment, after scaffolding) and returns the result dict."""
        plan, ctx = self.plan, self.ctx
        contigs, alive, _, stats = yield from self.contig_rounds_iter(reads)
        # fresh alignment against the final contigs (Alg. 3 line 3)
        k_last = plan.ks()[-1]
        al = ctx.align(contigs, alive, k_last)
        yield "align", {"k": k_last}
        ea, eb, gap, valid, is_splint = ctx.link_candidates(al, contigs,
                                                           alive)
        links = scaffolding.links_from_candidates(
            ea, eb, gap, valid, is_splint, alive,
            capacity=plan.link_capacity, min_support=plan.min_link_support,
        )
        if hmm_hit is not None:
            hmm_hit = hmm_hit.to(alive.device)
        scaffs, links, suspended, comp = scaffolding.scaffold_from_links(
            links, contigs, alive, float(reads.insert_size),
            max_members=plan.max_members, hmm_hit=hmm_hit,
        )
        yield "scaffold", {"n_links": int(links.valid.sum())}
        # gap closing walks consume the whole read set
        dev_reads = reads.to(contigs.bases.device)
        seqs = gap_closing.close_and_render(
            scaffs, contigs, dev_reads, al.contig[:, 0][: reads.num_reads],
            seed_len=min(k_last, 25),
            mer_sizes=plan.ladder(k_last),
            walk_capacity=plan.walk_capacity,
            max_scaffold_len=plan.max_scaffold_len,
            backend=plan.kernel_backend,
        )
        return {
            "contigs": contigs,
            "alive": alive,
            "alignments": al,
            "scaffolds": scaffs,
            "scaffold_seqs": seqs,
            "links": links,
            "suspended": suspended,
            "components": comp,
            "stats": stats,
            "plan": plan,
            "overflow": ctx.overflow(),
        }

    def assemble(self, reads, hmm_hit=None, *, hook=None) -> dict:
        """Full pipeline (Algorithms 1 and 3): the reference's result dict
        (contigs, alive, alignments, scaffolds, scaffold_seqs, links,
        suspended, components, stats, plan, overflow).

        `hmm_hit`: optional [contig_cap] bool, contigs whose ends stay
        extendable under competing links (§III-C), as `core.hmm.hmm_hits`
        flags them.  `hook(stage, info)` runs at every
        stage boundary and may raise to abort there (see `drive`).
        """
        return drive(self.assemble_iter(reads, hmm_hit), hook)

    # ---- out-of-core execution ----

    def assemble_stream_iter(self, batches, hmm_hit=None, *,
                             checkpoint_dir: Optional[str] = None):
        """Generator twin of `assemble_stream`: yields (stage, info)
        events between streamed batches, after each per-k analysis and at
        every stage boundary; returns the result dict (see
        `repro_torch.stream.driver.iter_assemble_stream`)."""
        from repro_torch.stream import driver

        return driver.iter_assemble_stream(
            self.plan, self.ctx, batches, hmm_hit=hmm_hit,
            checkpoint_dir=checkpoint_dir)

    def assemble_stream(self, batches, hmm_hit=None, *,
                        checkpoint_dir: Optional[str] = None,
                        hook=None) -> dict:
        """Full pipeline over a re-iterable source of fixed-shape batches.

        The out-of-core twin of `assemble`: the same result dict plus
        per-k "stream_stats", with the read set never resident: k-mer
        analysis streams twice through the Bloom two-sighting rule, and
        the read-proportional stages take one batch at a time.  Size the
        plan with `AssemblyPlan.from_stream`, whose bill does not depend
        on the read count.  `checkpoint_dir` checkpoints the streamed
        analysis at batch boundaries and resumes from it; `hook` as in
        `assemble`.
        """
        return drive(self.assemble_stream_iter(
            batches, hmm_hit, checkpoint_dir=checkpoint_dir), hook)
