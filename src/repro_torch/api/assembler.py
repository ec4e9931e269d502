"""`Assembler`: the front door to the pipeline (mirrors
`repro.api.assembler`; Algorithm 1 only).

    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4),
                                     run_local_assembly=False)
    contigs, alive, al, stats = Assembler(plan, Local()).contig_rounds(reads)

Algorithm 1 (iterative contig generation): per k of the plan, k-mer
analysis with the previous round's contig k-mers as pseudo-counted
evidence (§II-H), dBG traversal, bubble merging and pruning, then read
alignment against the new contigs.  Local assembly (`extend`) and the
scaffolding of `assemble` need the mer_walk kernel and are not ported yet;
a plan asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bubble, dbg, kmer_analysis, pruning

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
        if plan.run_local_assembly:
            raise NotImplementedError(
                "run_local_assembly=True needs Local.extend and the "
                "mer_walk kernel, not ported yet (ROADMAP.md Queue 1); "
                "plan with run_local_assembly=False")
        kset, kovf = ctx.kmer_set(k, prev)
        contigs, alive, trav, bub, prn = contig_stage(kset, k, plan)
        al = ctx.align(contigs, alive, k)
        n_aligned = int((al.contig[:, 0] >= 0).sum())
        stats = IterationStats(
            k=k,
            n_kmers=int(kset.used.sum()),
            n_contigs=int(alive.sum()),
            n_bubbles=int(bub.merged_away.sum()),
            n_hair=int(bub.hair.sum()),
            n_pruned=int(prn.pruned),
            # float32 mean of a bool column, as the reference
            aligned_frac=float(np.float32(n_aligned)
                               / np.float32(al.contig.shape[0])),
            extended_bases=0,
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

    def assemble(self, reads, hmm_hit=None, *, hook=None) -> dict:
        raise NotImplementedError(
            "Assembler.assemble (local assembly, scaffolding, gap closing) "
            "needs the mer_walk kernel, not ported yet: ROADMAP.md Queue 1; "
            "contig_rounds runs Algorithm 1")
