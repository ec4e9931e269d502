"""The slice end to end: port `contig_rounds` against JAX
`Assembler(plan, Local()).contig_rounds` (Algorithm 1).

Plan: `SMALL_PLAN`'s fields (tests/test_pipeline.py) with
`run_local_assembly=False`, so k = 17 then 21 and the §II-H contig
pseudo-counts of round 1 feed round 2.  Two fixtures: one genome at 25x,
and the two-genome community of tests/test_kernel_parity.py.  Tolerance:
exact everywhere — contig bases, lengths, alive, float32 depths (sums of
integers below 2**24), all five Alignments lanes, every IterationStats
field.  A stage-by-stage test feeds the reference's output of each stage
into the port's next stage (`repro_torch.bridge`), so a divergence shows
in the stage where it starts.
"""
import dataclasses

import numpy as np
import pytest

from repro.api import Assembler as JAssembler, AssemblyPlan as JPlan, \
    Local as JLocal
from repro.api.assembler import contig_stage as jcontig_stage
from repro.core.kmer_analysis import ExtensionPolicy as JPolicy
from repro.data import mgsim as jmgsim
from repro_torch import bridge
from repro_torch.api import Assembler, Local
from repro_torch.api.assembler import contig_stage
from repro_torch.core.alignment import Alignments
from repro_torch.core.types import ContigSet, KmerSet
from repro_torch.data import mgsim

JPLAN = JPlan(
    k_min=17, k_max=21, k_step=4,
    kmer_capacity=1 << 14, contig_cap=256, max_contig_len=2048,
    walk_capacity=1 << 15, link_capacity=1 << 10, max_scaffold_len=1 << 12,
    policy=JPolicy(err_rate=0.05), run_local_assembly=False,
)


def _plan():
    fields = dataclasses.asdict(JPLAN)
    fields["policy"] = tuple(JPLAN.policy)
    return bridge.plan_from_fields(fields)


def _single(m):
    return m.single_genome_reads(31, genome_len=700, coverage=25)[1]


def _community(m):
    comm = m.sample_community(41, num_genomes=2, genome_len=300,
                              abundance_sigma=0.3)
    return m.generate_reads(42, comm, num_pairs=300, read_len=60,
                            err_rate=0.003)[0]


FIXTURES = {"single_genome": _single, "community": _community}
_RUNS = {}


def _run(name):
    """(jax reads, port reads, jax result, port result), cached per name."""
    if name not in _RUNS:
        jreads, reads = FIXTURES[name](jmgsim), FIXTURES[name](mgsim)
        want = JAssembler(JPLAN, JLocal()).contig_rounds(jreads)
        got = Assembler(_plan(), Local(device="cpu")).contig_rounds(reads)
        _RUNS[name] = (jreads, reads, want, got)
    return _RUNS[name]


def _eq(got, want, what):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_port_mgsim_draws_the_reference_reads(name):
    jreads, reads, _, _ = _run(name)
    for f in ("bases", "lengths", "mate"):
        _eq(getattr(reads, f), getattr(jreads, f), f)
    assert reads.insert_size == jreads.insert_size


@pytest.mark.parametrize("name", list(FIXTURES))
def test_contigs_and_alive_match(name):
    _, _, (jc, jalive, _, _), (c, alive, _, _) = _run(name)
    for f in ContigSet._fields:
        _eq(getattr(c, f), getattr(jc, f), f)
    _eq(alive, jalive, "alive")
    assert int(alive.sum()) > 0


@pytest.mark.parametrize("name", list(FIXTURES))
def test_alignments_match(name):
    _, _, (_, _, jal, _), (_, _, al, _) = _run(name)
    for f in Alignments._fields:
        _eq(getattr(al, f), getattr(jal, f), f)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_iteration_stats_match(name):
    _, _, (_, _, _, jstats), (_, _, _, stats) = _run(name)
    assert [dataclasses.asdict(s) for s in stats] == \
        [dataclasses.asdict(s) for s in jstats]


def test_stage_by_stage_from_reference_inputs():
    """Each port stage on the reference's inputs equals the reference
    stage: k-mer analysis (round 1 and, with round-1 contigs, round 2),
    the contig stage (traversal, bubbles, pruning) and alignment."""
    jreads, reads, _, _ = _run("community")
    plan = _plan()
    jctx, ctx = JLocal(), Local(device="cpu")
    jctx.prepare(jreads, JPLAN)
    ctx.prepare(reads, plan)
    prev = jprev = None
    for k in JPLAN.ks():
        jkset, jovf = jctx.kmer_set(k, jprev)
        kset, ovf = ctx.kmer_set(k, prev)
        for f in KmerSet._fields:
            _eq(getattr(kset, f), getattr(jkset, f), f"k={k} kset.{f}")
        assert ovf == jovf
        jout = jcontig_stage(jkset, k, JPLAN)
        out = contig_stage(bridge.to_torch(jkset, KmerSet), k, plan)
        jcontigs, jalive, jtrav, jbub, jprn = jout
        contigs, alive, trav, bub, prn = out
        for f in ContigSet._fields:
            _eq(getattr(contigs, f), getattr(jcontigs, f), f"k={k} {f}")
        _eq(alive, jalive, f"k={k} alive")
        _eq(trav.node_contig, jtrav.node_contig, f"k={k} node_contig")
        _eq(trav.node_pos, jtrav.node_pos, f"k={k} node_pos")
        assert int(trav.n_contigs) == int(jtrav.n_contigs)
        assert bool(trav.overflow) == bool(jtrav.overflow)
        for f in bub._fields:
            _eq(getattr(bub, f), getattr(jbub, f), f"k={k} bubble.{f}")
        assert (prn.rounds, prn.pruned) == (int(jprn.rounds),
                                            int(jprn.pruned))
        jal = jctx.align(jcontigs, jalive, k)
        pc = bridge.to_torch(jcontigs, ContigSet)
        palive = bridge.tensor(np.asarray(jalive))
        al = ctx.align(pc, palive, k)
        for f in Alignments._fields:
            _eq(getattr(al, f), getattr(jal, f), f"k={k} align.{f}")
        jprev, prev = (jcontigs, jalive), (pc, palive)
