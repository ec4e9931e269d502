"""The port's `dist.stages.sharded_extend` (§II-G local assembly after
read localization), held to its parts on the CPU at S = 2 and S = 3.

The reference's `sharded_extend` compiles its per-shard walk under
`shard_map` for ~140 s on a CPU, more than a test file's budget, so it
is not run in this file.  Each of its parts is held to the
reference elsewhere: `localize_with` in tests/test_torch_dist_stages.py,
`extend_contigs` in tests/test_torch_local_assembly.py.  This file holds
the composition: the stage equals, row for row,

  1. the mate projection (`local_assembly.localize_reads`) on the global
     shard-major layout,
  2. `localize_with` of the reads to their effective contig's owner,
  3. `extend_contigs` of shard s's localized block with the live contigs
     it owns (c % S == s),
  4. each contig's row taken from its owner's result,

composed here.  S = 3 does not divide the 800 reads (a padding row) and
owns the contigs unevenly.  At S = 1 the stage is the unsharded
`extend_contigs`.  Fixture and plan: tests/test_torch_dist_stages.py's,
with the port's own reads and round-1 contigs.  Tolerance: exact.
"""
import pytest
import torch

from repro_torch.api import AssemblyPlan, Mesh
from repro_torch.api.assembler import contig_stage
from repro_torch.core import local_assembly
from repro_torch.core.types import ContigSet, ReadSet
from repro_torch.data import mgsim
from repro_torch.dist import pipeline as dist, stages


@pytest.fixture(scope="module")
def fixture():
    comm = mgsim.sample_community(5, num_genomes=3, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                    err_rate=0.003)
    return reads


def _round_one(reads, S):
    """Round-1 contigs and their alignments, through the port's Mesh."""
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), num_shards=S,
                                     unique_rate=0.2, localize_out_factor=8)
    ctx = Mesh(S, device="cpu")
    ctx.prepare(reads, plan)
    kset, _ = ctx.kmer_set(17, None)
    contigs, alive, _, _, _ = contig_stage(kset, 17, plan)
    return plan, ctx, contigs, alive, ctx.align(contigs, alive, 17)


def _composed(sharded, contigs, alive, al, S, plan, k=17):
    """sharded_extend from its four parts."""
    R = sharded.num_reads
    aln0 = al.contig[:, 0][:R]
    eff = local_assembly.localize_reads(
        ReadSet(sharded.bases, sharded.lengths, sharded.mate,
                sharded.insert_size), aln0)
    localized, (eff_loc,), ovf = stages.localize_with(
        sharded, eff, (eff,), S, out_factor=plan.localize_out_factor)
    per = localized.num_reads // S
    C = contigs.capacity
    owner = torch.arange(C) % S
    rows = [None] * C
    for s in range(S):
        blk = slice(s * per, (s + 1) * per)
        ext, _ = local_assembly.extend_contigs(
            ReadSet(localized.bases[blk], localized.lengths[blk],
                    torch.full((per,), -1, dtype=torch.int32),
                    sharded.insert_size),
            contigs, alive & (owner == s), eff_loc[blk],
            mer_sizes=plan.ladder(k), capacity=plan.walk_capacity,
            max_ext=plan.max_ext)
        for c in range(C):
            if owner[c] == s:
                rows[c] = (ext.bases[c], ext.lengths[c], ext.depths[c])
    return ContigSet(*(torch.stack([r[i] for r in rows])
                       for i in range(3))), ovf


@pytest.mark.parametrize("S", [1, 2, 3])
def test_sharded_extend_equals_its_parts(fixture, S):
    plan, ctx, contigs, alive, al = _round_one(fixture, S)
    got, ovf = stages.sharded_extend(
        ctx.sharded, contigs, alive, al, S, mer_sizes=plan.ladder(17),
        capacity=plan.walk_capacity, max_ext=plan.max_ext,
        out_factor=plan.localize_out_factor)
    want, want_ovf = _composed(ctx.sharded, contigs, alive, al, S, plan)
    for f in ContigSet._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(ovf) == int(want_ovf) == 0
    grew = torch.where(alive, got.lengths - contigs.lengths, 0)
    assert int(grew.sum()) > 0
    assert ctx.sharded.num_reads % S == 0
    if S == 1:
        ext, _ = local_assembly.extend_contigs(
            fixture, contigs, alive, al.contig[:, 0],
            mer_sizes=plan.ladder(17), capacity=plan.walk_capacity,
            max_ext=plan.max_ext)
        for f in ContigSet._fields:
            assert torch.equal(getattr(got, f), getattr(ext, f)), f


def test_uneven_shards_pad_the_reads(fixture):
    sharded = dist.shard_reads(fixture, 3)
    assert sharded.num_reads == 801 and not bool(sharded.valid[-1])
