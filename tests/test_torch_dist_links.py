"""The port's `dist.stages.sharded_link_candidates` against the
reference's at S = 2: read pairs localized together to the owner of
their first aligned contig, mate pointers rebuilt from the carried
global indices, splint/span witnesses a shard.

Fixture and plan: tests/test_torch_dist_stages.py's; the contigs are the
reference's first-round contigs and the alignments its `sharded_align`
against them, both taken as they are by the port (`bridge`).  The
reference's link stage alone takes ~45 s to compile on a CPU, so it has a
file of its own.  Tolerance: exact, every witness array and the
overflow count.
"""
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import scaffolding
from repro_torch.core.alignment import Alignments
from repro_torch.core.types import ContigSet, ReadSet
from repro_torch.dist import pipeline as dist, stages
from test_torch_dist_stages import FIXTURE
from test_torch_exchange import eq, run_reference

S = 2

_BODY = FIXTURE.format(S=S) + """
from repro.api.assembler import contig_stage
from repro.core import alignment, kmer_analysis
from repro.dist import stages

k1 = stages.sharded_kmer_analysis(
    sharded, mesh, k=17, pre_capacity=plan.pre_cap,
    capacity=plan.shard_table_cap, route_capacity=plan.route_capacity,
    min_count=plan.min_count, policy=plan.policy)
kset = kmer_analysis.finalize(
    dist.gather_ksets(k1[0], capacity=plan.kmer_capacity),
    min_count=plan.min_count, policy=plan.policy)
contigs, alive, _, _, _ = contig_stage(kset, 17, plan)
put("contigs", contigs)
put("alive", alive)
sidx = alignment.build_seed_index(contigs, alive, seed_len=21,
                                  capacity=plan.seed_cap)
al = stages.sharded_align(sharded, contigs, sidx, mesh, seed_len=21,
                          stride=plan.seed_stride)
put("al", al)
put("links", stages.sharded_link_candidates(
    sharded, al, contigs, alive, mesh,
    out_factor=plan.localize_out_factor))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_BODY, tmp_path_factory.mktemp("x") / "ref.npz",
                         ndev=S)


@pytest.fixture(scope="module")
def got(ref):
    plan = bridge.plan_from_fields(ref.json("plan"))
    reads = ReadSet(ref.tensor("reads.bases"), ref.tensor("reads.lengths"),
                    ref.tensor("reads.mate"), int(ref["reads.insert_size"]))
    sharded = dist.shard_reads(reads, S)
    contigs = ref.record("contigs", ContigSet)
    alive = ref.tensor("alive")
    al = ref.record("al", Alignments)
    return stages.sharded_link_candidates(
        sharded, al, contigs, alive, S,
        out_factor=plan.localize_out_factor), (reads, contigs, alive, al)


@pytest.mark.parametrize("i,name", list(enumerate(
    ("end_a", "end_b", "gap", "valid", "is_splint"))))
def test_link_witnesses_match(ref, got, i, name):
    (cands, _), _ = got
    eq(cands[i], ref[f"links.0.{i}"], name)


def test_overflow_and_links_match_the_unsharded_witnesses(ref, got):
    """Overflow 0 (out factor 8), and the links aggregated from the
    sharded witnesses equal those of the unsharded `candidate_links` on
    the original reads: localization moves pairs together."""
    (cands, overflow), (reads, contigs, alive, al) = got
    assert int(overflow) == int(ref["links.1"]) == 0
    clens = torch.where(alive, contigs.lengths, 0)
    flat = scaffolding.candidate_links(
        Alignments(*(x[:reads.num_reads] for x in al)), reads, clens)
    a = scaffolding.links_from_candidates(*cands, alive, capacity=1 << 10)
    b = scaffolding.links_from_candidates(*flat, alive, capacity=1 << 10)
    assert int(a.valid.sum()) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
