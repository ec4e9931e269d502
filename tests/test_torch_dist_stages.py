"""The port's sharded stages (`dist.stages`, `dist.pipeline`) against
the reference's at S = 2.

Fixture: the 3-genome community of tests/test_distributed.py's Mesh
tests (`sample_community(5, num_genomes=3, genome_len=300)`, 400 pairs of
60 bp) and its plan, `from_dataset(..., num_shards=2, unique_rate=0.2,
localize_out_factor=8)`.  The reference runs once on 2 host devices in a
subprocess (`test_torch_exchange.run_reference`); each port stage takes
the same inputs (the reference's reads, its round-1 contigs) on the CPU.
Stages: `sharded_kmer_analysis` without and with the previous round's
contigs and `gather_ksets`; `sharded_align`; `localize_with`, once to the
aligned contigs' owners and once with every read sent to shard 0 and an
out factor of 1, so the receiver block overflows.  The streamed stages
are in tests/test_torch_dist_stream.py, `sharded_link_candidates` in
tests/test_torch_dist_links.py.  Tolerance: exact everywhere, overflow
counts included.
"""
import pytest
import torch

from repro_torch import bridge
from repro_torch.core import alignment
from repro_torch.core.types import ContigSet, ReadSet
from repro_torch.dist import pipeline as dist, stages
from test_torch_exchange import eq, eq_record, run_reference

S = 2

# the reference's fixture and plan, shared by the distributed test files
FIXTURE = """
import dataclasses
from repro.api import AssemblyPlan
from repro.data import mgsim
from repro.dist import pipeline as dist
comm = mgsim.sample_community(5, num_genomes=3, genome_len=300,
                              abundance_sigma=0.3)
reads, _ = mgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                err_rate=0.003)
plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), num_shards={S},
                                 unique_rate=0.2, localize_out_factor=8)
fields = dataclasses.asdict(plan)
fields["policy"] = tuple(plan.policy)
put_json("plan", fields)
put("reads", reads)
mesh = dist.data_mesh({S})
sharded = dist.shard_reads(reads, {S})
"""

_BODY = FIXTURE.format(S=S) + """
from repro.api.assembler import contig_stage
from repro.core import alignment, kmer_analysis
from repro.dist import stages

kw = dict(pre_capacity=plan.pre_cap, capacity=plan.shard_table_cap,
          route_capacity=plan.route_capacity, min_count=plan.min_count,
          policy=plan.policy)
k1 = stages.sharded_kmer_analysis(sharded, mesh, k=17, **kw)
put("k17", k1)
g1 = dist.gather_ksets(k1[0], capacity=plan.kmer_capacity)
put("g17", g1)
kset = kmer_analysis.finalize(g1, min_count=plan.min_count,
                              policy=plan.policy)
contigs, alive, _, _, _ = contig_stage(kset, 17, plan)
put("contigs", contigs)
put("alive", alive)
k2 = stages.sharded_kmer_analysis(
    sharded, mesh, k=21, prev_contigs=(contigs, alive),
    contig_weight=plan.contig_pseudo_weight, **kw)
put("k21", k2)
put("g21", dist.gather_ksets(k2[0], capacity=plan.kmer_capacity))
sidx = alignment.build_seed_index(contigs, alive, seed_len=21,
                                  capacity=plan.seed_cap)
al = stages.sharded_align(sharded, contigs, sidx, mesh, seed_len=21,
                          stride=plan.seed_stride)
put("al", al)
R = sharded.num_reads
put("loc", stages.localize_with(
    sharded, al.contig[:, 0], (jnp.arange(R, dtype=jnp.int32), al.contig),
    mesh, out_factor=plan.localize_out_factor))
put("skew", stages.localize_with(
    sharded, jnp.zeros((R,), jnp.int32), (jnp.arange(R, dtype=jnp.int32),),
    mesh, out_factor=1))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_BODY, tmp_path_factory.mktemp("x") / "ref.npz",
                         ndev=S)


@pytest.fixture(scope="module")
def port(ref):
    """The port's plan, reads (the reference's), round-1 contigs."""
    plan = bridge.plan_from_fields(ref.json("plan"))
    reads = ReadSet(ref.tensor("reads.bases"), ref.tensor("reads.lengths"),
                    ref.tensor("reads.mate"), int(ref["reads.insert_size"]))
    contigs = ref.record("contigs", ContigSet)
    return plan, reads, dist.shard_reads(reads, S), contigs, \
        ref.tensor("alive")


def _kw(plan):
    return dict(pre_capacity=plan.pre_cap, capacity=plan.shard_table_cap,
                route_capacity=plan.route_capacity,
                min_count=plan.min_count, policy=plan.policy)


def _eq_kmer_stage(got, ref, name):
    kset, route_ovf, table_ovf = got
    eq_record(kset, ref, f"{name}.0")
    assert int(route_ovf) == int(ref[f"{name}.1"])
    assert int(table_ovf) == int(ref[f"{name}.2"])


def _eq_table(got, ref, name):
    for key, v in got.items():
        eq(v, ref[f"{name}.{key}"], f"{name}.{key}")


def test_sharded_kmer_analysis_and_gather(ref, port):
    plan, reads, sharded, _, _ = port
    got = stages.sharded_kmer_analysis(sharded, S, k=17, **_kw(plan))
    _eq_kmer_stage(got, ref, "k17")
    assert int(got[0].used.sum()) > 0
    _eq_table(dist.gather_ksets(got[0], capacity=plan.kmer_capacity), ref,
              "g17")
    # the unsharded entry point pads and runs the same stage
    again = dist.distributed_kmer_analysis(reads, S, k=17, **_kw(plan))
    for a, b in zip(again[0], got[0]):
        assert torch.equal(a, b)


def test_sharded_kmer_analysis_with_previous_contigs(ref, port):
    plan, _, sharded, contigs, alive = port
    got = stages.sharded_kmer_analysis(
        sharded, S, k=21, prev_contigs=(contigs, alive),
        contig_weight=plan.contig_pseudo_weight, **_kw(plan))
    _eq_kmer_stage(got, ref, "k21")
    _eq_table(dist.gather_ksets(got[0], capacity=plan.kmer_capacity), ref,
              "g21")


def test_sharded_align(ref, port):
    plan, _, sharded, contigs, alive = port
    sidx = alignment.build_seed_index(contigs, alive, seed_len=21,
                                      capacity=plan.seed_cap)
    al = stages.sharded_align(sharded, contigs, sidx, S, seed_len=21,
                              stride=plan.seed_stride)
    eq_record(al, ref, "al")
    assert int((al.contig[:, 0] >= 0).sum()) > 0


def _eq_localized(got, ref, name):
    localized, payload, overflow = got
    eq_record(localized, ref, f"{name}.0")
    for i, p in enumerate(payload):
        eq(p, ref[f"{name}.1.{i}"], f"{name} payload {i}")
    assert int(overflow) == int(ref[f"{name}.2"])


def test_localize_with_to_aligned_owners(ref, port):
    plan, _, sharded, _, _ = port
    al_contig = ref.tensor("al.contig")
    R = sharded.num_reads
    got = stages.localize_with(
        sharded, al_contig[:, 0], (torch.arange(R, dtype=torch.int32),
                                   al_contig), S,
        out_factor=plan.localize_out_factor)
    _eq_localized(got, ref, "loc")
    assert int(got[2]) == 0
    # the read-only entry point localizes the same rows
    loc, ovf = dist.localize_reads(sharded, al_contig[:, 0], S,
                                   out_factor=plan.localize_out_factor)
    for a, b in zip(loc, got[0]):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


def test_localize_with_skewed_destinations_overflows(ref, port):
    """Every read to contig 0's owner with an out factor of 1: half the
    reads do not fit shard 0's block, and the count says so."""
    _, _, sharded, _, _ = port
    R = sharded.num_reads
    got = stages.localize_with(
        sharded, torch.zeros(R, dtype=torch.int32),
        (torch.arange(R, dtype=torch.int32),), S, out_factor=1)
    _eq_localized(got, ref, "skew")
    assert int(got[2]) > 0
