"""The port's `Mesh` context end to end.

* `Assembler(plan, Mesh(2, device="cpu")).contig_rounds(reads)` against
  the reference's `Assembler(plan, Mesh(2)).contig_rounds(reads)` on 2
  host devices (one module-scoped subprocess, ~45 s), bit for bit:
  contigs, alive, alignments, every `IterationStats` field and the
  overflow accounting.  Plan: tests/test_torch_dist_stages.py's fixture
  plan with `run_local_assembly=False` (k = 17 then 21, the §II-H contig
  k-mers of round 1 routed to their owners in round 2).
* Plans sized for S shards price the same `stage_bytes()` in both
  packages.
* Port only, the reference's own Mesh checks (tests/test_distributed.py):
  the streamed `Mesh(2)` run equals the in-memory `Local` run in
  scaffold sequences and alive contigs, every overflow 0; the in-memory
  `Mesh(2)` run with `localize_out_factor=8` has every overflow 0, a
  genome fraction at most 0.02 below the `Local` run's and at most one
  more misassembly.
* `Mesh()` without a card and without `device="cpu"` raises; `spawn`
  shares the device and the shard count and none of a run's state.
* The same `contig_rounds` over a gloo group of W = 2 spawned ranks
  (`Mesh(2, group=...)`, one shard a rank, `launch.mesh.spawn`) against
  the same reference run, bit for bit, on every rank.
"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from benchmarks import metrics
from repro.api import AssemblyPlan as JPlan
from repro_torch import bridge
from repro_torch.api import Assembler, AssemblyPlan, Local, Mesh
from repro_torch.api import context
from repro_torch.core.types import ReadSet
from repro_torch.data import mgsim
from repro_torch.stream import batches_from_readset
from test_torch_dist_stages import FIXTURE
from test_torch_exchange import eq, eq_record, run_reference
from test_torch_mesh_group import contig_rounds_rank, run_group

S = 2

_BODY = FIXTURE.format(S=S) + """
from repro.api import Assembler, Mesh
p = dataclasses.replace(plan, run_local_assembly=False)
asm = Assembler(p, Mesh(num_shards=2))
contigs, alive, al, stats = asm.contig_rounds(reads)
put("contigs", contigs)
put("alive", alive)
put("al", al)
put_json("stats", [dataclasses.asdict(s) for s in stats])
put_json("overflow", asm.ctx.overflow())
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_BODY, tmp_path_factory.mktemp("x") / "ref.npz",
                         ndev=S)


def test_contig_rounds_matches_the_reference_mesh(ref):
    plan = dataclasses.replace(bridge.plan_from_fields(ref.json("plan")),
                               run_local_assembly=False)
    reads = ReadSet(ref.tensor("reads.bases"), ref.tensor("reads.lengths"),
                    ref.tensor("reads.mate"), int(ref["reads.insert_size"]))
    asm = Assembler(plan, Mesh(S, device="cpu"))
    contigs, alive, al, stats = asm.contig_rounds(reads)
    eq_record(contigs, ref, "contigs")
    eq(alive, ref["alive"], "alive")
    eq_record(al, ref, "al")
    assert [dataclasses.asdict(s) for s in stats] == ref.json("stats")
    assert asm.ctx.overflow() == ref.json("overflow")
    assert int(alive.sum()) > 0 and len(stats) == 2


def test_contig_rounds_over_a_group_matches_the_reference_mesh(ref,
                                                               tmp_path):
    plan = dataclasses.replace(bridge.plan_from_fields(ref.json("plan")),
                               run_local_assembly=False)
    reads = ReadSet(ref.tensor("reads.bases"), ref.tensor("reads.lengths"),
                    ref.tensor("reads.mate"), int(ref["reads.insert_size"]))
    inp = tmp_path / "inp.pt"
    torch.save(dict(plan=plan, reads=reads), inp)
    ranks = run_group(contig_rounds_rank, S, tmp_path, (str(inp),))
    got = ranks[0]
    eq_record(got["contigs"], ref, "contigs")
    eq(got["alive"], ref["alive"], "alive")
    eq_record(got["al"], ref, "al")
    for r in ranks:
        assert r["stats"] == ref.json("stats")
        assert r["overflow"] == ref.json("overflow")
        assert r["digest"] == ranks[0]["digest"] and len(set(
            r["digest"])) == 1


SHAPE = SimpleNamespace(num_reads=800, max_len=60)
CHIP = SimpleNamespace(num_reads=150_000, max_len=150)


@pytest.mark.parametrize("how,shape,kw", [
    ("dataset", SHAPE, dict(num_shards=2, unique_rate=0.2,
                            localize_out_factor=8)),
    ("dataset", SHAPE, dict(num_shards=3)),
    ("dataset", CHIP, dict(num_shards=8, unique_rate=0.1)),
    ("dataset", CHIP, dict(num_shards=8, unique_rate=0.1,
                           route_capacity=4096, pre_capacity=1 << 14)),
    ("stream", None, dict(num_shards=8, unique_kmers=500_000)),
    ("stream", None, dict(num_shards=2)),
])
def test_sharded_plan_prices_the_reference_bill(how, shape, kw):
    def build(Plan):
        if how == "stream":
            return Plan.from_stream(32768, 150, (17, 21, 4), **kw)
        return Plan.from_dataset(shape, (17, 21, 4), **kw)

    want, got = build(JPlan), build(AssemblyPlan)
    assert got.stage_bytes() == want.stage_bytes()
    assert "route_buffers" in got.stage_bytes()
    for f in ("pre_cap", "shard_table_cap", "route_cap", "bloom_slots",
              "seed_cap"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.fixture(scope="module")
def community():
    comm = mgsim.sample_community(5, num_genomes=3, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                    err_rate=0.003)
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), num_shards=S,
                                     unique_rate=0.2, localize_out_factor=8)
    local = Assembler(plan, Local(device="cpu")).assemble(reads)
    return comm, reads, plan, local


def _same(a, b):
    la, lb = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x, y) for x, y in zip(la, lb))


def test_streamed_mesh_equals_in_memory_local(community):
    """tests/test_distributed.py's streamed Mesh-vs-Local parity."""
    _, reads, plan, local = community
    batches = batches_from_readset(reads, 256)
    assert len(batches) >= 2
    out = Assembler(plan, Mesh(S, device="cpu")).assemble_stream(batches)
    assert _same(out["scaffold_seqs"], local["scaffold_seqs"])
    assert _same(out["alive"], local["alive"])
    assert out["overflow"] and all(v == 0 for v in out["overflow"].values())
    assert out["plan"].num_shards == S


def test_mesh_assemble_meets_the_reference_tolerance(community):
    """tests/test_distributed.py's Mesh-vs-Local quality check."""
    comm, reads, plan, local = community
    out = Assembler(plan, Mesh(S, device="cpu")).assemble(reads)
    assert set(out["overflow"]) == {"kmer_route", "kmer_table",
                                    "kmer_gather", "localize",
                                    "localize_pairs"}
    assert all(v == 0 for v in out["overflow"].values()), out["overflow"]

    def quality(o):
        lens = o["scaffold_seqs"].lengths.numpy()
        bases = o["scaffold_seqs"].bases.numpy()
        pieces = [bases[i, :lens[i]] for i in range(len(lens))
                  if lens[i] >= 60]
        return metrics.evaluate(pieces, comm.genomes)

    ql, qm = quality(local), quality(out)
    assert qm["genome_fraction"] >= ql["genome_fraction"] - 0.02, (ql, qm)
    assert qm["misassemblies"] <= ql["misassemblies"] + 1, (ql, qm)
    assert any(s.extended_bases > 0 for s in out["stats"])


def test_mesh_without_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh(2)
    with pytest.raises(ValueError, match="num_shards"):
        Mesh(0, device="cpu")


def test_spawn_shares_the_device_and_nothing_of_a_run(community):
    _, reads, plan, _ = community
    ctx = Mesh(S, device="cpu")
    ctx.prepare(reads, plan)
    ctx._note_overflow("kmer_route", 3)
    child = ctx.spawn()
    assert isinstance(child, Mesh) and child.num_shards == S
    assert child.device == ctx.device and child.overflow() == {}
    assert not hasattr(child, "plan") and not hasattr(child, "sharded")
    local = Local(device="cpu").spawn()
    assert isinstance(local, Local) and local.device.type == "cpu"


def test_mesh_refuses_a_plan_for_another_width(community):
    _, reads, plan, _ = community
    with pytest.raises(ValueError, match="num_shards=3"):
        Mesh(3, device="cpu").prepare(reads, plan)
    ctx = Mesh(4, device="cpu")
    ctx.prepare(reads, dataclasses.replace(plan, num_shards=1))
    assert ctx.plan.num_shards == 4 and ctx.sharded.num_reads % 4 == 0
    with pytest.raises(NotImplementedError, match="Local-only"):
        ctx.kmer_set(17, {"hi": None})
    assert context.ExecutionContext.num_shards == 1
