"""The port's owner-partitioned streamed k-mer analysis
(`stream.sharded_streaming_kmer_analysis`: `dist.stages`'
`sharded_bloom_observe` and `sharded_stream_fold` over [S, bloom_bits]
filters and a flat [S * capacity] running table) against the
reference's at S = 2, over 2 batches of 400 reads.

Fixture and plan: tests/test_torch_dist_stages.py's.  The reference's
stages compile anew on every call (~12 s a call on a CPU even when a
persistent cache holds the program), so this file keeps to 2 batches.
Tolerance: exact, the running table and every `StreamStats` counter.
A checkpointed port run that resumes from its own checkpoint returns the
same table.
"""
import dataclasses

import pytest

from repro_torch import bridge
from repro_torch.core.types import ReadSet
from repro_torch.stream import batches_from_readset
from repro_torch.stream.analysis import sharded_streaming_kmer_analysis
from test_torch_dist_stages import FIXTURE
from test_torch_exchange import eq, run_reference

S = 2
BATCH = 400

_BODY = FIXTURE.format(S=S) + f"""
from repro.stream import batches_from_readset
from repro.stream.analysis import sharded_streaming_kmer_analysis

run, st = sharded_streaming_kmer_analysis(
    batches_from_readset(reads, {BATCH}), mesh, k=21,
    capacity=plan.shard_table_cap, bloom_bits=plan.bloom_slots,
    pre_capacity=plan.pre_cap, route_capacity=plan.route_capacity)
put("stream", run)
put_json("stream_stats", dataclasses.asdict(st))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_BODY, tmp_path_factory.mktemp("x") / "ref.npz",
                         ndev=S)


def _run(ref, **kw):
    plan = bridge.plan_from_fields(ref.json("plan"))
    reads = ReadSet(ref.tensor("reads.bases"), ref.tensor("reads.lengths"),
                    ref.tensor("reads.mate"), int(ref["reads.insert_size"]))
    batches = batches_from_readset(reads, BATCH)
    assert len(batches) == 2
    return sharded_streaming_kmer_analysis(
        batches, S, k=21, capacity=plan.shard_table_cap,
        bloom_bits=plan.bloom_slots, pre_capacity=plan.pre_cap,
        route_capacity=plan.route_capacity, **kw)


def test_sharded_streaming_kmer_analysis(ref):
    run, stats = _run(ref)
    for key, v in run.items():
        eq(v, ref[f"stream.{key}"], f"stream.{key}")
    assert dataclasses.asdict(stats) == ref.json("stream_stats")
    assert stats.occurrences_admitted > 0 and stats.route_overflow == 0


def test_sharded_streaming_checkpoint_resumes(ref, tmp_path):
    first, s1 = _run(ref, checkpoint_dir=str(tmp_path))
    again, s2 = _run(ref, checkpoint_dir=str(tmp_path))
    assert not s1.resumed and s2.resumed
    for key, v in again.items():
        eq(v, ref[f"stream.{key}"], f"resumed stream.{key}")
