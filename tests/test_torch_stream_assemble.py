"""The slice end to end on the CPU: the port's
`Assembler(plan, Local("cpu")).assemble_stream(batches)` against the JAX
`Assembler(plan, Local()).assemble_stream(batches)`, with gapped
alignment off and on.

Fixture: tests/test_stream.py:251's community (3 genomes of 300 bp, 800
reads of 60 bp) in 4 batches of 256 reads, under a `from_stream` plan
(the streamed bill: k-mer table and Bloom filters sized from a k-mer
population of 1000, not from the read count).  The gapped run takes
rounds k = 17 and 21, the Hamming run k = 21 alone, so the second JAX run
compiles little beyond what the first one compiled.
Tolerance: exact, every result array, the IterationStats (the streamed
aligned_frac is the reference's Python division), the per-k StreamStats
and the overflow counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import Assembler as JAssembler, AssemblyPlan as JPlan, \
    Local as JLocal
from repro.data import mgsim as jmgsim
from repro.stream import batches_from_readset as jbatches_from_readset
from repro_torch import bridge
from repro_torch.api import Assembler, AssemblyPlan, Local
from repro_torch.core import alignment
from repro_torch.core.types import ReadSet
from repro_torch.stream import batches_from_readset

RESULT_KEYS = ("contigs", "alive", "alignments", "links", "suspended",
               "components", "scaffolds", "scaffold_seqs")
PLAN = dict(batch_reads=256, max_len=60, unique_kmers=1000, slack=4.0)
# gapped: two rounds (round 2 streams with the round-1 contigs as `prev`);
# Hamming: the last round only, to keep the file's JAX compiles down
K_RANGE = {True: (17, 21, 4), False: (21, 21, 4)}


@pytest.fixture(scope="module")
def runs():
    comm = jmgsim.sample_community(5, num_genomes=3, genome_len=300,
                                   abundance_sigma=0.3)
    jreads, _ = jmgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                      err_rate=0.003)
    reads = ReadSet(*(bridge.tensor(np.asarray(getattr(jreads, f)))
                      for f in ("bases", "lengths", "mate")),
                    jreads.insert_size)
    jbatches = jbatches_from_readset(jreads, 256)
    batches = batches_from_readset(reads, 256)
    out = {}
    for gapped in (True, False):
        kw = dict(PLAN, k_range=K_RANGE[gapped], gapped_align=gapped)
        want = JAssembler(JPlan.from_stream(**kw),
                          JLocal()).assemble_stream(jbatches)
        got = Assembler(AssemblyPlan.from_stream(**kw),
                        Local(device="cpu")).assemble_stream(batches)
        out[gapped] = (want, got)
    out["batches"] = batches
    return out


@pytest.mark.parametrize("key", RESULT_KEYS)
@pytest.mark.parametrize("gapped", [True, False])
def test_result_matches_reference(runs, gapped, key):
    want, got = runs[gapped]
    g, w = bridge.to_numpy(got[key], key), want[key]
    if isinstance(g, dict):
        for f, a in g.items():
            np.testing.assert_array_equal(a, np.asarray(getattr(w, f)),
                                          err_msg=f"{key}.{f}")
    else:
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)


@pytest.mark.parametrize("gapped", [True, False])
def test_stats_stream_stats_overflow_and_plan_match(runs, gapped):
    want, got = runs[gapped]
    assert set(got) == set(want)
    assert [dataclasses.asdict(s) for s in got["stats"]] == \
        [dataclasses.asdict(s) for s in want["stats"]]
    assert {k: dataclasses.asdict(v) for k, v in got["stream_stats"].items()
            } == {k: dataclasses.asdict(v)
                  for k, v in want["stream_stats"].items()}
    assert got["overflow"] == want["overflow"] == {"kmer_table": 0}
    fields = dataclasses.asdict(got["plan"])
    ref = dataclasses.asdict(want["plan"])
    for key in ("policy", "kernel_backend"):
        fields.pop(key), ref.pop(key)
    assert fields == ref


def test_the_runs_assemble_and_take_their_verifications(runs):
    """Both runs make scaffolds; the gapped run's final alignment rows are
    DP verdicts, which differ from Hamming ones on the same contigs."""
    for gapped in (True, False):
        _, got = runs[gapped]
        assert int(got["scaffold_seqs"].n_scaffolds) > 0
        assert int(got["scaffold_seqs"].lengths.sum()) > 300
        assert float(got["stats"][-1].aligned_frac) > 0.9
    got = runs[True][1]
    plan = got["plan"]
    sidx = alignment.build_seed_index(got["contigs"], got["alive"],
                                      seed_len=21, capacity=plan.seed_cap)
    rows = {gapped: alignment.align_reads(
        runs["batches"][0], got["contigs"], sidx, seed_len=21,
        stride=plan.seed_stride, gapped=gapped) for gapped in (True, False)}
    n = rows[True].matches.shape[0]
    for f in alignment.Alignments._fields:
        assert torch.equal(getattr(rows[True], f),
                           getattr(got["alignments"], f)[:n]), f
    assert not torch.equal(rows[True].matches, rows[False].matches)
