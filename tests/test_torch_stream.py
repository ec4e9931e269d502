"""`repro_torch.stream` against `repro.stream`, on the CPU: batch sources,
`AssemblyPlan.from_stream`, the two-pass streamed k-mer analysis and its
checkpoint/resume, the refusals, and the port's streamed assembly against
its own in-memory one (the whole-path comparison with the JAX
`assemble_stream` is tests/test_torch_stream_assemble.py).

Inputs are made with numpy from a seed and handed to both sides.
Tolerance: exact.
"""
import dataclasses
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import AssemblyPlan as JPlan
from repro.data import mgsim as jmgsim
from repro.stream import BatchSource as JBatchSource, \
    batches_from_readset as jbatches_from_readset, \
    pad_batch as jpad_batch, \
    streaming_kmer_analysis as jstreaming_kmer_analysis
from repro_torch import bridge
from repro_torch.api import Assembler, AssemblyPlan, Local, PlanError
from repro_torch.core.types import ReadSet
from repro_torch.data import mgsim
from repro_torch.stream import BatchSource, batches_from_readset, \
    job_checkpoint_dir, pad_batch, streaming_kmer_analysis
from repro_torch.stream.analysis import _fingerprint


def _port_reads(jreads):
    return ReadSet(*(bridge.tensor(np.asarray(getattr(jreads, f)))
                     for f in ("bases", "lengths", "mate")),
                   jreads.insert_size)


def _eq_batch(got, want, what):
    for f in ("bases", "lengths", "mate"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what}.{f}")
    assert got.insert_size == want.insert_size


# ---------------------------------------------------------------------------
# batch sources
# ---------------------------------------------------------------------------


def test_batches_from_readset_matches_reference():
    comm = jmgsim.sample_community(11, num_genomes=2, genome_len=300)
    jreads, _ = jmgsim.generate_reads(12, comm, num_pairs=100, read_len=50)
    want = jbatches_from_readset(jreads, 64)
    got = batches_from_readset(_port_reads(jreads), 64)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _eq_batch(g, w, f"batch {i}")
        m = g.mate.numpy()
        paired = m >= 0
        assert (m[m[paired]] == np.arange(64)[paired]).all()
    assert (got[-1].lengths.numpy()[200 - 64 * 3:] == 0).all()
    with pytest.raises(ValueError, match="even"):
        batches_from_readset(_port_reads(jreads), 63)


def test_pad_batch_matches_reference():
    comm = jmgsim.sample_community(3, num_genomes=1, genome_len=200)
    jreads, _ = jmgsim.generate_reads(4, comm, num_pairs=5, read_len=30)
    _eq_batch(pad_batch(_port_reads(jreads), 16), jpad_batch(jreads, 16),
              "padded")
    with pytest.raises(ValueError, match="batch_reads"):
        pad_batch(_port_reads(jreads), 8)


def test_generate_read_batches_matches_reference():
    comm = jmgsim.sample_community(13, num_genomes=2, genome_len=300)
    kw = dict(pairs_per_batch=32, read_len=50, err_rate=0.01)
    src = BatchSource(lambda: mgsim.generate_read_batches(14, comm, 70,
                                                          **kw))
    jsrc = JBatchSource(lambda: jmgsim.generate_read_batches(14, comm, 70,
                                                             **kw))
    got, want = list(src), list(jsrc)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        _eq_batch(g, w, f"batch {i}")
    for g, again in zip(got, src):  # deterministic re-iteration
        assert torch.equal(g.bases, again.bases)
    assert int((got[-1].lengths > 0).sum()) == 12


# ---------------------------------------------------------------------------
# AssemblyPlan.from_stream
# ---------------------------------------------------------------------------

FROM_STREAM_CASES = [
    ((2048, 60, (17, 21, 4)), dict(total_reads=10_000)),
    ((2048, 60, (17, 21, 4)), dict(total_reads=7_500_000_000)),
    ((8192, 60, (17, 21, 4)), {}),
    ((2048, 60, (17, 21, 4)), dict(bloom_bits=1 << 24)),
    ((4096, 60), dict(unique_kmers=1 << 20)),
    ((200, 60, (21, 21, 4)), dict(unique_kmers=800, slack=4.0)),
    ((32768, 150, (17, 21, 4)), dict(unique_kmers=500_181,
                                     gapped_align=True)),
    ((64, 60, (21, 21, 4)), dict(min_count=1)),
]


@pytest.mark.parametrize("args,kw", FROM_STREAM_CASES)
def test_from_stream_matches_reference(args, kw):
    want = JPlan.from_stream(*args, **kw)
    got = AssemblyPlan.from_stream(*args, **kw)
    fields, ref = dataclasses.asdict(got), dataclasses.asdict(want)
    for key in ("policy", "kernel_backend"):
        fields.pop(key), ref.pop(key)
    assert fields == ref
    assert got.bloom_slots == want.bloom_slots
    assert got.stage_bytes() == want.stage_bytes()
    assert got.bytes() == want.bytes()


def test_from_stream_bill_ignores_total_reads():
    small = AssemblyPlan.from_stream(2048, 60, total_reads=10_000)
    huge = AssemblyPlan.from_stream(2048, 60, total_reads=7_500_000_000)
    assert small == huge and small.bytes() == huge.bytes()
    assert AssemblyPlan.from_stream(8192, 60).bytes() > small.bytes()
    roomy = AssemblyPlan.from_stream(2048, 60, bloom_bits=1 << 24)
    assert roomy.stage_bytes()["bloom_filters"] == 2 << 24


@pytest.mark.parametrize("args,kw,match", [
    ((101, 60), {}, "batch_reads"),
    ((100, 60), dict(bloom_bits=1000), "bloom_bits"),
    ((100, 60), dict(num_shards=0), "num_shards"),
])
def test_from_stream_refusals(args, kw, match):
    with pytest.raises(PlanError, match=match):
        AssemblyPlan.from_stream(*args, **kw)


# ---------------------------------------------------------------------------
# streamed k-mer analysis
# ---------------------------------------------------------------------------

KW = dict(k=21, capacity=1 << 13, bloom_bits=1 << 16)


@pytest.fixture(scope="module")
def erroneous():
    """tests/test_stream.py's fixture: one 600 bp genome, 25x, 1% errors,
    in batches of 64 reads."""
    _, jreads, _ = jmgsim.single_genome_reads(51, genome_len=600,
                                              coverage=25, err_rate=0.01)
    jbatches = jbatches_from_readset(jreads, 64)
    batches = batches_from_readset(_port_reads(jreads), 64)
    return jbatches, batches


def _eq_run(got, want, what):
    for key in ("hi", "lo", "count", "left_cnt", "right_cnt", "n_unique",
                "overflow"):
        g = bridge.to_numpy(got[key], key)
        np.testing.assert_array_equal(g, np.asarray(want[key]),
                                      err_msg=f"{what}: {key}")


def test_streaming_kmer_analysis_matches_reference(erroneous):
    jbatches, batches = erroneous
    assert len(batches) >= 3
    kw = dict(k=21, capacity=1 << 14, bloom_bits=1 << 17)
    want, wstats = jstreaming_kmer_analysis(jbatches, **kw)
    got, stats = streaming_kmer_analysis(batches, **kw)
    _eq_run(got, want, "run")
    assert dataclasses.asdict(stats) == dataclasses.asdict(wstats)
    assert stats.batches_pass2 == len(batches)
    assert 0 < stats.occurrences_admitted < stats.occurrences_total


def _poisoned(batch):
    """A batch of the same shape whose content would change the counts."""
    return batch._replace(bases=(batch.bases + 1) % 4)


class _Interrupted(Exception):
    pass


def _interrupting(batches, stop_after: int):
    """A re-iterable source that raises once `stop_after` batches have
    been taken over all its passes (a crash mid-analysis)."""
    taken = [0]

    def gen():
        for b in batches:
            if taken[0] == stop_after:
                raise _Interrupted
            taken[0] += 1
            yield b
    return BatchSource(gen)


@pytest.mark.parametrize("stop_after", [2, 6])
def test_checkpoint_resume_equals_uninterrupted_run(erroneous, stop_after):
    """A run cut in pass 1 (after 2 batches) or pass 2 (after 6, the 4
    of pass 1 and 2) resumes from its checkpoint and ends with the
    uninterrupted run's table and counters."""
    _, batches = erroneous
    assert len(batches) == 4
    want, wstats = streaming_kmer_analysis(batches, **KW)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(_Interrupted):
            # +2: the device probe and the fingerprint each read the
            # first batch before pass 1
            streaming_kmer_analysis(
                _interrupting(batches, stop_after + 2), checkpoint_dir=d,
                **KW)
        got, stats = streaming_kmer_analysis(batches, checkpoint_dir=d, **KW)
    assert stats.resumed
    _eq_run(got, bridge.to_numpy(want), "resumed")
    for f in ("batches_pass1", "batches_pass2", "occurrences_total",
              "occurrences_admitted", "table_overflow"):
        assert getattr(stats, f) == getattr(wstats, f), f


def test_finished_checkpoint_skips_every_batch(erroneous):
    """A rerun over a finished checkpoint restores the last state: every
    batch after the first (read for the fingerprint) is poisoned, so an
    equal table shows that no batch was processed again."""
    _, batches = erroneous
    with tempfile.TemporaryDirectory() as d:
        cold, s_cold = streaming_kmer_analysis(batches, checkpoint_dir=d,
                                               **KW)
        assert not s_cold.resumed
        warm, s_warm = streaming_kmer_analysis(
            [batches[0]] + [_poisoned(b) for b in batches[1:]],
            checkpoint_dir=d, **KW)
        assert s_warm.resumed and s_warm.batches_pass2 == len(batches)
        _eq_run(warm, bridge.to_numpy(cold), "warm")


def test_checkpoint_fingerprint_mismatch_raises(erroneous):
    _, batches = erroneous
    with tempfile.TemporaryDirectory() as d:
        streaming_kmer_analysis(batches, checkpoint_dir=d, **KW)
        with pytest.raises(ValueError, match="fingerprint"):
            streaming_kmer_analysis([_poisoned(b) for b in batches],
                                    checkpoint_dir=d, **KW)
        with pytest.raises(ValueError, match="fingerprint"):
            streaming_kmer_analysis(batches, checkpoint_dir=d,
                                    **{**KW, "bloom_bits": 1 << 15})


def test_fingerprint_and_job_dirs():
    b = batches_from_readset(mgsim.single_genome_reads(3, 200, 4)[1], 16)
    assert _fingerprint(b, k=21) == _fingerprint(list(b), k=21)
    assert _fingerprint(b, k=21) != _fingerprint(b, k=17)
    assert job_checkpoint_dir("/r", "job/a") != job_checkpoint_dir("/r",
                                                                   "job:a")


def test_single_shot_iterator_refused(erroneous):
    _, batches = erroneous
    with pytest.raises(TypeError, match="single-shot"):
        streaming_kmer_analysis(iter(batches), **KW)
    plan = AssemblyPlan.from_stream(64, 60, (21, 21, 4))
    with pytest.raises(TypeError, match="BatchSource"):
        Assembler(plan, Local("cpu")).assemble_stream(iter(batches))


def test_assemble_stream_refuses_min_count_below_two(erroneous):
    _, batches = erroneous
    plan = AssemblyPlan.from_stream(64, 60, (21, 21, 4), min_count=1)
    with pytest.raises(PlanError, match="min_count >= 2"):
        Assembler(plan, Local("cpu")).assemble_stream(batches)


# ---------------------------------------------------------------------------
# the port's streamed assembly against its in-memory one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def community_reads():
    """tests/test_stream.py:251's community."""
    comm = mgsim.sample_community(5, num_genomes=3, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                    err_rate=0.003)
    return reads


@pytest.mark.parametrize("gapped", [False, True])
def test_streamed_equals_in_memory(community_reads, gapped):
    reads = community_reads
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.2,
                                     gapped_align=gapped)
    mem = Assembler(plan, Local("cpu")).assemble(reads)
    batches = batches_from_readset(reads, 256)
    events = []
    st = Assembler(plan, Local("cpu")).assemble_stream(
        batches, hook=lambda stage, info: events.append(stage))
    for f in mem["scaffold_seqs"]._fields:
        assert torch.equal(getattr(mem["scaffold_seqs"], f),
                           getattr(st["scaffold_seqs"], f)), f
    assert torch.equal(mem["alive"], st["alive"])
    assert all(v == 0 for v in st["overflow"].values()), st["overflow"]
    assert set(st["stream_stats"]) == set(plan.ks())
    assert all(s.batches_pass2 == len(batches)
               for s in st["stream_stats"].values())
    assert events.count("analyze") == 2
    assert events.count("align") == len(batches)
    assert st["alignments"].contig.shape == (256 * len(batches), 2)


def test_assemble_stream_checkpoint_resume_and_from_stream_plan():
    """A from_stream plan end to end; a second run with the same
    checkpoint_dir resumes every k and returns the same result."""
    comm = mgsim.sample_community(21, num_genomes=2, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(22, comm, num_pairs=300, read_len=60,
                                    err_rate=0.003)
    plan = AssemblyPlan.from_stream(200, 60, (21, 21, 4), unique_kmers=800,
                                    slack=4.0)
    batches = batches_from_readset(reads, 200)
    with tempfile.TemporaryDirectory() as d:
        a = Assembler(plan, Local("cpu")).assemble_stream(
            batches, checkpoint_dir=d)
        b = Assembler(plan, Local("cpu")).assemble_stream(
            batches, checkpoint_dir=d)
    assert not any(s.resumed for s in a["stream_stats"].values())
    assert all(s.resumed for s in b["stream_stats"].values())
    assert int(a["scaffold_seqs"].lengths.sum()) > 300
    for f in a["scaffold_seqs"]._fields:
        assert torch.equal(getattr(a["scaffold_seqs"], f),
                           getattr(b["scaffold_seqs"], f)), f
    assert a["stats"] == b["stats"] and a["overflow"] == b["overflow"]
    assert a["overflow"]["kmer_table"] == 0


def test_round_two_streamed_counts_lack_read_singletons():
    """A property of the reference that the port keeps (ROADMAP.md Queue
    3): from round 2 on, the in-memory count of a contig k-mer is its read
    count plus the contig pseudo-count, while the streamed count leaves
    out a read k-mer seen once (the two-sighting rule drops it before the
    merge).  A 60-base sequence in one read and in one contig: in memory
    its 21-mers count 1 + 4 = 5, streamed 4, in both packages."""
    from repro.api import Local as JLocal
    from repro.core.types import ContigSet as JContigSet, \
        ReadSet as JReadSet
    from repro_torch.core import kmer_analysis
    from repro_torch.core.types import ContigSet

    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 300).astype(np.uint8)
    starts = rng.integers(0, 240, 62)
    bases = np.stack([genome[s:s + 60] for s in starts])
    once = rng.integers(0, 4, 60).astype(np.uint8)
    bases[-2] = once
    R = len(bases)
    jreads = JReadSet(bases=jnp.asarray(bases),
                      lengths=jnp.full((R,), 60, jnp.int32),
                      mate=jnp.full((R,), -1, jnp.int32), insert_size=0)
    cbases = np.full((4, 64), 4, np.uint8)
    cbases[0, :60] = once
    clens = np.array([60, 0, 0, 0], np.int32)
    jcontigs = JContigSet(bases=jnp.asarray(cbases),
                          lengths=jnp.asarray(clens),
                          depths=jnp.ones((4,), jnp.float32))
    jalive = jnp.asarray(clens > 0)
    jplan = JPlan(k_min=21, k_max=21, kmer_capacity=1 << 12, contig_cap=4)
    plan = AssemblyPlan(k_min=21, k_max=21, kmer_capacity=1 << 12,
                        contig_cap=4)
    reads = _port_reads(jreads)
    contigs = bridge.to_torch(jcontigs, ContigSet)
    alive = bridge.tensor(np.asarray(jalive))

    def counts(kset):
        a = {f: (bridge.to_numpy(getattr(kset, f), f)
                 if torch.is_tensor(getattr(kset, f))
                 else np.asarray(getattr(kset, f)))
             for f in ("hi", "lo", "count", "used")}
        return {(int(h), int(l)): int(c) for h, l, c, u in
                zip(a["hi"], a["lo"], a["count"], a["used"]) if u}

    one = ReadSet(torch.from_numpy(once[None].copy()),
                  torch.tensor([60], dtype=torch.int32),
                  torch.tensor([-1], dtype=torch.int32), 0)
    hi, lo, _, _, valid = kmer_analysis.occurrences(one, k=21)
    once_keys = {(int(h) & 0xFFFFFFFF, int(l) & 0xFFFFFFFF)
                 for h, l, v in zip(hi.tolist(), lo.tolist(),
                                    valid.tolist()) if v}
    assert len(once_keys) == 40
    got = {}
    for name, ctx, prev, rs in (
            ("port", Local("cpu"), (contigs, alive), reads),
            ("jax", JLocal(), (jcontigs, jalive), jreads)):
        p = plan if name == "port" else jplan
        ctx.prepare(rs, p)
        mem = counts(ctx.kmer_set(21, prev)[0])
        ctx.prepare_stream(p)
        bfr = batches_from_readset if name == "port" else \
            jbatches_from_readset
        st = counts(ctx.stream_kmer_set(21, bfr(rs, 16), prev)[0])
        got[name] = ({mem[k] for k in once_keys}, {st[k] for k in once_keys})
        assert {k: v for k, v in mem.items() if k not in once_keys} == \
            {k: v for k, v in st.items() if k not in once_keys}
    assert got["port"] == got["jax"] == ({5}, {4})


def test_checkpointer_keeps_the_newest_steps_and_reports_write_errors(
        tmp_path):
    from repro_torch.train.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    template = {"a": torch.zeros(3, dtype=torch.int32),
                "b": torch.zeros((), dtype=torch.bool)}
    with pytest.raises(FileNotFoundError):
        ck.restore(template)
    for step in (1, 5, 9):
        ck.save(step, {"a": torch.arange(3, dtype=torch.int32) + step,
                       "b": torch.tensor(step > 4)})
    assert ck.list_steps() == [5, 9]
    state, step = ck.restore(template)
    assert step == 9 and state["a"].tolist() == [9, 10, 11]
    assert bool(state["b"]) and not any(
        p.name.startswith(".tmp") for p in (tmp_path / "ck").iterdir())
    (tmp_path / "ck" / "step_0000000011").write_text("")  # blocks step 11
    with pytest.raises(OSError):
        ck.save(11, template)
    (tmp_path / "ck" / "step_0000000011").unlink()
    assert ck.restore(template)[1] == 9
