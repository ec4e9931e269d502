"""`core/bloom.py` and the Bloom half of `core/kmer_analysis.py` of the
port against the JAX reference, on the CPU, and `Assembler.assemble` with
`low_memory=True` (the two-sighting admission on the in-memory path)
against the JAX `Local` run.

Inputs are made with numpy from a seed and handed to both.  Tolerance:
exact (filter bits, admission masks, count tables and every result array
are integers; float32 stats are computed the reference's way).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import Assembler as JAssembler, AssemblyPlan as JPlan, \
    Local as JLocal
from repro.core import bloom as jbloom
from repro.core import kmer_analysis as jka
from repro.data import mgsim as jmgsim
from repro_torch import bridge
from repro_torch.api import Assembler, Local
from repro_torch.core import bloom, kmer_analysis
from repro_torch.core.types import ReadSet


def _keys(rng, n, dup_frac=0.0):
    """Dual-lane keys (hi < 2**30) with a share of repeated rows."""
    hi = rng.integers(0, 1 << 30, size=n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    d = np.flatnonzero(rng.random(n) < dup_frac)
    src = rng.integers(0, n, size=len(d))
    hi[d], lo[d] = hi[src], lo[src]
    return hi, lo


def _t(a):
    return bridge.tensor(a)


def _eq(got, want, what):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("num_hashes", [1, 3, 4])
@pytest.mark.parametrize("m", [1 << 10, 1 << 14])
def test_insert_and_query_match_reference(num_hashes, m):
    rng = np.random.default_rng(m + num_hashes)
    f, jf = bloom.empty(m, num_hashes), jbloom.empty(m, num_hashes)
    for part in range(3):  # several inserts, with invalid rows
        hi, lo = _keys(rng, 300)
        valid = rng.random(300) < 0.8
        f = bloom.insert(f, _t(hi), _t(lo), _t(valid))
        jf = jbloom.insert(jf, jnp.asarray(hi), jnp.asarray(lo),
                           jnp.asarray(valid))
        _eq(f.bits, jf.bits, f"bits after insert {part}")
    qhi, qlo = _keys(rng, 2000)
    qhi[:300], qlo[:300] = hi, lo
    _eq(bloom.query(f, _t(qhi), _t(qlo)),
        jbloom.query(jf, jnp.asarray(qhi), jnp.asarray(qlo)), "query")
    assert bloom.query(f, _t(hi), _t(lo))[_t(valid)].all()


def test_insert_leaves_its_input_and_invalid_rows_alone():
    rng = np.random.default_rng(2)
    hi, lo = _keys(rng, 64)
    f0 = bloom.empty(1 << 12)
    f1 = bloom.insert(f0, _t(hi), _t(lo), torch.zeros(64, dtype=torch.bool))
    assert not f0.bits.any() and not f1.bits.any()
    f2 = bloom.insert(f0, _t(hi), _t(lo), torch.ones(64, dtype=torch.bool))
    assert not f0.bits.any() and f2.bits.any()
    with pytest.raises(AssertionError):
        bloom.empty(1000)


@pytest.mark.parametrize("seed", range(4))
def test_dup_in_chunk_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    hi, lo = _keys(rng, n, dup_frac=0.4)
    valid = rng.random(n) < 0.85
    got = kmer_analysis.dup_in_chunk(_t(hi), _t(lo), _t(valid))
    _eq(got, jka.dup_in_chunk(jnp.asarray(hi), jnp.asarray(lo),
                              jnp.asarray(valid)), "dup_in_chunk")
    # the second and later valid occurrences of each key, in row order
    seen, want = set(), np.zeros(n, bool)
    for i in np.flatnonzero(valid):
        key = (int(hi[i]), int(lo[i]))
        want[i] = key in seen
        seen.add(key)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def erroneous_reads():
    """tests/test_stream.py's fixture: one 600 bp genome, 25x, 1% errors."""
    _, jreads, _ = jmgsim.single_genome_reads(51, genome_len=600,
                                              coverage=25, err_rate=0.01)
    reads = ReadSet(*(_t(np.asarray(getattr(jreads, f)))
                      for f in ("bases", "lengths", "mate")),
                    jreads.insert_size)
    return jreads, reads


def test_bloom_observe_and_admit_match_reference(erroneous_reads):
    jreads, reads = erroneous_reads
    lanes = kmer_analysis.occurrences(reads, k=21)
    hi, lo, valid = lanes[0], lanes[1], lanes[4]
    jhi, jlo, jvalid = (jnp.asarray(bridge.to_numpy(x, n))
                        for x, n in ((hi, "hi"), (lo, "lo"), (valid, "")))
    m = 1 << 14
    f1, f2 = bloom.empty(m), bloom.empty(m)
    jf1, jf2 = jbloom.empty(m), jbloom.empty(m)
    n = hi.shape[0]
    for c in range(5):  # uneven chunks, as batches of different sizes
        sl = slice(c * n // 5, (c + 1) * n // 5)
        f1, f2 = kmer_analysis.bloom_observe(f1, f2, hi[sl], lo[sl],
                                             valid[sl])
        jf1, jf2 = jka.bloom_observe(jf1, jf2, jhi[sl], jlo[sl], jvalid[sl])
        _eq(f1.bits, jf1.bits, f"f1 after chunk {c}")
        _eq(f2.bits, jf2.bits, f"f2 after chunk {c}")
    got = kmer_analysis.bloom_admit(f2, hi, lo, valid)
    _eq(got, jka.bloom_admit(jf2, jhi, jlo, jvalid), "bloom_admit")
    assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.parametrize("bloom_bits,num_chunks", [(1 << 16, 4),
                                                   (1 << 12, 3)])
def test_admit_two_sightings_and_analyze_match_reference(
        erroneous_reads, bloom_bits, num_chunks):
    jreads, reads = erroneous_reads
    hi, lo, _, _, valid = kmer_analysis.occurrences(reads, k=21)
    jhi, jlo, _, _, jvalid = jka.occurrences(jreads, k=21)
    _eq(kmer_analysis.admit_two_sightings(hi, lo, valid,
                                          bloom_bits=bloom_bits,
                                          num_chunks=num_chunks),
        jka.admit_two_sightings(jhi, jlo, jvalid, bloom_bits=bloom_bits,
                                num_chunks=num_chunks),
        "admit_two_sightings")
    kw = dict(k=21, capacity=1 << 14, low_memory=True, bloom_bits=bloom_bits)
    got = kmer_analysis.analyze(reads, **kw)
    want = jka.analyze(jreads, **kw)
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f"analyze {f}")


def test_empty_count_table_is_the_merge_identity(erroneous_reads):
    _, reads = erroneous_reads
    tab = kmer_analysis.count_occurrences(
        *kmer_analysis.occurrences(reads, k=21), capacity=1 << 14)
    merged = kmer_analysis.merge_counts(
        kmer_analysis.empty_count_table(1 << 14), tab, capacity=1 << 14)
    for key in ("hi", "lo", "count", "left_cnt", "right_cnt", "n_unique",
                "overflow"):
        assert torch.equal(merged[key], tab[key]), key
    want = jka.empty_count_table(1 << 14)
    for key, v in kmer_analysis.empty_count_table(1 << 14).items():
        _eq(v, want[key], key)


# ---------------------------------------------------------------------------
# Assembler.assemble with low_memory=True
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def low_memory_runs():
    """tests/test_stream.py:251's community, its in-memory plan with the
    Bloom admission on."""
    comm = jmgsim.sample_community(5, num_genomes=3, genome_len=300,
                                   abundance_sigma=0.3)
    jreads, _ = jmgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                      err_rate=0.003)
    jplan = JPlan.from_dataset(jreads, (17, 21, 4), unique_rate=0.2,
                               low_memory=True)
    want = JAssembler(jplan, JLocal()).assemble(jreads)
    fields = dataclasses.asdict(jplan)
    fields["policy"] = tuple(jplan.policy)
    reads = ReadSet(*(_t(np.asarray(getattr(jreads, f)))
                      for f in ("bases", "lengths", "mate")),
                    jreads.insert_size)
    got = Assembler(bridge.plan_from_fields(fields),
                    Local(device="cpu")).assemble(reads)
    return want, got


@pytest.mark.parametrize("key", ["contigs", "alive", "alignments", "links",
                                 "suspended", "components", "scaffolds",
                                 "scaffold_seqs"])
def test_low_memory_assemble_matches_reference(low_memory_runs, key):
    want, got = low_memory_runs
    g, w = bridge.to_numpy(got[key], key), want[key]
    if isinstance(g, dict):
        for f, a in g.items():
            np.testing.assert_array_equal(a, np.asarray(getattr(w, f)),
                                          err_msg=f"{key}.{f}")
    else:
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)


def test_low_memory_assemble_stats_match_reference(low_memory_runs):
    want, got = low_memory_runs
    assert [dataclasses.asdict(s) for s in got["stats"]] == \
        [dataclasses.asdict(s) for s in want["stats"]]
    assert got["overflow"] == want["overflow"]
    assert int(got["scaffold_seqs"].n_scaffolds) > 0
