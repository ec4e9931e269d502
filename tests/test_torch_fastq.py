"""`repro_torch.data.fastq` against `repro.data.fastq`, on the CPU: the
parser (records, blank lines, partial records, parse errors with their
line numbers), the quality trim, `to_readset`, `iter_fastq_batches` from
text, a path and a line iterator, and `write_fasta`.  Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from repro.data import fastq as jfastq
from repro.data import mgsim as jmgsim
from repro_torch.data import fastq

FQ = """@r1
ACGTACGTACGT
+
IIIIIIIIIIII
@r2
TTTTCCCCGGGG
+
IIIIIIII!!!!
"""


def _simulated_fastq(rng, n_reads=37, L=50):
    """FASTQ text of mgsim reads, quality drops and Ns sprinkled in,
    lower-case bases and blank lines between some records."""
    comm = jmgsim.sample_community(7, num_genomes=2, genome_len=400)
    reads, _ = jmgsim.generate_reads(8, comm, num_pairs=(n_reads + 1) // 2,
                                     read_len=L, err_rate=0.01)
    bases = np.asarray(reads.bases)[:n_reads]
    out = []
    for i, row in enumerate(bases):
        seq = "".join("ACGTN"[b] for b in row)
        if rng.random() < 0.2:
            seq = seq.lower()
        q = np.full(L, ord("I"), np.uint8)
        if rng.random() < 0.3:
            q[rng.integers(0, L):] = ord("#")  # q2 tail
        s = list(seq)
        for p in np.flatnonzero(rng.random(L) < 0.02):
            s[p] = "N"
        out.append(f"@read{i}\n{''.join(s)}\n+\n{q.tobytes().decode()}\n")
        if rng.random() < 0.1:
            out.append("\n")
    return "".join(out)


def _eq_records(got, want):
    assert len(got) == len(want)
    for (gs, gq), (ws, wq) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gq, wq)


def _eq_readset(got, want):
    for f in ("bases", "lengths", "mate"):
        g = getattr(got, f)
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.insert_size == want.insert_size


@pytest.mark.parametrize("text", [FQ, FQ + "@r3\nACGT\n", "", "  ", "\n\n",
                                  "@r1", "@r1\n\n\nACGT\n+\nIIII\n"])
def test_parse_matches_reference(text):
    _eq_records(fastq.parse_fastq(text), jfastq.parse_fastq(text))


@pytest.mark.parametrize("bad,match", [
    (FQ.replace("@r2", "r2", 1), "line 5.*header"),
    (FQ.replace("+", "*", 1), "separator"),
    (FQ.replace("IIIIIIIIIIII", "III", 1), "length"),
    ("@r1\n\n\nACGT\n*\nIIII\n", "line 5.*separator"),
])
def test_parse_errors_match_reference(bad, match):
    with pytest.raises(jfastq.FastqParseError, match=match) as want:
        jfastq.parse_fastq(bad)
    with pytest.raises(fastq.FastqParseError, match=match) as got:
        fastq.parse_fastq(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("min_q", [0, 10, 41])
def test_quality_trim_matches_reference(min_q):
    rng = np.random.default_rng(min_q)
    for _ in range(20):
        n = int(rng.integers(0, 30))
        seq = rng.integers(0, 5, n).astype(np.uint8)
        qual = rng.integers(0, 42, n).astype(np.uint8)
        _eq_records([fastq.quality_trim(seq, qual, min_q)],
                    [jfastq.quality_trim(seq, qual, min_q)])


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("max_len", [None, 40])
def test_to_readset_matches_reference(paired, max_len):
    text = _simulated_fastq(np.random.default_rng(1))
    kw = dict(max_len=max_len, min_len=20, insert_size=300, paired=paired)
    _eq_readset(fastq.to_readset(fastq.parse_fastq(text), **kw),
                jfastq.to_readset(jfastq.parse_fastq(text), **kw))


@pytest.mark.parametrize("batch_reads,paired", [(4, True), (10, True),
                                                (7, False), (64, True)])
def test_iter_fastq_batches_matches_reference(tmp_path, batch_reads,
                                              paired):
    text = _simulated_fastq(np.random.default_rng(batch_reads))
    path = tmp_path / "reads.fq"
    path.write_text(text)
    kw = dict(batch_reads=batch_reads, max_len=50, min_len=20,
              insert_size=400, paired=paired)
    want = list(jfastq.iter_fastq_batches(text, **kw))
    for source in (text, str(path), iter(text.splitlines(keepends=True))):
        got = list(fastq.iter_fastq_batches(source, **kw))
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert g.bases.shape == (batch_reads, 50)
            _eq_readset(g, w)


def test_iter_fastq_batches_refusals():
    with pytest.raises(ValueError, match="even"):
        next(fastq.iter_fastq_batches(FQ, batch_reads=3, max_len=12))
    with pytest.raises(ValueError, match="positive"):
        next(fastq.iter_fastq_batches(FQ, batch_reads=0, max_len=12,
                                      paired=False))


def test_write_fasta_matches_reference():
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 5, n).astype(np.uint8) for n in (0, 7, 30)]
    want = jfastq.write_fasta(seqs, names=["a", "b", "c"])
    assert fastq.write_fasta(seqs, names=["a", "b", "c"]) == want
    assert fastq.write_fasta([torch.from_numpy(s) for s in seqs]) == \
        jfastq.write_fasta(seqs)
