"""`ops.sw_extend` and gapped `align_reads` of the port against the JAX
reference, on the CPU (the plain version; the CUDA kernel is held to it on
the card in tests/test_torch_kernels_cuda.py).

The reference has two versions of the banded extension DP: the dense
`repro.kernels.ref.sw_extend_ref`, which its `ops` dispatch runs off the
TPU, and the Pallas kernel.  The port computes what the dense version
computes, in the kernel's band form.  The two reference versions differ
where a row's best path takes two or more left gaps in a row: the Pallas
kernel's in-row scan shifts by one cell each round, so such a run scores
below the dense DP (ROADMAP.md Queue 3; pinned by
`test_pallas_left_gap_chain_differs`).  Tolerance: exact, all three outputs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import alignment as jalignment
from repro.core.types import ContigSet as JContigSet, ReadSet as JReadSet
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sw_extend import sw_extend as pallas_sw_extend
from repro_torch import bridge
from repro_torch.core import alignment
from repro_torch.core.types import ContigSet, ReadSet
from repro_torch.kernels import ops
from test_seed_probe_parity import _fixture

OUTPUTS = ("best_score", "best_qpos", "best_tpos")


def _indel_targets(rng, q, TL):
    """Targets made from each query by three random edits (substitution,
    deletion or insertion), then random bases: tests/test_kernels.py."""
    B, QL = q.shape
    t = np.zeros((B, TL), np.uint8)
    for b in range(B):
        seq = list(q[b, : QL - 4])
        for _ in range(3):
            p = rng.integers(0, len(seq))
            op = rng.integers(0, 3)
            if op == 0:
                seq[p] = rng.integers(0, 4)
            elif op == 1 and len(seq) > 10:
                del seq[p]
            else:
                seq.insert(p, rng.integers(0, 4))
        t[b] = (seq + list(rng.integers(0, 4, TL)))[:TL]
    return t


def _port(q, t, qlen, tlen, band):
    got = ops.sw_extend(*(torch.from_numpy(np.ascontiguousarray(x))
                          for x in (q, t, qlen, tlen)), band=band)
    assert all(g.dtype == torch.int32 and g.shape == (len(q),) for g in got)
    return [g.numpy() for g in got]


def _dense(q, t, qlen, tlen, band):
    return [np.asarray(x) for x in jref.sw_extend_ref(
        *(jnp.asarray(x) for x in (q, t, qlen, tlen)), band=band)]


def _pallas(q, t, qlen, tlen, band):
    return [np.asarray(x) for x in pallas_sw_extend(
        *(jnp.asarray(x) for x in (q, t, qlen, tlen)), band=band,
        interpret=True)]


def _eq(got, want, what):
    for g, w, name in zip(got, want, OUTPUTS):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("band", [7, 15])
@pytest.mark.parametrize("QL,TL", [(32, 40), (64, 64)])
def test_sw_extend_matches_dense_ref_and_pallas(band, QL, TL):
    """tests/test_kernels.py's indel fixture: all three outputs."""
    rng = np.random.default_rng(band + QL)
    B = 8
    q = rng.integers(0, 4, size=(B, QL)).astype(np.uint8)
    t = _indel_targets(rng, q, TL)
    qlen = np.full((B,), QL, np.int32)
    tlen = np.full((B,), TL, np.int32)
    got = _port(q, t, qlen, tlen, band)
    _eq(got, _dense(q, t, qlen, tlen, band), "dense ref")
    _eq(got, _pallas(q, t, qlen, tlen, band), "pallas (interpret)")
    assert (got[0] > QL // 2).all()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("band", [7, 15])
@pytest.mark.parametrize("QL,TL", [(32, 40), (64, 64), (40, 20)])
def test_sw_extend_ragged_lengths_match_dense_ref(seed, band, QL, TL):
    """Indels, ragged live lengths (zero included) and QL > TL."""
    rng = np.random.default_rng(1000 * seed + 10 * band + QL)
    B = 9
    q = rng.integers(0, 4, size=(B, QL)).astype(np.uint8)
    t = _indel_targets(rng, q, TL)
    t[rng.random((B, TL)) < 0.03] = 4
    qlen = rng.integers(0, QL + 1, size=B).astype(np.int32)
    tlen = rng.integers(0, TL + 1, size=B).astype(np.int32)
    qlen[0], tlen[0], qlen[1], tlen[2] = QL, TL, 0, 0
    got = _port(q, t, qlen, tlen, band)
    _eq(got, _dense(q, t, qlen, tlen, band), f"seed {seed}")
    assert got[0][1] == got[0][2] == 0 and got[1][1] == 0


@pytest.mark.parametrize("B", [1, 9])
def test_sw_extend_awkward_batches(B):
    """tests/test_seed_probe_parity.py's awkward batches (B = 1 and one
    past the Pallas tile) with an empty row: against the reference's
    `ops.sw_extend` on both of its backends."""
    rng = np.random.default_rng(B * 17)
    QL, TL = 24, 32
    q = rng.integers(0, 4, size=(B, QL)).astype(np.uint8)
    t = np.concatenate([q, rng.integers(0, 4, (B, TL - QL))],
                       axis=1).astype(np.uint8)
    t[rng.random((B, TL)) < 0.1] = rng.integers(0, 4)
    qlen = np.full((B,), QL, np.int32)
    tlen = np.full((B,), TL, np.int32)
    qlen[0] = 0
    got = _port(q, t, qlen, tlen, 7)
    args = tuple(jnp.asarray(x) for x in (q, t, qlen, tlen))
    for backend in ("ref", "pallas"):
        _eq(got, [np.asarray(x) for x in jops.sw_extend(
            *args, band=7, backend=backend)], backend)
    assert got[0][0] == 0


def _dense_rows(q, t, ql, tl, band):
    """Row maxima and their first columns of one alignment's banded DP
    (plain Python, the recurrence of the reference's dense version)."""
    neg = -(1 << 20)
    prev = [j * -1 if j <= min(tl, band) else neg
            for j in range(len(t) + 1)]
    rows = []
    for ii in range(1, len(q) + 1):
        row = [neg] * (len(t) + 1)
        for j in range(len(t) + 1):
            if j == 0:
                v = -ii if ii <= band else neg
            else:
                s = 1 if (q[ii - 1] == t[j - 1] and q[ii - 1] < 4) else -1
                v = max(prev[j - 1] + s, prev[j] - 1, row[j - 1] - 1)
            row[j] = v
        row = [v if (ii <= ql and j <= tl and abs(ii - j) <= band) else neg
               for j, v in enumerate(row)]
        m = max(row)
        rows.append((m, row.index(m), row.count(m)))
        prev = row
    return rows


def test_sw_extend_tie_breaks():
    """A row with several maximal cells takes the first; a later row that
    only equals the best does not replace it.  Alignments with each
    property are picked from random two-letter pairs by a plain-Python
    DP, then held against the reference."""
    rng = np.random.default_rng(5)
    B, QL, TL, band = 400, 12, 12, 7
    q = rng.integers(0, 2, size=(B, QL)).astype(np.uint8)
    t = rng.integers(0, 2, size=(B, TL)).astype(np.uint8)
    qlen = np.full((B,), QL, np.int32)
    tlen = np.full((B,), TL, np.int32)
    in_row_tie = later_equal = 0
    for b in range(B):
        rows = _dense_rows(q[b], t[b], QL, TL, band)
        best = max(m for m, _, _ in rows)
        first = next(i for i, (m, _, _) in enumerate(rows) if m == best)
        in_row_tie += best > 0 and rows[first][2] > 1
        later_equal += best > 0 and any(m == best for m, _, _ in
                                        rows[first + 1:])
    assert in_row_tie >= 10 and later_equal >= 10, (in_row_tie, later_equal)
    got = _port(q, t, qlen, tlen, band)
    _eq(got, _dense(q, t, qlen, tlen, band), "dense ref")
    for b in range(B):
        rows = _dense_rows(q[b], t[b], QL, TL, band)
        best = max(max(m for m, _, _ in rows), 0)
        if best > 0:
            ii = next(i for i, (m, _, _) in enumerate(rows) if m == best)
            want = (best, ii + 1, rows[ii][1])
        else:
            want = (0, 0, 0)
        assert tuple(int(x[b]) for x in got) == want, b


def test_pallas_left_gap_chain_differs():
    """The divergence of the reference's Pallas kernel, pinned (ROADMAP.md
    Queue 3): seed 5 of the indel fixture, band 15, (QL, TL) = (32, 40),
    row 5 holds two adjacent target insertions; the dense DP scores it
    (24, 28, 30), the Pallas kernel (23, 28, 30).  The port follows the
    dense DP, which the reference's `ops` runs off the TPU."""
    QL, TL, band = 32, 40, 15
    rng = np.random.default_rng(5 * 100 + band + QL)
    q = rng.integers(0, 4, size=(8, QL)).astype(np.uint8)
    t = _indel_targets(rng, q, TL)
    qlen = np.full((8,), QL, np.int32)
    tlen = np.full((8,), TL, np.int32)
    got = _port(q, t, qlen, tlen, band)
    dense = _dense(q, t, qlen, tlen, band)
    pallas = _pallas(q, t, qlen, tlen, band)
    _eq(got, dense, "dense ref")
    assert [int(x[5]) for x in dense] == [24, 28, 30]
    assert [int(x[5]) for x in pallas] == [23, 28, 30]
    same = np.ones(8, bool)
    same[5] = False
    _eq([g[same] for g in got], [p[same] for p in pallas], "pallas")


def test_sw_extend_plain_backend_on_cpu():
    q = torch.zeros((2, 8), dtype=torch.uint8)
    n = torch.full((2,), 8, dtype=torch.int32)
    a = ops.sw_extend(q, q, n, n)
    b = ops.sw_extend(q, q, n, n, backend="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].tolist() == [8, 8]
    with pytest.raises(ValueError, match="backend"):
        ops.sw_extend(q, q, n, n, backend="pallas")


# ---------------------------------------------------------------------------
# align_reads(gapped=True)
# ---------------------------------------------------------------------------


def _port_align(jreads, jcontigs, jindex, **kw):
    reads = ReadSet(*(bridge.tensor(np.asarray(getattr(jreads, f)))
                      for f in ("bases", "lengths", "mate")),
                    jreads.insert_size)
    contigs = bridge.to_torch(jcontigs, ContigSet)
    index = bridge.to_torch(jindex, alignment.SeedIndex)
    return alignment.align_reads(reads, contigs, index, **kw)


def _eq_alignments(got, want):
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("gapped", [True, False])
def test_align_reads_matches_reference(gapped):
    """tests/test_seed_probe_parity.py's fixture (reads sampled from the
    contigs, half reverse-complemented, Ns, ragged lengths)."""
    jreads, jcontigs, jindex = _fixture(7, n_frac=0.01)
    want = jalignment.align_reads(jreads, jcontigs, jindex, seed_len=21,
                                  gapped=gapped)
    got = _port_align(jreads, jcontigs, jindex, seed_len=21, gapped=gapped)
    _eq_alignments(got, want)
    assert (np.asarray(want.contig)[:, 0] >= 0).sum() > 10


def _floor_fixture(extra_mismatch: bool):
    """Reads whose gapped score is the acceptance floor (2*0.9 - 1) * ov
    exactly (or 2 below it), for overlaps ov = 40, 45, ..., 80.

    Each read is a contig window with substitutions at every other base
    near its start, each by a base that none of its neighbours holds (so
    no gapped path beats the diagonal, which ends on the last base); an
    odd overlap starts one base before the contig (cstart -1), whose
    mismatch moves the score's parity."""
    rng = np.random.default_rng(23)
    C, clen, L = 4, 120, 81
    genome = rng.integers(0, 4, size=(C, clen)).astype(np.uint8)
    overlaps = list(range(40, 81, 5))
    bases = np.full((len(overlaps), L), 4, np.uint8)
    lengths = np.zeros(len(overlaps), np.int32)
    for r, ov in enumerate(overlaps):
        h = ov % 2
        c = r % C
        s = 0 if h else 30
        row = np.concatenate([rng.integers(0, 4, h).astype(np.uint8),
                              genome[c, s:s + ov]])
        mm = (ov - h - 4 * ov // 5) // 2 + int(extra_mismatch)
        for p in range(h + 1, h + 1 + 2 * mm, 2):
            near = set(row[p - 1:p + 2].tolist())
            row[p] = min(set(range(4)) - near)
        bases[r, :len(row)] = row
        lengths[r] = len(row)
    reads = JReadSet(bases=jnp.asarray(bases), lengths=jnp.asarray(lengths),
                     mate=jnp.full((len(overlaps),), -1, jnp.int32),
                     insert_size=0)
    contigs = JContigSet(bases=jnp.asarray(genome),
                         lengths=jnp.full((C,), clen, jnp.int32),
                         depths=jnp.ones((C,), jnp.float32))
    index = jalignment.build_seed_index(contigs, jnp.ones((C,), bool),
                                        seed_len=21, capacity=1 << 12)
    return reads, contigs, index, np.asarray(overlaps)


@pytest.mark.parametrize("extra_mismatch", [False, True])
def test_gapped_floor_at_multiples_of_five(extra_mismatch):
    """Scores exactly at the float32 floor are kept, two below are not,
    as in the reference (tests the float32 floor of the gapped branch)."""
    jreads, jcontigs, jindex, overlaps = _floor_fixture(extra_mismatch)
    want = jalignment.align_reads(jreads, jcontigs, jindex, seed_len=21,
                                  gapped=True)
    got = _port_align(jreads, jcontigs, jindex, seed_len=21, gapped=True)
    _eq_alignments(got, want)
    ov = np.asarray(want.overlap)[:, 0]
    score = np.asarray(want.matches)[:, 0]
    np.testing.assert_array_equal(ov, overlaps)
    floor = 4 * overlaps // 5
    np.testing.assert_array_equal(score, floor - 2 * int(extra_mismatch))
    kept = np.asarray(want.contig)[:, 0] >= 0
    assert (kept == (not extra_mismatch)).all()
