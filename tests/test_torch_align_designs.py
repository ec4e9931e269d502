"""The arithmetic of the sw_extend and seed_probe kernels, held on the CPU.

Both CUDA kernels (`repro_torch/kernels/csrc/sw_extend.cu`,
`csrc/seed_probe.cu`) run only on the card.  Here a numpy model of each
design, step for step as the kernel takes it, is held to the JAX reference:

* sw_extend: one alignment at a time (a thread each).  The 2 band + 1
  cells of a row are updated in offset order: diag + sub against up + gap,
  then the left gap as a running max, c[o] = max(c[o], c[o-1] + gap); the
  substitution is a one-hot mask for the row's query base, made from three
  bit planes of the target window (the base's two bits, base < 4) shifted
  one place a row with one target base brought in; rows stop at
  min(QL, qlen, tlen + band), and rows whose band lies inside [0, tlen]
  skip the validity masks.  The row's first maximum is the max of
  c * 32 + 31 - o (keyed), or the best is tracked cell by cell in row
  order (the chain, for weights too large for the key); a strictly
  greater score replaces the best.  Both held to the dense
  `repro.kernels.ref.sw_extend_ref`, all three outputs.
* seed_probe: a group of G lanes a read (G the power of two >= S), one
  lane a seed: each lane packs its seed four bases a word (unmasked OR),
  canonicalizes and probes; the vote is match-any on (cstart, contig) and
  orient within the group, the support its popcount for a placed seed;
  best and second best are a butterfly max over the group of
  (support << 5 | 31 - seed).  Held to `repro.kernels.ref.seed_probe_ref`
  over a seed index that the reference built, every lane.

Tolerance: exact.  Numpy, a few JAX calls: a few seconds.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.types import ReadSet as JReadSet
from repro.kernels import ref as jref
from test_torch_kernel_designs import M32, _hash, _reverse_complement
from test_torch_seed_probe import _args, _fixture

NEG = -(1 << 20)

# ---------------------------------------------------------------- sw_extend


def model_sw_one(q, t, qlen, tlen, band, keyed, match=1, mismatch=-1,
                 gap=-1):
    """One alignment as one thread of the kernel takes it."""
    QL, TL = len(q), len(t)
    W = 2 * band + 1
    stop = min(QL, qlen, tlen + band)
    best = best_row = best_off = 0
    if stop <= 0:
        return 0, 0, 0
    h = [(o - band) * gap if 0 <= o - band <= min(tlen, band) else NEG
         for o in range(W)]
    planes = [0, 0, 0]  # the base's bit 0, bit 1, base < 4

    def put(base, bit):
        for i, on in enumerate((base & 1, (base >> 1) & 1, base < 4)):
            planes[i] |= int(on) << bit

    for c in range(min(band, TL)):  # row 1's offsets band+1 .. 2 band
        put(int(t[c]), c + band + 1)
    for ii in range(1, stop + 1):
        planes = [m >> 1 for m in planes]
        c = ii + band - 1
        put(int(t[c]) if c < TL else 4, W - 1)
        qb = int(q[ii - 1])
        lo, hi, ok = planes
        full = (1 << 32) - 1
        qlo, qhi = -(qb & 1) & full, -((qb >> 1) & 1) & full
        hit = ok & ~(lo ^ qlo) & ~(hi ^ qhi) if qb < 4 else 0
        masked = not band < ii <= tlen - band
        j0_off, last_off = band - ii, tlen - ii + band
        row_start, left, key = best, 0, -(1 << 31)
        for o in range(W):
            sub = match if (hit >> o) & 1 else mismatch
            up = (h[o + 1] if o + 1 < W else NEG) + gap
            cell = max(h[o] + sub, up)
            if masked and o == j0_off:
                cell = ii * gap
            if o > 0:
                cell = max(left + gap, cell)
            left = cell
            if masked and (o < j0_off or o > last_off):
                cell = NEG
            h[o] = cell
            if keyed:
                key = max(key, cell * 32 + 31 - o)
                assert -(1 << 31) < cell * 32 < 1 << 31
            elif cell > best:
                best, best_off = cell, o
        if keyed and key >> 5 > best:
            best, best_off, best_row = key >> 5, 31 - (key & 31), ii
        if not keyed and best != row_start:
            best_row = ii
    if best <= 0:
        return 0, 0, 0
    return best, best_row, best_row - band + best_off


def _sw_inputs(rng, B, QL, TL, indels):
    q = rng.integers(0, 4, size=(B, QL)).astype(np.uint8)
    if indels:  # each target: its query with 3 edits, then random bases
        t = np.zeros((B, TL), np.uint8)
        for b in range(B):
            seq = list(q[b])
            for _ in range(3):
                p = rng.integers(0, len(seq))
                op = rng.integers(0, 3)
                if op == 0:
                    seq[p] = rng.integers(0, 4)
                elif op == 1:
                    del seq[p]
                else:
                    seq.insert(p, rng.integers(0, 4))
            t[b] = (seq + list(rng.integers(0, 4, TL)))[:TL]
    else:
        t = rng.integers(0, 4, size=(B, TL)).astype(np.uint8)
    t[rng.random((B, TL)) < 0.02] = 4
    q[rng.random((B, QL)) < 0.02] = 4
    qlen = rng.integers(0, QL + 1, size=B).astype(np.int32)
    tlen = rng.integers(0, TL + 1, size=B).astype(np.int32)
    qlen[: (B + 1) // 2], tlen[: (B + 1) // 2] = QL, TL
    qlen[-1] = 0  # no candidate
    if B > 2:  # a query past the band's reach: rows stop at tlen + band
        qlen[-2], tlen[-2] = QL, max(0, min(TL, QL - 8) - 8)
    return q, t, qlen, tlen


@pytest.mark.parametrize("indels", [False, True])
@pytest.mark.parametrize("B,QL,TL", [(1, 32, 40), (37, 40, 20), (3, 150, 150)])
@pytest.mark.parametrize("band", [0, 7, 15])
def test_sw_extend_design_equals_dense_ref(band, B, QL, TL, indels):
    rng = np.random.default_rng(1000 * band + B + QL + indels)
    q, t, qlen, tlen = _sw_inputs(rng, B, QL, TL, indels)
    want = jref.sw_extend_ref(*(jnp.asarray(x) for x in (q, t, qlen, tlen)),
                              band=band)
    for keyed in (True, False):
        got = np.array([model_sw_one(q[b], t[b], int(qlen[b]),
                                     int(tlen[b]), band, keyed)
                        for b in range(B)], np.int32).reshape(B, 3)
        for i, name in enumerate(("best_score", "best_qpos", "best_tpos")):
            np.testing.assert_array_equal(got[:, i], np.asarray(want[i]),
                                          err_msg=f"{name}, keyed={keyed}")
    assert (got[qlen == 0] == 0).all()
    if band and QL == TL == 150:
        assert got[0, 0] > 0


@pytest.mark.parametrize("band", [3, 15])
def test_sw_extend_design_breaks_ties_as_dense_ref(band):
    """Short pairs over two bases: the best score is often reached by
    several cells of a row, and again in later rows; the first in
    row-major order is kept."""
    rng = np.random.default_rng(band)
    B, n = 300, 16
    q = rng.integers(0, 2, size=(B, n)).astype(np.uint8)
    t = rng.integers(0, 2, size=(B, n)).astype(np.uint8)
    full = np.full(B, n, np.int32)
    want = jref.sw_extend_ref(*(jnp.asarray(x) for x in (q, t, full, full)),
                              band=band)
    for keyed in (True, False):
        got = np.array([model_sw_one(q[b], t[b], n, n, band, keyed)
                        for b in range(B)], np.int32).reshape(B, 3)
        for i, name in enumerate(("best_score", "best_qpos", "best_tpos")):
            np.testing.assert_array_equal(got[:, i], np.asarray(want[i]),
                                          err_msg=f"{name}, keyed={keyed}")


# ---------------------------------------------------------------- seed_probe


def model_seed_probe(bases, lengths, table, contig, pos, flip, multi, *,
                     seed_len, positions):
    """The lane-group kernel on [R, G] arrays, a column per lane."""
    slot_hi, slot_lo, used, max_probe = table
    R, L = bases.shape
    S = len(positions)
    G = 1 << (S - 1).bit_length()
    g = np.arange(G)
    live = np.broadcast_to(g < S, (R, G))
    p = np.zeros(G, np.int64)
    p[:S] = positions
    b = bases.astype(np.uint64)
    code = np.zeros((R, G), np.uint64)
    any_n = np.zeros((R, G), bool)
    full = seed_len // 4
    for k in range(full):  # four bases from one 32-bit word
        w = [b[:, p + 4 * k + i] for i in range(4)]
        code = ((code << np.uint64(8)) | (w[0] << np.uint64(6))
                | (w[1] << np.uint64(4)) | (w[2] << np.uint64(2)) | w[3])
        any_n |= np.any([x >= 4 for x in w], axis=0)
    for i in range(4 * full, seed_len):
        x = b[:, p + i]
        code = (code << np.uint64(2)) | x
        any_n |= x >= 4
    code &= np.uint64((1 << (2 * seed_len)) - 1)
    rc = _reverse_complement(code, seed_len)
    rflip = rc < code
    canon = np.where(rflip, rc, code)
    hi = (canon >> np.uint64(32)).astype(np.uint32)
    lo = (canon & M32).astype(np.uint32)
    length = lengths.astype(np.int64)[:, None]
    # the linear probe, every lane at once
    cap = len(used)
    a = (_hash(hi, lo) & np.uint64(cap - 1)).astype(np.int64)
    slot = np.full((R, G), -1, np.int64)
    pending = live & ~any_n & (p + seed_len <= length)
    for _ in range(int(max_probe) + 2):
        u = used[a]
        hit = pending & u & (slot_hi[a] == hi) & (slot_lo[a] == lo)
        slot[hit] = a[hit]
        pending &= u & ~hit
        a = (a + 1) & (cap - 1)
    sl = np.maximum(slot, 0)
    ok = live & (slot >= 0) & ~multi[sl]
    same = rflip == flip[sl]
    co = np.where(live & ~same, 1, 0)
    cc = np.where(ok, contig[sl], -1).astype(np.int64)
    cs = np.where(ok, np.where(same, pos[sl] - p, pos[sl] - (length - p
                                                            - seed_len)), 0)
    # match-any within the group: same (cstart, contig) key and orient
    agree = ((cc[:, :, None] == cc[:, None, :])
             & (cs[:, :, None] == cs[:, None, :])
             & (co[:, :, None] == co[:, None, :]))
    support = np.where(cc >= 0, agree.sum(-1), 0)

    def first_max(value):  # butterfly: each step a __shfl_xor_sync
        k = np.where(live, (value << 5) | (31 - g), -1)
        d = G >> 1
        while d:
            k = np.maximum(k, k[:, g ^ d])
            d >>= 1
        assert (k == k[:, :1]).all()  # every lane of the group agrees
        return k[:, 0]

    rows = np.arange(R)
    k1 = first_max(support)
    best = 31 - (k1 & 31)
    c1, s1, o1 = cc[rows, best], cs[rows, best], co[rows, best]
    k2 = first_max(np.where((cc != c1[:, None]) & (cc >= 0), support, 0))
    best2 = 31 - (k2 & 31)
    c2 = np.where(k2 >> 5 > 0, cc[rows, best2], -1)
    s2, o2 = cs[rows, best2], co[rows, best2]
    return (np.stack([c1, c2], 1).astype(np.int32),
            np.stack([s1, s2], 1).astype(np.int32),
            np.stack([o1, o2], 1).astype(np.uint8)), support


@pytest.fixture(scope="module")
def indexes():
    """Reads of 150 bases and two seed indexes the reference built."""
    out = {}
    for seed_len, capacity in ((21, 1 << 12), (21, 16)):
        out[seed_len, capacity] = _fixture(
            seed_len + capacity, C=4, clen=400, R=40, L=150,
            seed_len=seed_len, capacity=capacity)
    return out


def _chimeras(rng, genome, R, L):
    """Reads whose two halves come from two contigs, at a random split:
    two placements with the same support tie."""
    C, clen = genome.shape
    bases = np.zeros((R, L), np.uint8)
    for r in range(R):
        a, b = rng.choice(C, 2, replace=False)
        cut = rng.integers(L // 3, 2 * L // 3)
        s = rng.integers(0, clen - L)
        bases[r, :cut] = genome[a, s:s + cut]
        bases[r, cut:] = genome[b, s + cut:s + L]
    return bases


# name -> (seed_len, capacity, reads, positions at L = 150)
CASES = {
    "S1": (21, 1 << 12, "sampled", (40,)),
    "S9": (21, 1 << 12, "sampled", tuple(range(0, 130, 16))),
    "S10": (21, 1 << 12, "sampled", tuple(range(0, 130, 16)) + (129,)),
    "S32": (21, 1 << 12, "sampled", tuple(range(0, 128, 4))),
    "ties": (21, 1 << 12, "chimeras", tuple(range(0, 130, 16)) + (129,)),
    "no_hit": (21, 1 << 12, "random", tuple(range(0, 130, 16)) + (129,)),
    "cap16": (21, 16, "sampled", tuple(range(0, 130, 16)) + (129,)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_seed_probe_design_equals_reference(indexes, case):
    seed_len, capacity, kind, positions = CASES[case]
    jreads, jcontigs, jindex = indexes[seed_len, capacity]
    rng = np.random.default_rng(len(case))
    bases = np.asarray(jreads.bases)
    lengths = np.asarray(jreads.lengths)
    if kind == "chimeras":
        bases = _chimeras(rng, np.asarray(jcontigs.bases), len(bases),
                          bases.shape[1])
    elif kind == "random":
        bases = rng.integers(0, 4, size=bases.shape).astype(np.uint8)
    if kind != "sampled":
        jreads = JReadSet(jnp.asarray(bases), jreads.lengths, jreads.mate, 0)
    want = jref.seed_probe_ref(*_args(jreads, jindex), seed_len=seed_len,
                               positions=positions)
    t = jindex.table
    got, support = model_seed_probe(
        bases, lengths, tuple(np.asarray(x) for x in (t.slot_hi, t.slot_lo,
                                                      t.used, t.max_probe)),
        *(np.asarray(x) for x in (jindex.contig, jindex.pos, jindex.flip,
                                  jindex.multi)),
        seed_len=seed_len, positions=positions)
    for g, w, name in zip(got, want, ("contig", "cstart", "orient")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert (lengths < positions[-1] + seed_len).any()  # short reads
    placed = got[0][:, 0] >= 0
    if kind == "random":
        assert not placed.any()
    else:
        assert placed.any()
    if kind == "chimeras":  # a tie between two contigs' placements
        top = support.max(1)
        assert (got[0][:, 1] >= 0).any() and (
            (support == top[:, None]).sum(1) > top).any()
