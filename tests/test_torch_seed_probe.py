"""Port alignment front half against the JAX reference.

`repro_torch.kernels.ref.seed_probe_ref` against
`repro.kernels.ref.seed_probe_ref` on the reference's own seed index
(carried over by `repro_torch.bridge`), and the port's `build_seed_index`
and `align_reads` against `repro.core.alignment`: seed lengths 15/16/17/27,
read counts 1/7/9, a saturated 16-slot index, ragged reads with N bases.
Tolerance: exact — every lane, unplaced reads' orient lanes included.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core import alignment as jal
from repro.core.types import ContigSet as JContigSet, ReadSet as JReadSet
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core import alignment
from repro_torch.core.types import ContigSet, ReadSet
from repro_torch.kernels import ref

LANES = ("contig", "cstart", "orient")


def _fixture(seed, *, C=4, clen=120, R=33, L=80, seed_len=21,
             capacity=1 << 12, n_frac=0.02):
    """Contigs (one repeated stretch, so multi seeds exist) + ragged,
    N-sprinkled reads sampled from them, half reverse-complemented."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=(C, clen)).astype(np.uint8)
    genome[1 % C, 10:50] = genome[0, 30:70]
    bases = np.full((R, L), 4, np.uint8)
    for r in range(R):
        c, s = rng.integers(0, C), rng.integers(0, max(1, clen - L + 1))
        w = genome[c, s:s + L].copy()
        if rng.random() < 0.5:
            w = (3 - w)[::-1]
        bases[r, :len(w)] = w
    bases[rng.random((R, L)) < n_frac] = 4
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    lengths[: R // 2] = L
    jreads = JReadSet(jnp.asarray(bases), jnp.asarray(lengths),
                      jnp.full((R,), -1, jnp.int32), 0)
    jcontigs = JContigSet(jnp.asarray(genome),
                          jnp.full((C,), clen, jnp.int32),
                          jnp.ones((C,), jnp.float32))
    jindex = jal.build_seed_index(jcontigs, jnp.ones((C,), bool),
                                  seed_len=seed_len, capacity=capacity,
                                  backend="ref")
    return jreads, jcontigs, jindex


def _args(reads, index):
    t = index.table
    return (reads.bases, reads.lengths, t.slot_hi, t.slot_lo, t.used,
            t.max_probe, index.contig, index.pos, index.flip, index.multi)


def _probe_both(jreads, jindex, seed_len, *, pallas=False):
    positions = tuple(jal._seed_positions(jreads.max_len, seed_len, 16))
    kw = dict(seed_len=seed_len, positions=positions)
    if pallas:
        want = jops.seed_probe(*_args(jreads, jindex), backend="pallas",
                               **kw)
    else:
        want = jref.seed_probe_ref(*_args(jreads, jindex), **kw)
    got = ref.seed_probe_ref(
        *_args(bridge.to_torch(jreads, ReadSet),
               bridge.to_torch(jindex, alignment.SeedIndex)), **kw)
    for g, w, name in zip(got, want, LANES):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    return got


@pytest.mark.parametrize("seed_len", [15, 16, 17, 27])
def test_seed_probe_ref_across_lane_split(seed_len):
    jreads, _, jindex = _fixture(seed_len * 13, seed_len=seed_len)
    got = _probe_both(jreads, jindex, seed_len)
    assert int((got[0][:, 0] >= 0).sum()) > 0, "fixture must place reads"
    assert int((got[0][:, 0] < 0).sum()) > 0, "and leave some unplaced"


@pytest.mark.parametrize("R", [1, 7, 9])
def test_seed_probe_ref_read_counts(R):
    jreads, _, jindex = _fixture(R * 31, R=R)
    got = _probe_both(jreads, jindex, 21)
    assert tuple(got[0].shape) == (R, 2)


def test_seed_probe_ref_saturated_index():
    """capacity=16: probe chains wrap, most seeds collide into `multi`."""
    jreads, _, jindex = _fixture(99, capacity=16)
    _probe_both(jreads, jindex, 21)


def test_seed_probe_ref_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode) on one small batch."""
    jreads, _, jindex = _fixture(5, R=8, seed_len=17)
    _probe_both(jreads, jindex, 17, pallas=True)


@pytest.mark.parametrize("seed_len,capacity", [(21, 1 << 12), (27, 1 << 12),
                                               (21, 64)])
def test_build_seed_index_matches_reference(seed_len, capacity):
    """Table and all four side arrays, multi slots included: the
    representative of a repeated seed is its first row in (key, position)
    order, as the reference's stable sort gives (pinned below)."""
    jreads, jcontigs, jindex = _fixture(7 + seed_len, seed_len=seed_len,
                                        capacity=capacity)
    contigs = bridge.to_torch(jcontigs, ContigSet)
    got = bridge.to_numpy(alignment.build_seed_index(
        contigs, contigs.lengths > 0, seed_len=seed_len, capacity=capacity))
    assert np.asarray(jindex.multi).any()
    for f in ("contig", "pos", "flip", "multi"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jindex, f)),
                                      err_msg=f)
    for f in ("slot_hi", "slot_lo", "used", "max_probe"):
        np.testing.assert_array_equal(got["table"][f],
                                      np.asarray(getattr(jindex.table, f)),
                                      err_msg=f)


def test_reference_sort_is_stable():
    """`lax.sort` keeps equal keys in input order on this backend, which is
    what lets the port's stable torch.sort pick the same representatives."""
    rng = np.random.default_rng(0)
    n = 50_000
    hi = jnp.asarray(rng.integers(0, 3, n).astype(np.uint32))
    lo = jnp.asarray(rng.integers(0, 3, n).astype(np.uint32))
    a, b, p = (np.asarray(x) for x in jax.lax.sort(
        (hi, lo, jnp.arange(n, dtype=jnp.int32)), num_keys=2))
    same = (a[1:] == a[:-1]) & (b[1:] == b[:-1])
    assert (p[1:][same] > p[:-1][same]).all()


@pytest.mark.parametrize("seed_len", [17, 27])
def test_align_reads_matches_reference(seed_len):
    jreads, jcontigs, jindex = _fixture(40 + seed_len, seed_len=seed_len)
    want = jal.align_reads(jreads, jcontigs, jindex, seed_len=seed_len,
                           backend="ref")
    got = alignment.align_reads(
        bridge.to_torch(jreads, ReadSet), bridge.to_torch(jcontigs, ContigSet),
        bridge.to_torch(jindex, alignment.SeedIndex), seed_len=seed_len)
    for f in alignment.Alignments._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.contig[:, 0] >= 0).any()
