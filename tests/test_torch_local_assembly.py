"""Local assembly (§II-G), module by module: the port's
`core.local_assembly` against `repro.core.local_assembly` on the same
inputs, and on the reference's own walk tables through `bridge`.

Fixture, made with numpy: a two-genome community's reads, contigs cut from
the genomes (one reverse-complemented, one shorter than the top rung so
its walks are disabled, one dead), and each read's contig from an exact
substring search (either strand), as an aligner would place it.
Tolerance: exact, every lane, table slot and histogram count.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import local_assembly as jla
from repro.core.types import ContigSet as JContigSet
from repro.data import mgsim as jmgsim
from repro_torch import bridge
from repro_torch.core import local_assembly
from repro_torch.core.local_assembly import WalkResult, WalkTables
from repro_torch.core.types import ContigSet, ReadSet

RC = np.array([3, 2, 1, 0, 4], np.uint8)
LADDERS = [(13, 17, 21), (17, 21, 25)]


def _contig_set(pieces, C, Lmax, alive_n):
    bases = np.full((C, Lmax), 4, np.uint8)
    lengths = np.zeros(C, np.int32)
    for i, p in enumerate(pieces):
        bases[i, :len(p)] = p
        lengths[i] = len(p)
    depths = np.linspace(1, 9, C).astype(np.float32)
    alive = np.arange(C) < alive_n
    return (JContigSet(jnp.asarray(bases), jnp.asarray(lengths),
                       jnp.asarray(depths)),
            ContigSet(*map(bridge.tensor, (bases, lengths, depths))),
            alive)


@pytest.fixture(scope="module")
def fixture():
    comm = jmgsim.sample_community(51, num_genomes=2, genome_len=400,
                                   abundance_sigma=0.2)
    jreads, _ = jmgsim.generate_reads(52, comm, num_pairs=400, read_len=60,
                                      err_rate=0.003)
    g0, g1 = (np.asarray(g) for g in comm.genomes)
    pieces = [g0[40:260], g0[300:380], RC[g1[20:200][::-1]], g1[250:270],
              g1[220:330], g0[0:100]]
    jc, c, alive = _contig_set(pieces, C=16, Lmax=512, alive_n=5)
    text = [p.tobytes() for p in pieces[:5]]
    bases = np.asarray(jreads.bases)
    lengths = np.asarray(jreads.lengths)
    aln = np.full(jreads.num_reads, -1, np.int32)
    for r in range(jreads.num_reads):
        s = bases[r, :lengths[r]]
        for i, t in enumerate(text):
            if s.tobytes() in t or RC[s[::-1]].tobytes() in t:
                aln[r] = i
                break
    assert (aln >= 0).mean() > 0.3
    reads = ReadSet(bridge.tensor(bases), bridge.tensor(lengths),
                    bridge.tensor(np.asarray(jreads.mate)),
                    jreads.insert_size)
    return dict(jreads=jreads, reads=reads, jcontigs=jc, contigs=c,
                alive=alive, aln=aln)


def _eq(got, want, what):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _eq_tables(wt, jwt):
    for r, (t, jt) in enumerate(zip(wt.tables, jwt.tables)):
        for f in jt._fields:
            _eq(getattr(t, f), getattr(jt, f), f"rung {r} table.{f}")
        _eq(wt.right_hist[r], jwt.right_hist[r], f"rung {r} right_hist")
        _eq(wt.left_hist[r], jwt.left_hist[r], f"rung {r} left_hist")


def test_localize_reads(fixture):
    f = fixture
    want = jla.localize_reads(f["jreads"], jnp.asarray(f["aln"]))
    got = local_assembly.localize_reads(f["reads"],
                                        bridge.tensor(f["aln"]))
    _eq(got, want, "read_contig")
    assert (np.asarray(want) >= 0).sum() > (f["aln"] >= 0).sum()


@pytest.mark.parametrize("mer_sizes", LADDERS)
def test_build_walk_tables(fixture, mer_sizes):
    f = fixture
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    rc = jla.localize_reads(f["jreads"], jnp.asarray(f["aln"]))
    jwt = jla.build_walk_tables(f["jreads"], rc, mer_sizes=mer_sizes,
                                tag_bits=tag_bits, capacity=1 << 13)
    wt = local_assembly.build_walk_tables(
        f["reads"], bridge.tensor(np.asarray(rc)), mer_sizes=mer_sizes,
        tag_bits=tag_bits, capacity=1 << 13)
    _eq_tables(wt, jwt)
    assert int(jwt.right_hist[1].sum()) > 1000


def _tensors(wt):
    return [a for t in wt.tables for a in t] + list(wt.right_hist) + \
        list(wt.left_hist)


def test_accumulate_walk_tables_two_batches(fixture):
    """Two read batches folded one after the other equal the reference's
    fold, and the input tables are left as they were (a pure function)."""
    f = fixture
    mer_sizes = (13, 17, 21)
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    rc = np.asarray(jla.localize_reads(f["jreads"], jnp.asarray(f["aln"])))
    half = f["jreads"].num_reads // 2
    jwt = jla.empty_walk_tables(mer_sizes=mer_sizes, capacity=1 << 13)
    wt = local_assembly.empty_walk_tables(mer_sizes=mer_sizes,
                                          capacity=1 << 13)
    for sl in (slice(0, half), slice(half, None)):
        jbatch = f["jreads"]._replace(bases=f["jreads"].bases[sl],
                                      lengths=f["jreads"].lengths[sl],
                                      mate=f["jreads"].mate[sl])
        batch = ReadSet(f["reads"].bases[sl], f["reads"].lengths[sl],
                        f["reads"].mate[sl], f["reads"].insert_size)
        before = [t.clone() for t in _tensors(wt)]
        jwt = jla.accumulate_walk_tables(
            jwt, jbatch, jnp.asarray(rc[sl]), mer_sizes=mer_sizes,
            tag_bits=tag_bits)
        new = local_assembly.accumulate_walk_tables(
            wt, batch, bridge.tensor(rc[sl]), mer_sizes=mer_sizes,
            tag_bits=tag_bits)
        assert all(torch.equal(a, b) for a, b in zip(_tensors(wt), before))
        wt = new
        _eq_tables(wt, jwt)
    assert int(jwt.right_hist[0].sum()) > 1000


def test_contig_end_buffers(fixture):
    f = fixture
    want = jla.contig_end_buffers(f["jcontigs"], jnp.asarray(f["alive"]))
    got = local_assembly.contig_end_buffers(f["contigs"],
                                            bridge.tensor(f["alive"]))
    for g, w, name in zip(got, want, ("hi", "lo", "active")):
        _eq(g, w, name)


def _walk_tables(f, mer_sizes):
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    rc = jla.localize_reads(f["jreads"], jnp.asarray(f["aln"]))
    return jla.build_walk_tables(f["jreads"], rc, mer_sizes=mer_sizes,
                                 tag_bits=tag_bits, capacity=1 << 13)


@pytest.mark.parametrize("mer_sizes", LADDERS)
def test_extend_with_reference_tables(fixture, mer_sizes):
    f = fixture
    jwt = _walk_tables(f, mer_sizes)
    jext, jwalk = jla.extend_with_tables(
        jwt, f["jcontigs"], jnp.asarray(f["alive"]), mer_sizes=mer_sizes,
        max_ext=64)
    ext, walk = local_assembly.extend_with_tables(
        bridge.to_torch(jwt, WalkTables), f["contigs"],
        bridge.tensor(f["alive"]), mer_sizes=mer_sizes, max_ext=64)
    for name in WalkResult._fields:
        _eq(getattr(walk, name), getattr(jwalk, name), f"walk.{name}")
    for name in ContigSet._fields:
        _eq(getattr(ext, name), getattr(jext, name), f"contigs.{name}")
    assert int(walk.ext_len.sum()) > 20, "fixture must extend"


def test_extend_contigs(fixture):
    f = fixture
    kw = dict(mer_sizes=(17, 21, 25), capacity=1 << 13, max_ext=64)
    jext, jwalk = jla.extend_contigs(f["jreads"], f["jcontigs"],
                                     jnp.asarray(f["alive"]),
                                     jnp.asarray(f["aln"]), **kw)
    ext, walk = local_assembly.extend_contigs(
        f["reads"], f["contigs"], bridge.tensor(f["alive"]),
        bridge.tensor(f["aln"]), **kw)
    for name in ContigSet._fields:
        _eq(getattr(ext, name), getattr(jext, name), f"contigs.{name}")
    for name in WalkResult._fields:
        _eq(getattr(walk, name), getattr(jwalk, name), f"walk.{name}")


def test_apply_extensions_truncates_at_lmax():
    """Contigs near the buffer width: grafted lengths stop at Lmax."""
    rng = np.random.default_rng(5)
    C, Lmax, max_ext = 6, 128, 16
    pieces = [rng.integers(0, 4, size=n).astype(np.uint8)
              for n in (100, 120, 127, 128, 40, 90)]
    jc, c, alive = _contig_set(pieces, C=C, Lmax=Lmax, alive_n=5)
    ext = rng.integers(0, 4, size=(2 * C, max_ext)).astype(np.uint8)
    ext_len = rng.integers(0, max_ext + 1, size=2 * C).astype(np.int32)
    ext_len[[2, 2 + C]] = max_ext
    for i, n in enumerate(ext_len):
        ext[i, n:] = 4
    status = np.zeros(2 * C, np.int32)
    jwalk = jla.WalkResult(jnp.asarray(ext), jnp.asarray(ext_len),
                           jnp.asarray(status))
    walk = WalkResult(*map(bridge.tensor, (ext, ext_len, status)))
    want = jla.apply_extensions(jc, jnp.asarray(alive), jwalk)
    got = local_assembly.apply_extensions(c, bridge.tensor(alive), walk)
    for name in ContigSet._fields:
        _eq(getattr(got, name), getattr(want, name), name)
    assert int(got.lengths[2]) == Lmax and int(got.lengths[3]) == Lmax
