"""The walk, op level: the port's `ref.mer_walk_ref` (what `ops.mer_walk`
runs on CPU tensors) against JAX `ops.mer_walk` with the Pallas kernel in
interpret mode and with its jnp oracle.

Tables come from the reference's `local_assembly.build_walk_tables` on
reads made with numpy, carried over through `repro_torch.bridge`; walkers
are random 31-base buffers or windows of those reads.  Cases: ladders
(13, 17, 21) and (17, 21, 25); capacities 2**8..2**10, a nearly full
table among them; walker counts that are not multiples of the Pallas
tile (8); max_ext 8 and 64; tied histograms (with dominance 1 a tie at
the top is accepted and the first maximal base must win); a fork-heavy
ladder of tiny mers; the gap-closing variant that stops at a target
seed.  Tolerance: exact, all five outputs.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import kmer as jkmer, local_assembly as jla
from repro.core.types import ReadSet as JReadSet
from repro.data import mgsim as jmgsim
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.core.local_assembly import WalkTables
from repro_torch.kernels import ops

OUTS = ("ext_bases", "ext_len", "status", "hit", "hit_pos")


def _tables(rng, mer_sizes, capacity, *, num_reads, read_len=None,
            n_contigs=8):
    """JAX WalkTables from random reads with random contig assignments,
    its tag bits, and the reads (bases, lengths, contig of each read)."""
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    L = read_len or max(mer_sizes) + 20
    bases = rng.integers(0, 4, size=(num_reads, L)).astype(np.uint8)
    bases[rng.random((num_reads, L)) < 0.02] = 4
    lengths = rng.integers(0, L + 1, size=num_reads).astype(np.int32)
    reads = JReadSet(jnp.asarray(bases), jnp.asarray(lengths),
                     jnp.full((num_reads,), -1, jnp.int32), 0)
    read_contig = jnp.asarray(rng.integers(-1, n_contigs, size=num_reads),
                              jnp.int32)
    wt = jla.build_walk_tables(reads, read_contig, mer_sizes=mer_sizes,
                               tag_bits=tag_bits, capacity=capacity)
    return wt, tag_bits, (bases, lengths, np.asarray(read_contig))


def _walkers(rng, E, src=None, n_contigs=8):
    """E walkers, 80% active.  Random buffers; with the tables' reads
    `src`, half of them start on a 31-base window of one of those reads,
    tagged with its contig, so their first mers are in the tables and the
    walk moves."""
    suffix = rng.integers(0, 4, size=(E, jla.BUF_K)).astype(np.uint8)
    contig = rng.integers(0, n_contigs, size=E).astype(np.int32)
    if src is not None:
        bases, lengths, rc = src
        for i in range(0, E, 2):
            for _ in range(100):
                r = rng.integers(0, len(bases))
                if rc[r] < 0 or lengths[r] < jla.BUF_K:
                    continue
                p = rng.integers(0, lengths[r] - jla.BUF_K + 1)
                w = bases[r, p:p + jla.BUF_K]
                if (w < 4).all():
                    suffix[i], contig[i] = w, rc[r]
                    break
    hi, lo = jkmer.pack_window(jnp.asarray(suffix), k=jla.BUF_K)
    active = rng.random(E) < 0.8
    return [np.asarray(hi), np.asarray(lo), contig, active]


def _walk_all(jwt, walkers, **kw):
    """Port plain version, JAX Pallas (interpret) and JAX ref: all equal.
    Returns the port's output."""
    hi, lo, contig, active = walkers
    jkw = dict(kw)
    tkw = dict(kw)
    if "target_hi" in kw:
        jkw.update(target_hi=jnp.asarray(kw["target_hi"]),
                   target_lo=jnp.asarray(kw["target_lo"]))
        tkw.update(target_hi=bridge.tensor(kw["target_hi"]),
                   target_lo=bridge.tensor(kw["target_lo"]))
    jargs = (jwt, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(contig),
             jnp.asarray(active))
    pallas = jops.mer_walk(*jargs, backend="pallas", **jkw)
    jref = jops.mer_walk(*jargs, backend="ref", **jkw)
    ops.reset_launches()
    got = ops.mer_walk(bridge.to_torch(jwt, WalkTables), bridge.tensor(hi),
                       bridge.tensor(lo), bridge.tensor(contig),
                       bridge.tensor(active), **tkw)
    assert ops.LAUNCHES["mer_walk"] == 0
    for name in OUTS:
        g = getattr(got, name).numpy()
        for label, want in (("pallas", pallas), ("ref", jref)):
            np.testing.assert_array_equal(
                g, np.asarray(getattr(want, name)),
                err_msg=f"{name} vs JAX {label}")
    return got


@pytest.mark.parametrize("mer_sizes,capacity,max_ext,E,num_reads", [
    ((13, 17, 21), 1 << 10, 64, 37, 64),
    ((17, 21, 25), 1 << 9, 8, 13, 64),
    ((17, 21, 25), 1 << 10, 64, 21, 64),
    ((13, 17, 21), 1 << 8, 8, 30, 64),
])
def test_walk_equals_reference(mer_sizes, capacity, max_ext, E, num_reads):
    rng = np.random.default_rng(capacity + max_ext * 7 + E)
    jwt, tag_bits, src = _tables(rng, mer_sizes, capacity,
                                 num_reads=num_reads)
    out = _walk_all(jwt, _walkers(rng, E, src), mer_sizes=mer_sizes,
                    tag_bits=tag_bits, max_ext=max_ext)
    assert (out.ext_len <= max_ext).all() and int(out.ext_len.max()) > 0


@pytest.mark.parametrize("mer_sizes", [(13, 17, 21), (17, 21, 25)])
def test_walk_nearly_full_table(mer_sizes):
    rng = np.random.default_rng(sum(mer_sizes))
    jwt, tag_bits, src = _tables(rng, mer_sizes, 1 << 8, num_reads=60,
                                 read_len=45)
    fill = [float(np.asarray(t.used).mean()) for t in jwt.tables]
    # the middle rung, where every walk starts, is (nearly) full
    assert fill[1] > 0.9, fill
    _walk_all(jwt, _walkers(rng, 45, src), mer_sizes=mer_sizes,
              tag_bits=tag_bits, max_ext=64)


@pytest.mark.parametrize("min_votes,dominance", [(1, 1), (2, 1), (2, 4)])
def test_walk_tied_histograms(min_votes, dominance):
    """Histogram rows overwritten with small counts full of ties; with
    dominance 1 a tie at the top is accepted and the base is the first
    maximal one."""
    rng = np.random.default_rng(10 * min_votes + dominance)
    mer_sizes = (13, 17, 21)
    jwt, tag_bits, src = _tables(rng, mer_sizes, 1 << 9, num_reads=64)
    cap = 1 << 9
    hist = lambda: jnp.asarray(
        rng.choice([0, 0, 1, 2, 2, 3], size=(cap, 4)).astype(np.int32))
    jwt = jwt._replace(right_hist=tuple(hist() for _ in mer_sizes),
                       left_hist=tuple(hist() for _ in mer_sizes))
    out = _walk_all(jwt, _walkers(rng, 29, src), mer_sizes=mer_sizes,
                    tag_bits=tag_bits, max_ext=64, min_votes=min_votes,
                    dominance=dominance)
    assert int(out.ext_len.max()) > 0


def test_walk_fork_heavy_tiny_mers():
    rng = np.random.default_rng(7)
    jwt, tag_bits, src = _tables(rng, (3, 5, 7), 1 << 10, num_reads=64)
    out = _walk_all(jwt, _walkers(rng, 19, src), mer_sizes=(3, 5, 7),
                    tag_bits=tag_bits, max_ext=64)
    assert (out.status.numpy() == 2).any(), "fixture must fork"


def _genome_tables(seed, mer_sizes, capacity):
    genome, reads, _ = jmgsim.single_genome_reads(seed, genome_len=400,
                                                  coverage=25)
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    wt = jla.build_walk_tables(
        reads, jnp.zeros((reads.num_reads,), jnp.int32),
        mer_sizes=mer_sizes, tag_bits=tag_bits, capacity=capacity)
    return np.asarray(genome), wt, tag_bits


@pytest.mark.parametrize("max_ext", [8, 64])
def test_walk_extends_real_contig_end(max_ext):
    """Walkers on a genome's own windows really walk (and max_ext cuts)."""
    mer_sizes = (17, 21, 25)
    genome, jwt, tag_bits = _genome_tables(33, mer_sizes, 1 << 10)
    starts = np.array([60, 100, 141, 200, 250, 251, 300])
    win = np.stack([genome[s:s + jla.BUF_K] for s in starts])
    hi, lo = jkmer.pack_window(jnp.asarray(win), k=jla.BUF_K)
    E = len(starts)
    walkers = [np.asarray(hi), np.asarray(lo), np.zeros(E, np.int32),
               np.ones(E, bool)]
    out = _walk_all(jwt, walkers, mer_sizes=mer_sizes, tag_bits=tag_bits,
                    max_ext=max_ext)
    assert int(out.ext_len.max()) >= min(max_ext, 20), "fixture must walk"


def test_walk_target_stop():
    """Gap-walk variant: targets 10, 25 and 40 bases past the walker, one
    that is never produced, one on an inactive walker."""
    mer_sizes = (17, 21, 25)
    seed_len = 21
    genome, jwt, tag_bits = _genome_tables(34, mer_sizes, 1 << 10)
    start, gaps = 100, [10, 25, 40, 20, 20]
    E = len(gaps)
    win = np.stack([genome[start:start + jla.BUF_K]] * E)
    hi, lo = jkmer.pack_window(jnp.asarray(win), k=jla.BUF_K)
    end = start + jla.BUF_K
    tgt = np.stack([genome[end + g:end + g + seed_len] for g in gaps])
    tgt[3] = (tgt[3] + 1) % 4                # never produced
    t_hi, t_lo = jkmer.pack_window(jnp.asarray(tgt), k=seed_len)
    active = np.array([True, True, True, True, False])
    walkers = [np.asarray(hi), np.asarray(lo), np.zeros(E, np.int32), active]
    out = _walk_all(jwt, walkers, mer_sizes=mer_sizes, tag_bits=tag_bits,
                    max_ext=64, target_hi=np.asarray(t_hi),
                    target_lo=np.asarray(t_lo), seed_len=seed_len)
    hit, pos = out.hit.numpy(), out.hit_pos.numpy()
    assert hit[:3].all() and not hit[3:].any()
    np.testing.assert_array_equal(pos[:3], np.array(gaps[:3]) + seed_len)
    assert (out.status.numpy()[:3] == 4).all()
    assert int(out.status[4]) == 3 and int(out.ext_len[4]) == 0


def test_walk_random_targets_tiny_mers():
    """Random targets of 5-mers over a fork-heavy 3/5/7 table: some
    walkers hit, others stop or run out; all outputs equal."""
    rng = np.random.default_rng(11)
    jwt, tag_bits, src = _tables(rng, (3, 5, 7), 1 << 9, num_reads=48)
    E, seed_len = 27, 5
    tgt = rng.integers(0, 4, size=(E, seed_len)).astype(np.uint8)
    t_hi, t_lo = jkmer.pack_window(jnp.asarray(tgt), k=seed_len)
    _walk_all(jwt, _walkers(rng, E, src), mer_sizes=(3, 5, 7),
              tag_bits=tag_bits,
              max_ext=24, target_hi=np.asarray(t_hi),
              target_lo=np.asarray(t_lo), seed_len=seed_len)
