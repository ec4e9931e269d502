"""CUDA kernels against their plain versions, on the card (marker `cuda`).

Each hand-written kernel (`repro_torch/kernels/csrc/`) is held to its plain
PyTorch version (`repro_torch.kernels.ref`, itself held to the JAX
reference by the other test_torch_* files) at small shapes with the edge
cases of those files, plus the whole `contig_rounds`, `assemble` and
`assemble_stream` on the card against the CPU run, under `Local` and
under `Mesh(2)` (also over an NCCL group of one rank, against the
one-process `Mesh(2)`), a kernel op refusing a tensor off the current
card, the HMM scorer on the card against the CPU, two jobs
interleaved on a `JobServer(Local())` against their solo runs, and the
SMOKE llama's, SMOKE zamba2's and SMOKE xLSTM's `forward(use_kernel=True)`
and greedy `Engine` and the SMOKE qwen2-moe's, whisper's, gemma's,
starcoder2's, chatglm3's and internvl2's `forward(use_kernel=True)` on
the card against the CPU run, and training steps of the SMOKE llama
(fp32 and int8 moments; no kernel) against the CPU's.  Skipped where no CUDA card is visible; on the
card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: exact, every output lane, for the assembly kernels and paths;
flash_attention 1e-5 abs/rel in fp32 (online softmax, sums in another
order) and 5e-2 in bf16 (the plain version rounds its logits to bf16);
ssd_scan 2e-4 abs/rel (the reference's Pallas-against-oracle tolerance:
chunked sums in another order); the SMOKE LMs' logits 1e-4 (cuBLAS
against CPU matmuls; the MoE combine's atomic adds), tokens exact; the
JobServer's results exact.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import Assembler, AssemblyPlan, Local, Mesh
from repro_torch.core import dht, hmm, kmer, local_assembly
from repro_torch.core.kmer_analysis import ExtensionPolicy
from repro_torch.core.types import ReadSet
from repro_torch.data import mgsim
from repro_torch.kernels import build, ops
from repro_torch.stream import batches_from_readset

pytestmark = pytest.mark.cuda

# the kernels each assembly path launches: never the LM's flash_attention
# or ssd_scan
ASSEMBLY_KERNELS = ("kmer_extract", "dht_lookup", "dht_insert", "seed_probe",
                    "mer_walk", "sw_extend")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.equal(g, w), f"output {i}"


def _reads(rng, R, L, dev, n_frac=0.05):
    bases = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    bases[rng.random((R, L)) < n_frac] = 4
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    return (torch.from_numpy(bases).to(dev),
            torch.from_numpy(lengths).to(dev))


def _keys(rng, n, dev, key_space=1 << 40, dup_frac=0.3):
    vals = rng.integers(0, key_space, size=n, dtype=np.int64)
    d = rng.random(n) < dup_frac
    vals[d] = vals[rng.integers(0, n, size=int(d.sum()))]
    hi = torch.from_numpy((vals >> 32).astype(np.int32)).to(dev)
    lo = torch.from_numpy((vals & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)).to(dev)
    return hi, lo


@pytest.mark.parametrize("k", [3, 15, 16, 17, 21, 31])
@pytest.mark.parametrize("R,L", [(1, 40), (37, 150), (300, 77)])
def test_kmer_extract_kernel_equals_plain(dev, k, R, L):
    bases, lengths = _reads(np.random.default_rng(k * R + L), R, L, dev)
    _same(ops.kmer_extract(bases, lengths, k=k),
          ops.kmer_extract(bases, lengths, k=k, backend="torch"))


@pytest.mark.parametrize("n,cap", [(5, 16), (60, 64), (80, 64),
                                   (5000, 8192), (20000, 16384)])
def test_dht_insert_and_lookup_kernels_equal_plain(dev, n, cap):
    rng = np.random.default_rng(n + cap)
    hi, lo = _keys(rng, n, dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    t0 = dht.empty_table(cap, dev)
    got = ops.dht_insert(*t0, hi, lo, valid)
    want = ops.dht_insert(*t0, hi, lo, valid, backend="torch")
    _same(got, want)
    # a second batch dedupes against the filled table
    hi2, lo2 = _keys(rng, n, dev)
    hi2[: n // 2], lo2[: n // 2] = hi[: n // 2], lo[: n // 2]
    got2 = ops.dht_insert(*got[:4], hi2, lo2, valid)
    _same(got2, ops.dht_insert(*want[:4], hi2, lo2, valid, backend="torch"))
    table = got2[:4]
    qhi = torch.stack([hi, hi2]).contiguous()
    qlo = torch.stack([lo, lo2]).contiguous()
    qv = torch.from_numpy(rng.random((2, n)) < 0.8).to(dev)
    _same([ops.dht_lookup(*table, qhi, qlo, qv)],
          [ops.dht_lookup(*table, qhi, qlo, qv, backend="torch")])


def _offset(t, by=1):
    """t as a view that starts `by` elements into a fresh buffer: not
    16-byte aligned, so the kernels take their scalar edge paths."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    buf[by:] = t.reshape(-1)
    return buf[by:].view(t.shape)


@pytest.mark.parametrize("L", [None, 40, 77, 150, 4096])
@pytest.mark.parametrize("k", [3, 16, 31])
def test_kmer_extract_kernel_edges_equal_plain(dev, k, L):
    """Rows of length 0, all-N rows, L = k and L not a multiple of the 4
    windows a thread takes, R * L not one either, and bases that are not
    16-byte aligned."""
    L = k if L is None else L
    R = 11 if L < 4096 else 3
    rng = np.random.default_rng(10 * k + L)
    bases, lengths = _reads(rng, R, L, dev)
    lengths[0] = 0
    bases[1] = 4
    lengths[2] = L
    bases[2, : L // 3] = 4
    for b in (bases, _offset(bases)):
        _same(ops.kmer_extract(b, lengths, k=k),
              ops.kmer_extract(b, lengths, k=k, backend="torch"))


# dht_lookup cases: (rows, capacity, keys inserted, share of valid rows)
LOOKUP_CASES = {
    "valid_0": (100_003, 1 << 17, 60_000, 0.0),
    "valid_1pct": (100_003, 1 << 17, 60_000, 0.01),
    "valid_10pct": (100_003, 1 << 17, 60_000, 0.1),
    "valid_all": (100_003, 1 << 17, 60_000, 1.0),
    "ragged_small": (37, 1 << 10, 500, 0.5),
    "unaligned": (50_001, 1 << 16, 30_000, 0.3),
    "nearly_full": (40_000, 1 << 14, 16_200, 0.9),
    "max_probe_0": (40_000, 1 << 14, 16_200, 0.9),
}


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_dht_lookup_kernel_cases_equal_plain(dev, case):
    """The kernel against the plain version: validity shares 0 to 100%, n not a multiple of 16 (and of
    the 512-row tile), views off 16-byte alignment (the scalar edge
    paths), a nearly full table with long probe chains, and a max_probe
    of 0 that cuts them (the plain version stops at the same step)."""
    n, cap, m, vf = LOOKUP_CASES[case]
    rng = np.random.default_rng(n + cap + int(100 * vf))
    khi, klo = _keys(rng, m, dev, dup_frac=0.0)
    table = ops.dht_insert(*dht.empty_table(cap, dev), khi, klo,
                           torch.ones(m, dtype=torch.bool, device=dev))[:4]
    if case == "max_probe_0":
        table = (*table[:3], torch.zeros((), dtype=torch.int32, device=dev))
    else:
        assert int(table[3]) > 0 or case == "ragged_small"
    # queries: half inserted keys (present), half random (mostly absent)
    qhi, qlo = _keys(rng, n, dev, dup_frac=0.0)
    take = torch.from_numpy(rng.integers(0, m, size=n)).to(dev)
    half = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    qhi = torch.where(half, khi[take], qhi)
    qlo = torch.where(half, klo[take], qlo)
    valid = torch.from_numpy(rng.random(n) < vf).to(dev)
    if case == "unaligned":
        qhi, qlo, valid = _offset(qhi), _offset(qlo), _offset(valid, by=3)
        assert valid.data_ptr() % 16 and qhi.data_ptr() % 16
    ops.reset_launches()
    got = ops.dht_lookup(*table, qhi, qlo, valid)
    assert ops.LAUNCHES["dht_lookup"] == 1
    want = ops.dht_lookup(*table, qhi, qlo, valid, backend="torch")
    _same([got], [want])
    if vf == 0.0:
        assert bool((want == -1).all())
    elif case != "ragged_small":
        assert int((want >= 0).sum()) > 0


def _insert_case(rng, dev, case):
    """(table, hi, lo, valid) of one dht_insert case."""
    if case == "dup90":
        n, cap, dup, vf = 200_000, 1 << 18, 0.9, 0.95
    elif case == "no_valid":
        n, cap, dup, vf = 10_000, 1 << 12, 0.3, 0.0
    elif case == "sparse_2pct":
        n, cap, dup, vf = 1 << 22, 1 << 18, 0.3, 0.02
    elif case == "nearly_full":
        n, cap, dup, vf = 16_000, 1 << 14, 0.0, 1.0
    elif case == "exhaust":
        n, cap, dup, vf = 3000, 1 << 10, 0.1, 1.0
    else:  # "unaligned": views 1 element into their buffers, n % 16 != 0
        n, cap, dup, vf = 50_001, 1 << 16, 0.3, 0.9
    hi, lo = _keys(rng, n, dev, dup_frac=dup)
    valid = torch.from_numpy(rng.random(n) < vf).to(dev)
    if case == "unaligned":
        hi, lo, valid = _offset(hi), _offset(lo), _offset(valid)
    return dht.empty_table(cap, dev), hi, lo, valid


@pytest.mark.parametrize("case", ["dup90", "no_valid", "sparse_2pct",
                                  "nearly_full", "exhaust", "unaligned"])
def test_dht_insert_kernel_cases_equal_plain(dev, case):
    rng = np.random.default_rng(len(case))
    t0, hi, lo, valid = _insert_case(rng, dev, case)
    got = ops.dht_insert(*t0, hi, lo, valid)
    stats = dict(ops.LAST_INSERT)
    want = ops.dht_insert(*t0, hi, lo, valid, backend="torch")
    _same(got, want)
    assert stats["valid"] == int(valid.sum())
    assert (stats["rounds"] >= 1) == (stats["valid"] > 0)
    if case in ("nearly_full", "exhaust"):  # the long tail of the rounds
        assert stats["rounds"] > 10, stats
    if case == "nearly_full":  # the next batch would take ~2 cap rounds
        return
    # the next batch dedupes against the filled table: half its keys are
    # in it already
    hi2, lo2 = _keys(rng, hi.numel(), dev)
    half = hi.numel() // 2
    hi2[:half], lo2[:half] = hi[:half], lo[:half]
    frac = float(valid.float().mean())  # the case's share of valid rows
    valid2 = torch.from_numpy(rng.random(hi.numel()) < frac).to(dev)
    _same(ops.dht_insert(*got[:4], hi2, lo2, valid2),
          ops.dht_insert(*want[:4], hi2, lo2, valid2, backend="torch"))


def test_dht_insert_raises_when_its_grid_cannot_be_co_resident(
        dev, monkeypatch):
    """No shape of the op's inputs can make the cooperative launch fail:
    the launcher sizes the grid to the blocks this card holds at once.
    So the library is replaced by one whose launcher returns the
    runtime's refusal, cudaErrorCooperativeLaunchTooLarge: the op raises,
    with no launch counted and no other path taken."""
    rng = np.random.default_rng(5)
    hi, lo = _keys(rng, 1000, dev)
    valid = torch.ones(1000, dtype=torch.bool, device=dev)
    t0 = dht.empty_table(1 << 12, dev)
    real = build.library("dht_probe")

    class Refusing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def dht_insert_launch(*args):
            return 720  # cudaErrorCooperativeLaunchTooLarge

    with monkeypatch.context() as m:
        m.setattr(build, "library", lambda name: Refusing())
        before = ops.LAUNCHES["dht_insert"]
        with pytest.raises(RuntimeError, match="cooperative launch"):
            ops.dht_insert(*t0, hi, lo, valid)
        assert ops.LAUNCHES["dht_insert"] == before
    _same(ops.dht_insert(*t0, hi, lo, valid),
          ops.dht_insert(*t0, hi, lo, valid, backend="torch"))


def _seed_index(rng, dev, capacity, seed_len, C=6, clen=200):
    contigs = torch.from_numpy(rng.integers(0, 4, size=(C, clen)).astype(
        np.uint8)).to(dev)
    contigs[1, 10:60] = contigs[0, 40:90]
    from repro_torch.core.alignment import build_seed_index
    from repro_torch.core.types import ContigSet
    cs = ContigSet(contigs, torch.full((C,), clen, dtype=torch.int32,
                                       device=dev),
                   torch.ones(C, dtype=torch.float32, device=dev))
    alive = torch.ones(C, dtype=torch.bool, device=dev)
    return contigs, build_seed_index(cs, alive, seed_len=seed_len,
                                     capacity=capacity, backend="torch")


@pytest.mark.parametrize("seed_len,capacity,R", [(15, 1 << 12, 9),
                                                 (16, 1 << 12, 1),
                                                 (17, 1 << 12, 7),
                                                 (27, 1 << 12, 500),
                                                 (21, 16, 64)])
def test_seed_probe_kernel_equals_plain(dev, seed_len, capacity, R):
    rng = np.random.default_rng(seed_len * capacity + R)
    contigs, index = _seed_index(rng, dev, capacity, seed_len)
    L = 90
    starts = rng.integers(0, contigs.shape[1] - L, size=R)
    rows = rng.integers(0, contigs.shape[0], size=R)
    bases = torch.stack([contigs[r, s:s + L] for r, s in zip(rows, starts)])
    flip = torch.from_numpy(rng.random(R) < 0.5).to(dev)
    bases = torch.where(flip[:, None], (3 - bases).flip(1), bases)
    bases[torch.from_numpy(rng.random((R, L)) < 0.02).to(dev)] = 4
    lengths = torch.from_numpy(rng.integers(0, L + 1, size=R).astype(
        np.int32)).to(dev)
    t = index.table
    args = (bases.contiguous(), lengths, *t, index.contig, index.pos,
            index.flip, index.multi)
    positions = tuple(range(0, L - seed_len + 1, 16)) + (L - seed_len,)
    got = ops.seed_probe(*args, seed_len=seed_len, positions=positions)
    _same(got, ops.seed_probe(*args, seed_len=seed_len, positions=positions,
                              backend="torch"))


def _sampled_reads(rng, contigs, R, L, dev, n_frac=0.02):
    """Reads of L bases from the contigs (half reverse-complemented, N
    bases sprinkled), ragged lengths, half of them full."""
    starts = rng.integers(0, contigs.shape[1] - L + 1, size=R)
    rows = rng.integers(0, contigs.shape[0], size=R)
    c = contigs.cpu().numpy()
    bases = np.stack([c[r, s:s + L] for r, s in zip(rows, starts)])
    flip = rng.random(R) < 0.5
    bases[flip] = (3 - bases[flip])[:, ::-1]
    bases[rng.random((R, L)) < n_frac] = 4
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    lengths[: R // 2] = L
    return (torch.from_numpy(np.ascontiguousarray(bases)).to(dev),
            torch.from_numpy(lengths).to(dev))


def _stride(L, seed_len, stride=16):
    """alignment._seed_positions: every stride columns, then the last."""
    pos = list(range(0, L - seed_len + 1, stride))
    return tuple(pos) + ((L - seed_len,) if pos[-1] != L - seed_len else ())


# name -> (seed_len, capacity, R, L, reads, positions or None for the
# path's stride-16 seeds)
SEED_PROBE_CASES = {
    "S1": (21, 1 << 12, 300, 150, "sampled", (40,)),
    "S32": (17, 1 << 12, 300, 150, "sampled", tuple(range(0, 128, 4))),
    "path_k21": (21, 1 << 12, 32768, 150, "sampled", None),
    "path_k27": (27, 1 << 12, 32768, 150, "sampled", None),
    "ragged_R": (21, 1 << 12, 1005, 150, "sampled", None),
    "all_miss": (21, 1 << 12, 500, 150, "random", None),
    "cap16": (21, 16, 500, 150, "sampled", None),
    "misaligned": (21, 1 << 12, 77, 91, "offset", None),
    "long_L": (21, 1 << 12, 5, 60000, "long", (0, 30000, 59979)),
}


@pytest.mark.parametrize("case", list(SEED_PROBE_CASES))
def test_seed_probe_kernel_cases_equal_plain(dev, case):
    """S = 1 and 32, the path's L = 150 and S (k 21: 10 seeds, k 27: 9),
    R not a multiple of a block's reads, reads that miss every seed, the
    capacity-16 table's long probe chains, rows that do not start on a
    16-byte boundary, and reads too long for a warp's rows to fit the
    default shared memory."""
    seed_len, capacity, R, L, kind, positions = SEED_PROBE_CASES[case]
    rng = np.random.default_rng(len(case) * 1000 + R)
    contigs, index = _seed_index(rng, dev, capacity, seed_len, clen=400)
    if kind == "sampled":
        bases, lengths = _sampled_reads(rng, contigs, R, L, dev)
    elif kind == "offset":  # a contiguous view one row into its buffer
        bases, lengths = _sampled_reads(rng, contigs, R + 1, L, dev)
        bases, lengths = bases[1:], lengths[1:]
        assert bases.data_ptr() % 16 and bases.is_contiguous()
    else:
        bases, lengths = _reads(rng, R, L, dev)
        if kind == "long":  # one stretch of a contig under the middle seed
            bases[:, 30000:30100] = contigs[0, 100:200]
            lengths[:] = L
    positions = positions or _stride(L, seed_len)
    t = index.table
    args = (bases, lengths, *t, index.contig, index.pos, index.flip,
            index.multi)
    ops.reset_launches()
    got = ops.seed_probe(*args, seed_len=seed_len, positions=positions)
    assert ops.LAUNCHES["seed_probe"] == 1
    _same(got, ops.seed_probe(*args, seed_len=seed_len, positions=positions,
                              backend="torch"))
    placed = int((got[0][:, 0] >= 0).sum())
    if kind == "random":
        assert placed == 0
    elif kind in ("sampled", "offset", "long"):
        assert placed > 0


def test_seed_probe_kernel_refuses_33_seeds(dev):
    rng = np.random.default_rng(3)
    contigs, index = _seed_index(rng, dev, 1 << 12, 17)
    bases, lengths = _reads(rng, 4, 150, dev)
    with pytest.raises(ValueError, match="seeds"):
        ops.seed_probe(bases, lengths, *index.table, index.contig,
                       index.pos, index.flip, index.multi, seed_len=17,
                       positions=tuple(range(0, 132, 4)))


def test_contig_rounds_on_card_equals_cpu(dev):
    plan = AssemblyPlan(
        k_min=17, k_max=21, k_step=4, kmer_capacity=1 << 14, contig_cap=256,
        max_contig_len=2048, policy=ExtensionPolicy(err_rate=0.05),
        run_local_assembly=False)
    comm = mgsim.sample_community(41, num_genomes=2, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(42, comm, num_pairs=300, read_len=60,
                                    err_rate=0.003)
    ops.reset_launches()
    got = Assembler(plan, Local(dev)).contig_rounds(reads)
    # without local assembly and gapped alignment, every kernel but the
    # walk and the gapped DP runs
    assert all(ops.LAUNCHES[n] > 0 for n in ASSEMBLY_KERNELS
               if n not in ("mer_walk", "sw_extend")), ops.LAUNCHES
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["ssd_scan"] == 0
    want = Assembler(plan, Local("cpu")).contig_rounds(reads)
    for g, w in zip(got[:3], want[:3]):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        _same([x.cpu() for x in g], list(w))
    assert got[3] == want[3]


def _walk_fixture(rng, dev, mer_sizes, capacity, E, seed_len,
                  num_reads=200, L=60):
    """Walk tables from random reads (plain build); walkers on read windows
    (half) and random buffers (half); each walker's target is the seed a
    few bases further along its read (random for the others)."""
    K = local_assembly.BUF_K
    bases = rng.integers(0, 4, size=(num_reads, L)).astype(np.uint8)
    bases[rng.random((num_reads, L)) < 0.01] = 4
    lengths = rng.integers(K, L + 1, size=num_reads).astype(np.int32)
    rc = rng.integers(-1, 8, size=num_reads).astype(np.int32)
    reads = ReadSet(torch.from_numpy(bases).to(dev),
                    torch.from_numpy(lengths).to(dev),
                    torch.full((num_reads,), -1, dtype=torch.int32,
                               device=dev), 0)
    tag_bits = min(16, 62 - 2 * max(mer_sizes))
    wt = local_assembly.build_walk_tables(
        reads, torch.from_numpy(rc).to(dev), mer_sizes=mer_sizes,
        tag_bits=tag_bits, capacity=capacity, backend="torch")
    buf = rng.integers(0, 4, size=(E, K)).astype(np.uint8)
    tgt = rng.integers(0, 4, size=(E, seed_len)).astype(np.uint8)
    contig = rng.integers(0, 8, size=E).astype(np.int32)
    for i in range(0, E, 2):
        r = rng.integers(0, num_reads)
        p = rng.integers(0, lengths[r] - K + 1)
        if rc[r] >= 0 and (bases[r, p:p + K] < 4).all():
            buf[i], contig[i] = bases[r, p:p + K], rc[r]
            t = bases[r, p + K + 2:p + K + 2 + seed_len]
            if len(t) == seed_len and p + K + 2 + seed_len <= lengths[r]:
                tgt[i] = t
    hi, lo = kmer.pack_window(torch.from_numpy(buf).to(dev), k=K)
    t_hi, t_lo = kmer.pack_window(torch.from_numpy(tgt).to(dev), k=seed_len)
    active = torch.from_numpy(rng.random(E) < 0.8).to(dev)
    return (wt, tag_bits, (hi, lo, torch.from_numpy(contig).to(dev), active),
            (t_hi, t_lo))


@pytest.mark.parametrize("mer_sizes,capacity,E,max_ext", [
    ((13, 17, 21), 1 << 12, 37, 64), ((17, 21, 25), 1 << 10, 200, 8),
    ((17, 21, 25), 1 << 14, 1000, 64), ((3, 5, 7), 1 << 10, 64, 64),
    ((21,), 1 << 12, 9, 16)])
@pytest.mark.parametrize("target", [False, True])
def test_mer_walk_kernel_equals_plain(dev, mer_sizes, capacity, E, max_ext,
                                      target):
    rng = np.random.default_rng(capacity + E + max_ext)
    seed_len = min(min(mer_sizes), 17)
    wt, tag_bits, walkers, (t_hi, t_lo) = _walk_fixture(
        rng, dev, mer_sizes, capacity, E, seed_len)
    kw = dict(mer_sizes=mer_sizes, tag_bits=tag_bits, max_ext=max_ext)
    if target:
        kw.update(target_hi=t_hi, target_lo=t_lo, seed_len=seed_len)
    ops.reset_launches()
    got = ops.mer_walk(wt, *walkers, **kw)
    assert ops.LAUNCHES["mer_walk"] == 1
    want = ops.mer_walk(wt, *walkers, backend="torch", **kw)
    _same(got, want)
    assert int(want.ext_len.max()) > 0


def test_mer_walk_kernel_on_nearly_full_tables(dev):
    """Rung tables of (13, 17, 21) loaded to 88% / 70% / 54%: keys past
    their home slot, probe chains of up to hundreds of slots."""
    rng = np.random.default_rng(5)
    mer_sizes = (13, 17, 21)
    wt, tag_bits, walkers, _ = _walk_fixture(
        rng, dev, mer_sizes, 1 << 13, 2000, 13, num_reads=400, L=40)
    for t in wt.tables:  # loaded, and many keys away from their home slot
        load = float(t.used.float().mean())
        home = kmer.kmer_hash(t.slot_hi, t.slot_lo) & (t.capacity - 1)
        moved = float((t.used & (home != torch.arange(
            t.capacity, device=dev))).sum()) / max(int(t.used.sum()), 1)
        assert load > 0.5 and moved > 0.2 and int(t.max_probe) >= 4
    kw = dict(mer_sizes=mer_sizes, tag_bits=tag_bits, max_ext=64)
    got = ops.mer_walk(wt, *walkers, **kw)
    want = ops.mer_walk(wt, *walkers, backend="torch", **kw)
    _same(got, want)
    assert int(want.ext_len.max()) > 0


def test_mer_walk_kernel_131072_walkers_2pct_active(dev):
    """The gap walk's shape: 131,072 walkers, ~2% active, with a target."""
    rng = np.random.default_rng(131072)
    wt, tag_bits, (hi, lo, contig, _), (t_hi, t_lo) = _walk_fixture(
        rng, dev, (17, 21, 25), 1 << 14, 131_072, 17)
    active = torch.from_numpy(rng.random(131_072) < 0.02).to(dev)
    active[0::64] = True  # the read windows among them
    kw = dict(mer_sizes=(17, 21, 25), tag_bits=tag_bits, max_ext=64,
              target_hi=t_hi, target_lo=t_lo, seed_len=17)
    got = ops.mer_walk(wt, hi, lo, contig, active, **kw)
    want = ops.mer_walk(wt, hi, lo, contig, active, backend="torch", **kw)
    _same(got, want)
    assert int(want.ext_len.max()) > 0


@pytest.mark.parametrize("max_ext", [64, 37])
def test_mer_walk_kernel_writes_every_pad_byte(dev, max_ext):
    """The kernel's output comes from torch.empty: it writes pad 4 past
    each walker's ext_len itself.  The caching allocator is first handed
    a block of the same size filled with 0xAB, which the output gets."""
    rng = np.random.default_rng(max_ext)
    E = 3001
    wt, tag_bits, walkers, _ = _walk_fixture(rng, dev, (17, 21, 25),
                                             1 << 12, E, 17)
    kw = dict(mer_sizes=(17, 21, 25), tag_bits=tag_bits, max_ext=max_ext)
    torch.cuda.synchronize()
    junk = torch.full((E, max_ext), 0xAB, dtype=torch.uint8, device=dev)
    junk_ptr = junk.data_ptr()
    del junk
    got = ops.mer_walk(wt, *walkers, **kw)
    assert got.ext_bases.data_ptr() == junk_ptr
    col = torch.arange(max_ext, device=dev)[None, :]
    past = col >= got.ext_len[:, None].to(torch.int64)
    assert bool((got.ext_bases[past] == 4).all())
    assert bool((got.ext_bases[~past] < 4).all())
    _same(got, ops.mer_walk(wt, *walkers, backend="torch", **kw))


def test_assemble_on_card_equals_cpu(dev):
    plan = AssemblyPlan(
        k_min=17, k_max=21, k_step=4, kmer_capacity=1 << 14, contig_cap=256,
        max_contig_len=2048, walk_capacity=1 << 15, link_capacity=1 << 10,
        max_scaffold_len=1 << 12, policy=ExtensionPolicy(err_rate=0.05))
    comm = mgsim.sample_community(32, num_genomes=3, genome_len=500,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(33, comm, num_pairs=600, read_len=60,
                                    err_rate=0.003)
    ops.reset_launches()
    got = Assembler(plan, Local(dev)).assemble(reads)
    # Hamming verification (gapped_align=False): no gapped DP
    assert all(ops.LAUNCHES[n] > 0 for n in ASSEMBLY_KERNELS
               if n != "sw_extend"), ops.LAUNCHES
    assert ops.LAUNCHES["sw_extend"] == 0
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["ssd_scan"] == 0
    want = Assembler(plan, Local("cpu")).assemble(reads)
    for key in ("contigs", "alive", "alignments", "links", "suspended",
                "components", "scaffolds", "scaffold_seqs"):
        g, w = got[key], want[key]
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        _same([x.cpu() for x in g], list(w))
    assert got["stats"] == want["stats"]


def _sw_inputs(rng, B, QL, TL, dev, indels):
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
    full = (B + 1) // 2  # rows of full live length
    qlen[:full], tlen[:full] = QL, TL
    return [torch.from_numpy(x).to(dev) for x in (q, t, qlen, tlen)]


@pytest.mark.parametrize("band", [0, 7, 15])
@pytest.mark.parametrize("B,QL,TL", [(1, 32, 40), (9, 64, 64), (37, 40, 20),
                                     (5000, 150, 150)])
@pytest.mark.parametrize("indels", [False, True])
def test_sw_extend_kernel_equals_plain(dev, band, B, QL, TL, indels):
    rng = np.random.default_rng(band * 7 + B + QL + indels)
    args = _sw_inputs(rng, B, QL, TL, dev, indels)
    ops.reset_launches()
    got = ops.sw_extend(*args, band=band)
    assert ops.LAUNCHES["sw_extend"] == 1
    _same(got, ops.sw_extend(*args, band=band, backend="torch"))
    if indels and band:
        assert int(got[0][0]) > min(QL, TL) // 2


def test_sw_extend_kernel_refuses_a_wide_band(dev):
    z = torch.zeros((2, 8), dtype=torch.uint8, device=dev)
    n = torch.full((2,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="band"):
        ops.sw_extend(z, z, n, n, band=16)


def _sw_case(rng, case, dev):
    """(query, target, qlen, tlen, band) of one card case."""
    if case == "wide_weights":  # scores past the kernel's 32 x score keys
        return (*_sw_inputs(rng, 3000, 150, 150, dev, True), 15)
    if case == "path3":  # path 3's call: reads against contig windows
        q, t, _, _ = _sw_inputs(rng, 32768, 150, 150, dev, True)
        none = torch.from_numpy(rng.random(32768) < 0.3).to(dev)
        qlen = torch.where(none, 0, 150).to(torch.int32)
        short = torch.from_numpy(rng.random(32768) < 0.1).to(dev)
        qlen = torch.where(short & ~none, 120, qlen).to(torch.int32)
        return q, t, qlen, torch.where(none, 0, 150).to(torch.int32), 15
    if case == "all_qlen0":
        q, t, _, tlen = _sw_inputs(rng, 1000, 150, 150, dev, True)
        return q, t, torch.zeros_like(tlen), tlen, 15
    if case == "ties":  # short pairs over two bases: ties in and across rows
        B, n = 4096, 24
        q, t = (rng.integers(0, 2, size=(B, n)).astype(np.uint8)
                for _ in range(2))
        full = np.full(B, n, np.int32)
        return (*(torch.from_numpy(x).to(dev) for x in (q, t, full, full)),
                15)
    if case == "ragged_B":
        return (*_sw_inputs(rng, 4097, 150, 150, dev, True), 15)
    if case == "misaligned":  # contiguous views one row into their buffers
        q, t, qlen, tlen = _sw_inputs(rng, 78, 33, 47, dev, True)
        q, t, qlen, tlen = q[1:], t[1:], qlen[1:], tlen[1:]
        assert q.data_ptr() % 16 and t.data_ptr() % 16
        return q, t, qlen, tlen, 3
    assert case == "long_rows"  # 16 pairs a block, over 48 KB of rows
    return (*_sw_inputs(rng, 40, 6000, 6000, dev, True), 15)


@pytest.mark.parametrize("case", ["path3", "all_qlen0", "ties", "ragged_B",
                                  "misaligned", "long_rows", "wide_weights"])
def test_sw_extend_kernel_cases_equal_plain(dev, case):
    """Path 3's shape (32768 x 150 x 150, band 15, a third of the pairs
    without a candidate), a batch with qlen = 0 everywhere, short pairs
    over two bases whose best score ties in and across rows, B not a
    multiple of a block's pairs, rows that do not start on a 16-byte
    boundary, rows too long for 32 pairs a block, and weights whose
    scores pass the kernel's keyed row maximum (its cell-by-cell chain)."""
    rng = np.random.default_rng(len(case))
    q, t, qlen, tlen, band = _sw_case(rng, case, dev)
    w = 1 << 19 if case == "wide_weights" else 1
    kw = dict(band=band, match=w, mismatch=-w, gap=-w)
    ops.reset_launches()
    got = ops.sw_extend(q, t, qlen, tlen, **kw)
    assert ops.LAUNCHES["sw_extend"] == 1
    _same(got, ops.sw_extend(q, t, qlen, tlen, **kw, backend="torch"))
    if case == "all_qlen0":
        assert not any(g.any() for g in got)
    else:
        assert int(got[0].max()) > 0


def test_assemble_stream_on_card_equals_cpu(dev):
    """Gapped streamed assembly under a from_stream plan, with a
    checkpoint directory; then the in-memory low_memory assemble."""
    comm = mgsim.sample_community(5, num_genomes=3, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                    err_rate=0.003)
    plan = AssemblyPlan.from_stream(256, 60, (17, 21, 4), unique_kmers=1000,
                                    slack=4.0, gapped_align=True)
    batches = batches_from_readset(reads, 256)
    ops.reset_launches()
    got = Assembler(plan, Local(dev)).assemble_stream(batches)
    assert all(ops.LAUNCHES[n] > 0 for n in ASSEMBLY_KERNELS), ops.LAUNCHES
    assert ops.LAUNCHES["sw_extend"] == 3 * len(batches) * 2
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["ssd_scan"] == 0
    want = Assembler(plan, Local("cpu")).assemble_stream(batches)
    for key in ("contigs", "alive", "alignments", "links", "suspended",
                "components", "scaffolds", "scaffold_seqs"):
        g, w = got[key], want[key]
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        _same([x.cpu() for x in g], list(w))
    assert got["stats"] == want["stats"]
    assert got["stream_stats"] == want["stream_stats"]
    lm = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.2,
                                   low_memory=True)
    g = Assembler(lm, Local(dev)).assemble(reads)
    w = Assembler(lm, Local("cpu")).assemble(reads)
    for f in w["scaffold_seqs"]._fields:
        assert torch.equal(getattr(g["scaffold_seqs"], f).cpu(),
                           getattr(w["scaffold_seqs"], f)), f
    assert g["stats"] == w["stats"]


ASSEMBLE_KEYS = ("contigs", "alive", "alignments", "links", "suspended",
                 "components", "scaffolds", "scaffold_seqs")


def _same_result(got, want, keys):
    for key in keys:
        g, w = got[key], want[key]
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        _same([x.cpu() for x in g], [x.cpu() for x in w])


def _mesh_fixture():
    """tests/test_torch_mesh.py's community and Mesh(2) plan."""
    comm = mgsim.sample_community(5, num_genomes=3, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                    err_rate=0.003)
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), num_shards=2,
                                     unique_rate=0.2, localize_out_factor=8)
    return reads, plan


def test_mesh_contig_rounds_on_card_equals_cpu(dev):
    reads, plan = _mesh_fixture()
    plan = dataclasses.replace(plan, run_local_assembly=False)
    ops.reset_launches()
    got = Assembler(plan, Mesh(2, device=dev)).contig_rounds(reads)
    assert all(ops.LAUNCHES[n] > 0 for n in ASSEMBLY_KERNELS
               if n not in ("mer_walk", "sw_extend")), ops.LAUNCHES
    assert ops.LAUNCHES["mer_walk"] == ops.LAUNCHES["sw_extend"] == 0
    want = Assembler(plan, Mesh(2, device="cpu")).contig_rounds(reads)
    for g, w in zip(got[:3], want[:3]):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        _same([x.cpu() for x in g], list(w))
    assert got[3] == want[3]


def test_mesh_assemble_on_card_equals_cpu(dev):
    reads, plan = _mesh_fixture()
    ops.reset_launches()
    ctx = Mesh(2, device=dev)
    got = Assembler(plan, ctx).assemble(reads)
    assert all(ops.LAUNCHES[n] > 0 for n in ASSEMBLY_KERNELS
               if n != "sw_extend"), ops.LAUNCHES
    assert ops.LAUNCHES["sw_extend"] == 0
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["ssd_scan"] == 0
    want = Assembler(plan, Mesh(2, device="cpu")).assemble(reads)
    _same_result(got, want, ASSEMBLE_KEYS)
    assert got["stats"] == want["stats"]
    assert got["overflow"] == want["overflow"]
    assert all(v == 0 for v in got["overflow"].values())


def test_mesh_gapped_assemble_stream_on_card_equals_cpu(dev):
    reads, _ = _mesh_fixture()
    plan = AssemblyPlan.from_stream(256, 60, (17, 21, 4), unique_kmers=1000,
                                    slack=4.0, gapped_align=True,
                                    num_shards=2)
    batches = batches_from_readset(reads, 256)
    ops.reset_launches()
    got = Assembler(plan, Mesh(2, device=dev)).assemble_stream(batches)
    assert all(ops.LAUNCHES[n] > 0 for n in ASSEMBLY_KERNELS), ops.LAUNCHES
    want = Assembler(plan, Mesh(2, device="cpu")).assemble_stream(batches)
    _same_result(got, want, ASSEMBLE_KEYS)
    assert got["stats"] == want["stats"]
    assert got["stream_stats"] == want["stream_stats"]


def test_mesh_over_an_nccl_group_equals_one_process(dev, tmp_path,
                                                   monkeypatch):
    """`Mesh(2, group=g)` over an NCCL group of one rank (this process)
    against the single-process `Mesh(2)` on the card, bit for bit."""
    import torch.distributed as tdist

    from repro_torch.launch import mesh as launch_mesh

    reads, plan = _mesh_fixture()
    batches = batches_from_readset(reads, 256)
    monkeypatch.delenv("LOCAL_RANK", raising=False)  # join_group sets it
    launch_mesh.join_group(0, 1, device="cuda",
                           init_file=tmp_path / "store")
    try:
        mesh = launch_mesh.make_data_mesh(2)
        assert tdist.get_backend(mesh.group) == "nccl"
        assert mesh.device == torch.device("cuda",
                                           torch.cuda.current_device())
        ops.reset_launches()
        got = Assembler(plan, Mesh(2, group=mesh.group)).assemble(reads)
        assert all(ops.LAUNCHES[n] > 0 for n in ASSEMBLY_KERNELS
                   if n != "sw_extend"), ops.LAUNCHES
        got_s = Assembler(plan, Mesh(2, group=mesh.group)).assemble_stream(
            batches)
    finally:
        tdist.destroy_process_group()
    for out, want in ((got, Assembler(plan, Mesh(2, device=dev))
                       .assemble(reads)),
                      (got_s, Assembler(plan, Mesh(2, device=dev))
                       .assemble_stream(batches))):
        _same_result(out, want, ASSEMBLE_KEYS)
        assert out["stats"] == want["stats"]
        assert out["overflow"] == want["overflow"]


def test_kernel_op_refuses_a_tensor_off_the_current_card(dev, monkeypatch):
    bases, lengths = _reads(np.random.default_rng(0), 4, 40, dev)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: bases.device.index + 1)
    with pytest.raises(ValueError, match="current device"):
        ops.kmer_extract(bases, lengths, k=17)


def test_hmm_hits_on_card_equals_cpu(dev):
    rng = np.random.default_rng(5)
    rrna = rng.integers(0, 4, 80).astype(np.uint8)
    bases = rng.integers(0, 4, (300, 700)).astype(np.uint8)
    bases[::7, 100:180] = rrna
    lengths = rng.integers(0, 701, 300).astype(np.int32)
    lengths[::7] = 700
    prof = hmm.build_profile([rrna])
    want = hmm.hmm_hits(prof, torch.from_numpy(bases),
                        torch.from_numpy(lengths))
    got = hmm.hmm_hits(hmm.build_profile([rrna], device=dev),
                       torch.from_numpy(bases).to(dev),
                       torch.from_numpy(lengths).to(dev))
    assert torch.equal(got[0].cpu(), want[0]) and bool(want[0].any())
    assert torch.allclose(got[1].cpu(), want[1], rtol=0, atol=1e-4)


# ---------- the LM serving path: flash_attention and the SMOKE llama ----------

FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _qkv(seed, B, H, KH, S, D, dtype, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D))]


@pytest.mark.parametrize("H,KH", [(4, 4), (6, 2)])
@pytest.mark.parametrize("S", [1, 100, 256, 1000])
@pytest.mark.parametrize("D", [16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_equals_plain(dev, causal, dtype, D, S, H, KH):
    q, k, v = _qkv(S * D + H, 2, H, KH, S, D, dtype, dev)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ops.flash_attention(q, k, v, causal=causal, backend="torch")
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [63, 64, 65, 127, 129])
@pytest.mark.parametrize("D", [112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_at_tile_edges(dev, causal, dtype, D, S):
    """S around the kernels' tiles: 64 keys a tile and 16 rows a warp in
    fp32, 128 query rows (two warpgroups of 64) and 128 keys a tile in
    bf16; D = 112 runs the bf16 kernel on 128 columns padded by TMA's zero
    fill; GQA 6/2."""
    q, k, v = _qkv(7 * S + D, 2, 6, 2, S, D, dtype, dev)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ops.flash_attention(q, k, v, causal=causal, backend="torch")
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_a_path_shape(dev, dtype):
    """zamba2-7b's shared block at S = 4096: q, k, v [1, 8, 4096, 112]
    (8 of its 32 heads), causal: 32 query tiles of 128 rows in bf16, 64
    key tiles in fp32."""
    q, k, v = _qkv(4096, 1, 8, 8, 4096, 112, dtype, dev)
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q, k, v, backend="torch")
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_the_whisper_encoder(dev, dtype):
    """whisper-large-v3's encoder: non-causal, S = 1500 (a partial last
    tile in both kernels), 20 heads of D = 64 (4 of them here)."""
    q, k, v = _qkv(1500, 2, 4, 4, 1500, 64, dtype, dev)
    got = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention(q, k, v, causal=False, backend="torch")
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_gqa_16(dev, dtype, causal):
    """chatglm3-6b's grouping: 32 query heads over 2 KV heads of D = 128."""
    q, k, v = _qkv(16, 1, 32, 2, 1000, 128, dtype, dev)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, backend="torch")
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "gemma-7b",
                                  "starcoder2-3b", "chatglm3-6b",
                                  "internvl2-2b"])
def test_new_archs_forward_on_card_equals_cpu(dev, arch):
    """The SMOKE enc-dec, dense and vlm configs: the kernel path on the
    card (one flash launch a decoder layer) against the CPU's."""
    from repro_torch.models import registry
    cfg = registry.get(arch, smoke=True)
    fns = registry.model_fns(cfg)
    g = torch.Generator()
    g.manual_seed(1)
    cpu = fns["init_params"](cfg, g, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    batch = registry.smoke_batch(cfg, batch=2, seq=120, seed=2)
    ops.reset_launches()
    got, _ = fns["forward"](cfg, card, {k: v.to(dev) for k, v in
                                        batch.items()}, use_kernel=True)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    want, _ = fns["forward"](cfg, cpu, batch, use_kernel=True)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_flash_attention_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(0, 1, 4, 2, 64, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k.half(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(*_qkv(0, 1, 4, 2, 64, 48, torch.float32, dev))
    with pytest.raises(ValueError, match="H % KH"):
        ops.flash_attention(*_qkv(0, 1, 4, 3, 64, 64, torch.float32, dev))


@pytest.fixture
def smoke_lm(dev):
    from repro_torch.models import registry, transformer
    cfg = registry.get("llama3.2-3b", smoke=True)
    g = torch.Generator()
    g.manual_seed(0)
    cpu = transformer.init_params(cfg, g, device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(dev)


def test_lm_forward_on_card_equals_cpu(smoke_lm, dev):
    from repro_torch.models import transformer
    cfg, cpu, card = smoke_lm
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 200)).astype(
        np.int32))
    ops.reset_launches()
    got, _ = transformer.forward(cfg, card, {"tokens": tok.to(dev)},
                                 use_kernel=True)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    plain, _ = transformer.forward(cfg, card, {"tokens": tok.to(dev)})
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert ops.LAUNCHES["ssd_scan"] == 0
    want, _ = transformer.forward(cfg, cpu, {"tokens": tok}, use_kernel=True)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(plain.cpu(), want, rtol=1e-4, atol=1e-4)


def test_lm_greedy_engine_on_card_equals_cpu(smoke_lm, dev):
    from repro_torch.models.decode_engine import Engine, ServeConfig
    cfg, cpu, card = smoke_lm
    outs = []
    for model, where in ((card, dev), (cpu, "cpu")):
        eng = Engine(cfg, model, ServeConfig(max_len=64), batch_slots=3,
                     device=where)
        for p in ([5, 6, 7], [11, 12], list(range(20, 40))):
            eng.submit(p)
        ops.reset_launches()
        outs.append(eng.run(max_new_tokens=40))
        assert not any(ops.LAUNCHES.values())  # decode: no prefill
    assert outs[0] == outs[1]
    assert all(len(o) > 0 for o in outs[0])


# ---------- the hybrid path: ssd_scan and the SMOKE zamba2 ----------

SSD_TOL = 2e-4


def _ssd_inputs(seed, B, S, H, P, N, dev):
    """x, b, c standard normal; a = -softplus(z), z ~ N(0, 1): the
    model's decays, whose chunk sums overflow the reference's unmasked
    exp (the kernel masks before exp)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g, device=dev)
    a = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev))
    b = torch.randn((B, S, H, N), generator=g, device=dev)
    c = torch.randn((B, S, H, N), generator=g, device=dev)
    return x, a, b, c


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", [128, 512])
@pytest.mark.parametrize("H", [8, 112])
@pytest.mark.parametrize("PN", [16, 64])
def test_ssd_scan_kernel_equals_plain(dev, B, S, H, PN):
    x, a, b, c = _ssd_inputs(B * S + H + PN, B, S, H, PN, PN, dev)
    ops.reset_launches()
    got = ops.ssd_scan(x, a, b, c)
    assert ops.LAUNCHES["ssd_scan"] == 1
    want = ops.ssd_scan(x, a, b, c, backend="torch")
    assert ops.LAUNCHES["ssd_scan"] == 1
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("S,chunk,P,N", [(96, 32, 64, 64), (100, 128, 8, 4),
                                         (256, 64, 33, 17)])
def test_ssd_scan_kernel_other_chunks_and_widths(dev, S, chunk, P, N):
    """Chunks under 128 (S = 100 runs one chunk of Q = S) and widths that
    are not multiples of 16."""
    x, a, b, c = _ssd_inputs(S + P, 2, S, 3, P, N, dev)
    got = ops.ssd_scan(x, a, b, c, chunk=chunk)
    want = ops.ssd_scan(x, a, b, c, chunk=chunk, backend="torch")
    torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("S", [128, 33 * 128])
def test_ssd_scan_kernel_one_and_33_chunks(dev, S):
    """zamba2-7b's heads (H = 112, P = N = 64): one chunk, where the state
    stays zero, and 33, where it crosses 32 chunk borders and the chunk
    loads run a stage ahead of the products."""
    x, a, b, c = _ssd_inputs(S + 1, 2, S, 112, 64, 64, dev)
    ops.reset_launches()
    got = ops.ssd_scan(x, a, b, c)
    assert ops.LAUNCHES["ssd_scan"] == 1
    want = ops.ssd_scan(x, a, b, c, backend="torch")
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_scan_kernel_refuses_what_it_does_not_take(dev):
    x, a, b, c = _ssd_inputs(0, 1, 256, 2, 16, 16, dev)
    with pytest.raises(ValueError, match="chunk <= 128"):
        ops.ssd_scan(x, a, b, c, chunk=256)
    with pytest.raises(ValueError, match="P <= 256"):
        ops.ssd_scan(*_ssd_inputs(0, 1, 128, 2, 257, 16, dev))
    with pytest.raises(ValueError, match="N <= 256"):
        ops.ssd_scan(*_ssd_inputs(0, 1, 128, 2, 16, 300, dev))
    with pytest.raises(ValueError, match="launch limit"):
        ops.ssd_scan(*_ssd_inputs(0, 1, 1, 1 << 16, 96, 8, dev))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x[:, :200].contiguous(), a[:, :200].contiguous(),
                     b[:, :200].contiguous(), c[:, :200].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.repeat_interleave(2, dim=-1)[..., ::2], a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.double(), a.double(), b.double(), c.double())
    with pytest.raises(ValueError, match="b, c"):
        ops.ssd_scan(x, a, b, c[..., :8].contiguous())


# the mLSTM's heads (xlstm-125m: P = N = 192) take ssd_scan_wide.cu

@pytest.mark.parametrize("PN", [96, 128, 192, 256])
@pytest.mark.parametrize("S,chunk", [(128, 128), (1024, 128), (256, 32)])
def test_ssd_scan_wide_kernel_equals_plain(dev, PN, S, chunk):
    """P = N above the narrow kernel's 64: one chunk (no carried state)
    and many, chunks of 128 and 32."""
    x, a, b, c = _ssd_inputs(PN + S + chunk, 2, S, 4, PN, PN, dev)
    ops.reset_launches()
    got = ops.ssd_scan(x, a, b, c, chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == 1
    want = ops.ssd_scan(x, a, b, c, chunk=chunk, backend="torch")
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("P,N", [(192, 64), (64, 192), (200, 72), (65, 3),
                                 (130, 250)])
@pytest.mark.parametrize("chunk", [128, 32])
def test_ssd_scan_wide_kernel_with_p_unlike_n(dev, P, N, chunk):
    """P != N, widths that are not multiples of 64 or of 4 (the 4-byte
    copies), over 4 or 16 chunks."""
    x, a, b, c = _ssd_inputs(P + N + chunk, 1, 512, 3, P, N, dev)
    got = ops.ssd_scan(x, a, b, c, chunk=chunk)
    want = ops.ssd_scan(x, a, b, c, chunk=chunk, backend="torch")
    torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("B,H", [(1, 1), (2, 4), (4, 16)])
def test_ssd_scan_wide_kernel_across_heads(dev, B, H):
    """B H from 1 to 64 heads of 192, with a ragged chunk (S = 96 runs
    one chunk of Q = S; S = 480 fifteen of 32)."""
    for S, chunk in ((96, 128), (480, 32)):
        x, a, b, c = _ssd_inputs(B * H + S, B, S, H, 192, 192, dev)
        got = ops.ssd_scan(x, a, b, c, chunk=chunk)
        want = ops.ssd_scan(x, a, b, c, chunk=chunk, backend="torch")
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


def _wide_against_plain(x, a, b, c, chunk):
    ops.reset_launches()
    got = ops.ssd_scan(x, a, b, c, chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == 1
    want = ops.ssd_scan(x, a, b, c, chunk=chunk, backend="torch")
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("P,N", [(65, 65), (136, 200), (200, 136),
                                 (256, 256), (192, 256), (65, 256)])
@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_ssd_scan_wide_kernel_widths_off_its_tiles(dev, P, N, chunk):
    """P or N not a multiple of the kernel's 64-wide tiles (the wrapper
    pads them with zeros), P != N, and every chunk the tiles cut: 32 and
    64 (one warpgroup of rows) and 128 (two), over 8 to 32 chunks."""
    x, a, b, c = _ssd_inputs(P * N + chunk, 1, 1024, 2, P, N, dev)
    _wide_against_plain(x, a, b, c, chunk)


@pytest.mark.parametrize("S,chunk", [(128, 128), (64, 64), (32, 32),
                                     (100, 128)])
def test_ssd_scan_wide_kernel_one_chunk(dev, S, chunk):
    """One chunk: no state launch, the output launch alone (S = 100 runs
    one ragged chunk of Q = S)."""
    x, a, b, c = _ssd_inputs(S + chunk, 2, S, 3, 192, 192, dev)
    _wide_against_plain(x, a, b, c, chunk)


def test_ssd_scan_wide_kernel_runs_and_carry(dev):
    """Many chunks a (b, h): the state launch walks runs of R chunks and
    the carry crosses the runs; a chunk count whose hand-ons (nc - 1) are
    not a multiple of R leaves a short last run, whose partial states the
    output launch corrects with the carried run-start state."""
    lib = build.library("ssd_scan_wide")
    for nc in (40, 67, 101):
        R = lib.ssd_scan_wide_run_length(1, 1, 192, 192, nc)
        runs = -(-(nc - 1) // R)
        if R > 1 and runs > 1 and (nc - 1) % R:
            break
    else:
        pytest.fail("no chunk count gives several runs with a short last "
                    "one")
    x, a, b, c = _ssd_inputs(nc, 1, nc * 128, 1, 192, 192, dev)
    _wide_against_plain(x, a, b, c, 128)


@pytest.mark.parametrize("B,H", [(1, 1), (8, 8)])
def test_ssd_scan_wide_kernel_one_and_64_heads(dev, B, H):
    """B H = 1 (the runs fill the card) and B H = 64 (one run a head)."""
    x, a, b, c = _ssd_inputs(B * H, B, 1024, H, 192, 192, dev)
    _wide_against_plain(x, a, b, c, 128)


@pytest.mark.parametrize("off", [1, 2, 3])
def test_ssd_scan_wide_kernel_unaligned_data(dev, off):
    """x, a, b and c whose data_ptr is not 16-byte aligned (views 4, 8 or
    12 bytes into a buffer): the wrapper hands the kernel aligned copies."""
    x, a, b, c = _ssd_inputs(off, 1, 512, 3, 192, 192, dev)

    def shifted(t):
        buf = torch.zeros(t.numel() + off, device=dev)
        v = buf[off:].view(t.shape)
        v.copy_(t)
        return v

    xs, as_, bs, cs = (shifted(t) for t in (x, a, b, c))
    assert all(t.data_ptr() % 16 for t in (xs, bs, cs))
    _wide_against_plain(xs, as_, bs, cs, 128)


def test_ssd_scan_narrow_heads_keep_the_narrow_kernel(dev, monkeypatch):
    """P, N <= 64 launch ssd_scan.cu's kernel and never the wide one; a
    head of 65 launches the wide one.  The wide library states its
    maximum, which the wrapper checks against."""
    assert build.library("ssd_scan_wide").ssd_scan_wide_max_width() == \
        ops._SSD_WIDE_MAX
    used = []
    real = build.library

    def library(name):
        used.append(name)
        return real(name)

    monkeypatch.setattr(build, "library", library)
    for P, N in ((64, 64), (16, 64), (64, 8), (65, 64), (64, 65)):
        x, a, b, c = _ssd_inputs(P + N, 2, 256, 8, P, N, dev)
        used.clear()
        got = ops.ssd_scan(x, a, b, c)
        wide = P > 64 or N > 64
        assert used == ["ssd_scan_wide" if wide else "ssd_scan"], (P, N)
        want = ops.ssd_scan(x, a, b, c, backend="torch")
        torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.fixture
def smoke_hybrid(dev):
    from repro_torch.models import registry, transformer
    cfg = registry.get("zamba2-7b", smoke=True)
    g = torch.Generator()
    g.manual_seed(0)
    cpu = transformer.init_params(cfg, g, device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(dev)


def test_hybrid_forward_on_card_equals_cpu(smoke_hybrid, dev):
    from repro_torch.models import transformer
    cfg, cpu, card = smoke_hybrid
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 256)).astype(
        np.int32))
    n_groups = cfg.n_layers // cfg.attn_every
    ops.reset_launches()
    got, _ = transformer.forward(cfg, card, {"tokens": tok.to(dev)},
                                 use_kernel=True)
    assert ops.LAUNCHES["ssd_scan"] == cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == n_groups
    assert sum(ops.LAUNCHES.values()) == cfg.n_layers + n_groups
    plain, _ = transformer.forward(cfg, card, {"tokens": tok.to(dev)})
    assert sum(ops.LAUNCHES.values()) == cfg.n_layers + n_groups
    want, _ = transformer.forward(cfg, cpu, {"tokens": tok}, use_kernel=True)
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(plain.cpu(), want, rtol=1e-4, atol=1e-4)


def test_hybrid_greedy_engine_on_card_equals_cpu(smoke_hybrid, dev):
    from repro_torch.models.decode_engine import Engine, ServeConfig
    cfg, cpu, card = smoke_hybrid
    outs = []
    for model, where in ((card, dev), (cpu, "cpu")):
        eng = Engine(cfg, model, ServeConfig(max_len=64), batch_slots=3,
                     device=where)
        for p in ([5, 6, 7], [11, 12], list(range(20, 40))):
            eng.submit(p)
        ops.reset_launches()
        outs.append(eng.run(max_new_tokens=40))
        assert not any(ops.LAUNCHES.values())  # decode: mamba2_step, no scan
    assert outs[0] == outs[1]
    assert all(len(o) > 0 for o in outs[0])


# ---------- the JobServer and the MoE family ----------


def test_job_server_on_card_equals_solo_runs(dev):
    """Two jobs interleaved on one `JobServer(Local())`: the in-memory
    `assemble` of `test_assemble_on_card_equals_cpu`'s plan and a gapped
    `assemble_stream`, each equal to its solo run on the card."""
    from repro_torch.serving import JobServer, JobSpec, JobState
    comm = mgsim.sample_community(5, num_genomes=3, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(6, comm, num_pairs=400, read_len=60,
                                    err_rate=0.003)
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.2)
    splan = AssemblyPlan.from_stream(256, 60, (17, 21, 4),
                                     unique_kmers=1000, slack=4.0,
                                     gapped_align=True)
    batches = batches_from_readset(reads, 256)
    solo = Assembler(plan, Local(dev)).assemble(reads)
    ssolo = Assembler(splan, Local(dev)).assemble_stream(batches)
    srv = JobServer(Local(dev), budget_bytes=plan.bytes() + splan.bytes())
    a = srv.submit(JobSpec("mem", reads=reads, plan=plan))
    b = srv.submit(JobSpec("stream", batches=batches, plan=splan))
    ops.reset_launches()
    srv.run()
    assert a.state == b.state == JobState.DONE, (a.error, b.error)
    assert min(a.events, b.events) > 0
    assert all(ops.LAUNCHES[n] > 0 for n in ASSEMBLY_KERNELS), ops.LAUNCHES
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["ssd_scan"] == 0
    for got, want in ((srv.result("mem"), solo),
                      (srv.result("stream"), ssolo)):
        for key in ASSEMBLE_KEYS:  # both on the card
            g, w = got[key], want[key]
            _same(g if isinstance(g, tuple) else (g,),
                  w if isinstance(w, tuple) else (w,))
        assert got["stats"] == want["stats"]
    assert srv.result("stream")["stream_stats"] == ssolo["stream_stats"]


def test_moe_forward_on_card_equals_cpu(dev):
    """The SMOKE qwen2-moe's kernel path (flash at every layer) on the
    card against the CPU run, logits and aux loss; its dispatch runs the
    card's sort, ranks and filtered scatters, and an atomic combine."""
    from repro_torch.models import registry, transformer
    cfg = registry.get("qwen2-moe-a2.7b", smoke=True)
    g = torch.Generator()
    g.manual_seed(0)
    cpu = transformer.init_params(cfg, g, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 128)).astype(
        np.int32))
    ops.reset_launches()
    got, aux = transformer.forward(cfg, card, {"tokens": tok.to(dev)},
                                   use_kernel=True)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert sum(ops.LAUNCHES.values()) == cfg.n_layers
    want, want_aux = transformer.forward(cfg, cpu, {"tokens": tok},
                                         use_kernel=True)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)


# ---------- the xLSTM family ----------


def test_xlstm_forward_and_engine_on_card_equal_cpu(dev):
    """The SMOKE xLSTM with 192-wide mLSTM heads (d 384, 2 heads): the
    kernel path (the wide ssd_scan once an mLSTM block) and the plain path
    on the card against the CPU run, and the greedy Engine."""
    from repro_torch.models import registry, transformer
    from repro_torch.models.decode_engine import Engine, ServeConfig
    cfg = dataclasses.replace(registry.get("xlstm-125m", smoke=True),
                              d_model=384)
    g = torch.Generator()
    g.manual_seed(0)
    cpu = transformer.init_params(cfg, g, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 256)).astype(
        np.int32))
    ops.reset_launches()
    got, _ = transformer.forward(cfg, card, {"tokens": tok.to(dev)},
                                 use_kernel=True)
    assert ops.LAUNCHES["ssd_scan"] == cfg.n_layers // 2
    assert sum(ops.LAUNCHES.values()) == cfg.n_layers // 2
    plain, _ = transformer.forward(cfg, card, {"tokens": tok.to(dev)})
    want, _ = transformer.forward(cfg, cpu, {"tokens": tok})
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(plain.cpu(), want, rtol=1e-4, atol=1e-4)
    outs = []
    for model, where in ((card, dev), (cpu, "cpu")):
        eng = Engine(cfg, model, ServeConfig(max_len=64), batch_slots=3,
                     device=where)
        for p in ([5, 6, 7], [11, 12], list(range(20, 40))):
            eng.submit(p)
        ops.reset_launches()
        outs.append(eng.run(max_new_tokens=40))
        assert not any(ops.LAUNCHES.values())  # decode: the steps, no scan
    assert outs[0] == outs[1]


def test_train_steps_on_card_equal_cpu(dev):
    """`launch.train_step` on the SMOKE llama, the card against the CPU:
    three steps with fp32 moments (the losses and parameters at 1e-4), and
    one with int8 moments (the loss and parameters at 1e-4, the int8
    moments within one quantum: past one step the reference's int8 v
    turns a one-quantum difference into a step of hundreds of lr, ROADMAP
    Queue 3); no kernel launched (the training forward is the plain
    path)."""
    from repro_torch.launch import train as launch
    from repro_torch.models import registry, transformer
    from repro_torch.train import optimizer as opt

    cfg = registry.get("llama3.2-3b", smoke=True)
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu = transformer.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (3, 4, 32), generator=gen,
                           dtype=torch.int32)
    for quantize, steps in ((False, 3), (True, 1)):
        adam = opt.AdamConfig(quantize_moments=quantize)
        models = {"cpu": copy.deepcopy(cpu),
                  "cuda": copy.deepcopy(cpu).to(dev)}
        losses, states = {}, {}
        ops.reset_launches()
        for where, model in models.items():
            states[where] = opt.init_state(model, adam)
            losses[where] = [float(launch.train_step(
                cfg, model, states[where], {"tokens": t.to(where)}, adam)[0])
                for t in tokens[:steps]]
        assert not any(ops.LAUNCHES.values())
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
        for (n, p), q in zip(models["cpu"].named_parameters(),
                             models["cuda"].parameters()):
            np.testing.assert_allclose(q.detach().cpu().numpy(),
                                       p.detach().numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=n)
        if quantize:
            for k in ("m", "v"):
                for n, st in states["cpu"][k].items():
                    card = states["cuda"][k][n].value.cpu().int()
                    assert (card - st.value.int()).abs().max() <= 1, n


def test_lm_ops_refuse_gradients_on_the_card(dev):
    q = torch.randn((1, 2, 64, 64), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q, q, q)
    x = torch.randn((1, 64, 2, 16), device=dev, requires_grad=True)
    a = torch.zeros((1, 64, 2), device=dev)
    bc = torch.randn((1, 64, 2, 16), device=dev)
    with pytest.raises(ValueError, match="no backward"):
        ops.ssd_scan(x, a, bc, bc, chunk=32)
