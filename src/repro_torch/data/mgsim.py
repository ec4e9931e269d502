"""MGSim: synthetic metagenome generator (paper §IV-A; mirrors
`repro.data.mgsim`).

Genomes are sampled, each is given a log-normal relative abundance, and
error-bearing paired-end reads are drawn from them (WGSim style).  Host
numpy, with the reference's draws in the reference's order, so a seed
gives the same reads here and there; the reads become torch tensors (on
the CPU) at the end.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.types import ReadSet


@dataclass
class Community:
    genomes: list           # list of np.uint8 arrays (0..3)
    abundances: np.ndarray  # [G] float, sums to 1
    names: list = field(default_factory=list)


@dataclass
class ReadTruth:
    """Ground truth per read (for evaluation only, never assembled from)."""

    genome_id: np.ndarray  # [R] int32
    pos: np.ndarray        # [R] int32 start on the forward strand
    strand: np.ndarray     # [R] uint8 0=fwd, 1=rc


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def mutate_genome(rng: np.random.Generator, genome: np.ndarray,
                  divergence: float) -> np.ndarray:
    """Derive a related strain: substitute a `divergence` fraction of bases."""
    g = genome.copy()
    n_mut = int(len(g) * divergence)
    pos = rng.choice(len(g), size=n_mut, replace=False)
    g[pos] = (g[pos] + rng.integers(1, 4, size=n_mut)) % 4
    return g


def sample_community(seed: int, num_genomes: int,
                     genome_len: int | tuple = 2000,
                     abundance_sigma: float = 1.0, strain_pairs: int = 0,
                     strain_divergence: float = 0.01) -> Community:
    """Log-normal-abundance community, plus `strain_pairs` mutated strains."""
    rng = np.random.default_rng(seed)
    if isinstance(genome_len, int):
        lens = [genome_len] * num_genomes
    else:
        lens = list(rng.integers(genome_len[0], genome_len[1],
                                 size=num_genomes))
    genomes = [random_genome(rng, int(L)) for L in lens]
    for i in range(strain_pairs):
        src = i % max(1, len(genomes))
        genomes.append(mutate_genome(rng, genomes[src], strain_divergence))
    ab = rng.lognormal(mean=0.0, sigma=abundance_sigma, size=len(genomes))
    ab = ab / ab.sum()
    names = [f"genome_{i}" for i in range(len(genomes))]
    return Community(genomes=genomes, abundances=ab, names=names)


_RC = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def rc_np(seq: np.ndarray) -> np.ndarray:
    return _RC[seq[::-1]]


def generate_reads(seed: int, community: Community, num_pairs: int,
                   read_len: int = 60, insert_mean: int = 180,
                   insert_sd: int = 10, err_rate: float = 0.0
                   ) -> tuple[ReadSet, ReadTruth]:
    """WGSim-style paired-end reads with substitution errors.

    Reads 2i and 2i+1 are mates: 2i is the forward-strand prefix of the
    fragment, 2i+1 the reverse complement of its suffix (fr orientation).
    """
    rng = np.random.default_rng(seed)
    G = len(community.genomes)
    gid = rng.choice(G, size=num_pairs, p=community.abundances)
    R = 2 * num_pairs
    bases = np.full((R, read_len), 4, dtype=np.uint8)
    lengths = np.full((R,), read_len, dtype=np.int32)
    mate = np.arange(R, dtype=np.int32) ^ 1
    t_gid = np.zeros((R,), np.int32)
    t_pos = np.zeros((R,), np.int32)
    t_strand = np.zeros((R,), np.uint8)
    for i in range(num_pairs):
        g = community.genomes[gid[i]]
        insert = max(2 * read_len, int(rng.normal(insert_mean, insert_sd)))
        insert = min(insert, len(g))
        start = rng.integers(0, max(1, len(g) - insert + 1))
        frag = g[start : start + insert]
        flip = rng.integers(0, 2)
        if flip:
            frag = rc_np(frag)
        r1 = frag[:read_len].copy()
        r2 = rc_np(frag[-read_len:])
        for j, r in ((2 * i, r1), (2 * i + 1, r2)):
            if err_rate > 0:
                errs = rng.random(read_len) < err_rate
                n_err = int(errs.sum())
                if n_err:
                    r[errs] = (r[errs] + rng.integers(1, 4, size=n_err)) % 4
            bases[j, : len(r)] = r
            t_gid[j] = gid[i]
            t_strand[j] = flip
        t_pos[2 * i] = start if not flip else start + insert - read_len
        t_pos[2 * i + 1] = start + insert - read_len if not flip else start
    reads = ReadSet(
        bases=torch.from_numpy(bases),
        lengths=torch.from_numpy(lengths),
        mate=torch.from_numpy(mate),
        insert_size=insert_mean,
    )
    return reads, ReadTruth(genome_id=t_gid, pos=t_pos, strand=t_strand)


def generate_read_batches(seed: int, community: Community, num_pairs: int,
                          *, pairs_per_batch: int, read_len: int = 60,
                          insert_mean: int = 180, insert_sd: int = 10,
                          err_rate: float = 0.0):
    """Yield fixed-shape `[2 * pairs_per_batch, read_len]` ReadSet batches.

    The data source of the out-of-core pipeline: batches are generated on
    demand, batch b from seed `seed + b`, so regeneration is deterministic
    and `repro_torch.stream.BatchSource` makes it re-iterable:

        src = BatchSource(lambda: generate_read_batches(0, comm, 10**9,
                                                        pairs_per_batch=4096))

    The final short batch pads with inert rows (zero length, INVALID
    bases, mate -1).
    """
    if pairs_per_batch < 1:
        raise ValueError(f"pairs_per_batch={pairs_per_batch} must be >= 1")
    B = 2 * pairs_per_batch
    done = 0
    batch_idx = 0
    while done < num_pairs:
        n = min(pairs_per_batch, num_pairs - done)
        reads, _ = generate_reads(
            seed + batch_idx, community, n, read_len=read_len,
            insert_mean=insert_mean, insert_sd=insert_sd, err_rate=err_rate)
        if 2 * n < B:
            pad = B - 2 * n
            reads = ReadSet(
                bases=torch.cat([reads.bases, torch.full(
                    (pad, read_len), 4, dtype=torch.uint8)]),
                lengths=torch.cat([reads.lengths, torch.zeros(
                    (pad,), dtype=torch.int32)]),
                mate=torch.cat([reads.mate, torch.full(
                    (pad,), -1, dtype=torch.int32)]),
                insert_size=reads.insert_size,
            )
        yield reads
        done += n
        batch_idx += 1


def single_genome_reads(seed: int, genome_len: int = 1000,
                        coverage: float = 20.0, read_len: int = 60,
                        err_rate: float = 0.0, **kw):
    """One genome at a target coverage: (genome, reads, truth)."""
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    comm = Community(genomes=[genome], abundances=np.array([1.0]))
    num_pairs = int(coverage * genome_len / (2 * read_len))
    reads, truth = generate_reads(seed + 1, comm, num_pairs,
                                  read_len=read_len, err_rate=err_rate, **kw)
    return genome, reads, truth
