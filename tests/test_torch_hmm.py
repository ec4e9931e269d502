"""The port's profile-HMM scorer (`core.hmm`) against `repro.core.hmm`.

Fixtures: the planted-region case of tests/test_graph_utils.py (a
100-base profile, a contig holding a 2%-mutated copy and a random
contig), and the genomes of benchmarks/bench_quality.py's
`planted_community(40)` scored with its 120-base rRNA profile, beside a
seeded random row, an empty row and an N run.  Tolerance: profiles,
scores and flags exact (the port keeps the reference's order of float32
additions and maxima; the scores came out equal bit for bit, so no
tolerance is used).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.bench_quality import planted_community
from repro.core import hmm as jhmm
from repro.data import mgsim as jmgsim
from repro_torch.core import hmm


def _planted_region():
    """tests/test_graph_utils.py's fixture."""
    rng = np.random.default_rng(3)
    rrna = jmgsim.random_genome(rng, 100)
    host = jmgsim.random_genome(rng, 300)
    mut = rrna.copy()
    pos = rng.choice(100, 2, replace=False)
    mut[pos] = (mut[pos] + 1) % 4
    planted = np.concatenate([host[:100], mut, host[100:200]])
    contigs = np.full((2, 320), 4, np.uint8)
    contigs[0, :len(planted)] = planted
    contigs[1, :300] = jmgsim.random_genome(rng, 300)
    return rrna, contigs, np.asarray([len(planted), 300], np.int32)


def _planted_community():
    """bench_quality's genomes as contig rows, plus a random row, an empty
    row and a row whose copy of the rRNA is cut by an N run."""
    comm, rrna = planted_community(40)
    genomes = comm.genomes
    width = max(len(g) for g in genomes) + 20
    rows = np.full((len(genomes) + 3, width), 4, np.uint8)
    lens = np.zeros(len(rows), np.int32)
    for i, g in enumerate(genomes):
        rows[i, :len(g)] = g
        lens[i] = len(g)
    rng = np.random.default_rng(11)
    rows[len(genomes), :500] = jmgsim.random_genome(rng, 500)
    lens[len(genomes)] = 500
    rows[-1] = rows[0]
    rows[-1, 200:260] = 4
    lens[-1] = lens[0]
    return rrna, rows, lens


FIXTURES = {"planted_region": _planted_region,
            "planted_community": _planted_community}


def _both(name):
    rrna, bases, lens = FIXTURES[name]()
    jprof, prof = jhmm.build_profile([rrna]), hmm.build_profile([rrna])
    want = jhmm.hmm_hits(jprof, jnp.asarray(bases), jnp.asarray(lens))
    got = hmm.hmm_hits(prof, torch.from_numpy(bases),
                       torch.from_numpy(lens))
    return (jprof, prof), want, got


@pytest.mark.parametrize("name", list(FIXTURES))
def test_profile_matches(name):
    (jprof, prof), _, _ = _both(name)
    np.testing.assert_array_equal(prof.match_logp.numpy(),
                                  np.asarray(jprof.match_logp))
    assert prof.log_t == jprof.log_t and prof.length == jprof.length


@pytest.mark.parametrize("name", list(FIXTURES))
def test_scores_and_flags_match(name):
    _, (jflags, jscores), (flags, scores) = _both(name)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
    assert scores.dtype == torch.float32
    assert bool(flags[0]) and not bool(flags[1] if name == "planted_region"
                                       else flags[-3])


def test_viterbi_score_of_one_sequence():
    rrna, bases, lens = _planted_region()
    jprof, prof = jhmm.build_profile([rrna]), hmm.build_profile([rrna])
    for i in range(2):
        want = jhmm.viterbi_score(jprof, jnp.asarray(bases[i]), int(lens[i]))
        got = hmm.viterbi_score(prof, torch.from_numpy(bases[i]),
                                int(lens[i]))
        assert float(got) == float(want)
