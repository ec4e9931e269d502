"""The slice end to end: port `Assembler(plan, Local("cpu")).assemble`
against JAX `Assembler(plan, Local()).assemble`, and each Algorithm 3
module of the port on the reference's own intermediate arrays.

Fixture: `tests/test_pipeline.py`'s `SMALL_PLAN` (k = 17 then 21, local
assembly on) on the community of `test_assemble_community_quality`.
Module tests take the reference run's arrays through `repro_torch.bridge`:
link aggregation from the reference's candidate witnesses, repeat
suspension, connected components, greedy matching and chain formation
from the reference's links, and gap closing from the reference's
scaffolds.  A second run of both passes `hmm_hit`, every other live
contig flagged.  Tolerance: exact everywhere, float32 link and scaffold gaps
included (each witness gap is an integer and their sums stay below
2**24, so the float32 sums are exact in any order).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import Assembler as JAssembler, Local as JLocal
from repro.core import scaffolding as jscaf
from repro.data import mgsim as jmgsim
from repro_torch import bridge
from repro_torch.api import Assembler, Local
from repro_torch.api.assembler import aligned_frac
from repro_torch.core import cc, gap_closing, scaffolding
from repro_torch.core.alignment import Alignments
from repro_torch.core.scaffolding import Links, Scaffolds
from repro_torch.core.types import ContigSet, ReadSet
from test_pipeline import SMALL_PLAN

RESULT_RECORDS = ("contigs", "alignments", "links", "scaffolds",
                  "scaffold_seqs")
RESULT_ARRAYS = ("alive", "suspended", "components")


def _plan():
    fields = dataclasses.asdict(SMALL_PLAN)
    fields["policy"] = tuple(SMALL_PLAN.policy)
    return bridge.plan_from_fields(fields)


@pytest.fixture(scope="module")
def runs():
    comm = jmgsim.sample_community(32, num_genomes=3, genome_len=500,
                                   abundance_sigma=0.3)
    jreads, _ = jmgsim.generate_reads(33, comm, num_pairs=600, read_len=60,
                                      err_rate=0.003)
    want = JAssembler(SMALL_PLAN, JLocal()).assemble(jreads)
    reads = ReadSet(*(bridge.tensor(np.asarray(getattr(jreads, f)))
                      for f in ("bases", "lengths", "mate")),
                    jreads.insert_size)
    got = Assembler(_plan(), Local(device="cpu")).assemble(reads)
    return jreads, reads, want, got


def _hmm_mask(alive):
    """Every other live contig flagged as an HMM hit (§III-C)."""
    idx = np.arange(len(alive))
    return np.asarray(alive) & (idx % 2 == 0)


@pytest.fixture(scope="module")
def hmm_runs(runs):
    """A second run of both packages with `hmm_hit` flagging live contigs
    (the reference's reuses the first run's compiled functions)."""
    jreads, reads, want, _ = runs
    mask = _hmm_mask(want["alive"])
    want_h = JAssembler(SMALL_PLAN, JLocal()).assemble(
        jreads, hmm_hit=jnp.asarray(mask))
    got_h = Assembler(_plan(), Local(device="cpu")).assemble(
        reads, hmm_hit=torch.from_numpy(mask))
    return mask, want_h, got_h


def _eq(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _eq_record(got, want, what):
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f), f"{what}.{f}")


@pytest.mark.parametrize("key", RESULT_RECORDS)
def test_result_record_matches(runs, key):
    _, _, want, got = runs
    _eq_record(got[key], want[key], key)


@pytest.mark.parametrize("key", RESULT_ARRAYS)
def test_result_array_matches(runs, key):
    _, _, want, got = runs
    _eq(got[key], want[key], key)


def test_result_stats_overflow_and_plan_match(runs):
    _, _, want, got = runs
    assert [dataclasses.asdict(s) for s in got["stats"]] == \
        [dataclasses.asdict(s) for s in want["stats"]]
    assert any(s.extended_bases > 0 for s in got["stats"])
    assert got["overflow"] == want["overflow"]
    assert set(got) == set(want)
    fields = dataclasses.asdict(got["plan"])
    ref = dataclasses.asdict(want["plan"])
    for key in ("policy", "kernel_backend"):
        fields.pop(key), ref.pop(key)
    assert fields == ref


def test_slice_produces_scaffolds(runs):
    _, _, want, got = runs
    seqs = got["scaffold_seqs"]
    assert int(seqs.n_scaffolds) > 0 and int(seqs.lengths.max()) >= 300
    assert int(got["links"].valid.sum()) > 0


@pytest.mark.parametrize("key", RESULT_RECORDS + RESULT_ARRAYS)
def test_assemble_with_hmm_hit_matches(hmm_runs, key):
    """`assemble(reads, hmm_hit=...)` equals the reference's run with the
    same mask, bit for bit."""
    mask, want, got = hmm_runs
    assert mask.sum() > 0
    if key in RESULT_RECORDS:
        _eq_record(got[key], want[key], key)
    else:
        _eq(got[key], want[key], key)


def _ref_inputs(runs):
    jreads, reads, want, _ = runs
    jal = want["alignments"]
    jalive = want["alive"]
    jclens = jnp.where(jalive, want["contigs"].lengths, 0)
    jcands = jscaf.candidate_links(jal, jreads, jclens)
    al = bridge.to_torch(jal, Alignments)
    alive = bridge.tensor(np.asarray(jalive))
    contigs = bridge.to_torch(want["contigs"], ContigSet)
    return jcands, al, alive, contigs


def test_link_witnesses_and_aggregation(runs):
    jreads, reads, want, _ = runs
    jcands, al, alive, contigs = _ref_inputs(runs)
    clens = bridge.tensor(np.asarray(
        jnp.where(want["alive"], want["contigs"].lengths, 0)))
    cands = scaffolding.candidate_links(al, reads, clens)
    for g, w, name in zip(cands, jcands, ("ea", "eb", "gap", "valid",
                                          "is_splint")):
        _eq(g, w, name)
    # every witness gap is an integer and their sums stay below 2**24:
    # the float32 sums are exact whatever the order of the additions
    gap, valid = np.asarray(jcands[2]), np.asarray(jcands[3])
    assert (gap[valid] == np.round(gap[valid])).all()
    assert np.abs(gap[valid]).sum() < 2 ** 24
    plan = SMALL_PLAN
    jlinks = jscaf.links_from_candidates(
        *jcands, want["alive"], capacity=plan.link_capacity,
        min_support=plan.min_link_support)
    links = scaffolding.links_from_candidates(
        *(bridge.tensor(np.asarray(x)) for x in jcands), alive,
        capacity=plan.link_capacity, min_support=plan.min_link_support)
    _eq_record(links, jlinks, "links")


def _ref_links(runs):
    _, _, want, _ = runs
    jcands, _, _, _ = _ref_inputs(runs)
    return jscaf.links_from_candidates(
        *jcands, want["alive"], capacity=SMALL_PLAN.link_capacity,
        min_support=SMALL_PLAN.min_link_support)


def test_scaffold_from_reference_links(runs):
    """Suspension, components, matching and chains from the reference's
    links equal the reference run's outputs."""
    jreads, _, want, _ = runs
    _, _, alive, contigs = _ref_inputs(runs)
    links = bridge.to_torch(_ref_links(runs), Links)
    scaffs, links2, suspended, comp = scaffolding.scaffold_from_links(
        links, contigs, alive, float(jreads.insert_size),
        max_members=SMALL_PLAN.max_members)
    _eq_record(scaffs, want["scaffolds"], "scaffolds")
    _eq_record(links2, want["links"], "links after suspension")
    _eq(suspended, want["suspended"], "suspended")
    _eq(comp, want["components"], "components")


def test_suspension_matching_and_chains_stage_by_stage(runs):
    jreads, _, want, _ = runs
    _, _, alive, contigs = _ref_inputs(runs)
    jlinks = _ref_links(runs)
    C = contigs.capacity
    n_ends = 2 * C
    ins = float(jreads.insert_size)
    jl2, jsus = jscaf.suspend_repeats(jlinks, want["contigs"].lengths, ins,
                                      n_ends)
    l2, sus = scaffolding.suspend_repeats(bridge.to_torch(jlinks, Links),
                                          contigs.lengths, ins, n_ends)
    _eq_record(l2, jl2, "suspend_repeats links")
    _eq(sus, jsus, "suspend_repeats suspended")
    jends, jcnt = jscaf._per_end_links(jl2, n_ends)
    ends, cnt = scaffolding._per_end_links(bridge.to_torch(jl2, Links),
                                           n_ends)
    _eq(ends, jends, "per-end links")
    _eq(cnt, jcnt, "per-end counts")
    jalive_eff = want["alive"] & ~jsus
    jlens = jnp.where(jalive_eff, want["contigs"].lengths, 0)
    jm, jg = jscaf.greedy_matching(jl2, jlens, jnp.zeros((C,), bool),
                                   n_ends=n_ends)
    m, g = scaffolding.greedy_matching(
        bridge.to_torch(jl2, Links), bridge.tensor(np.asarray(jlens)),
        bridge.tensor(np.zeros(C, bool)), n_ends=n_ends)
    _eq(m, jm, "matched_end")
    _eq(g, jg, "end_gap")
    assert int((m >= 0).sum()) > 0
    scaffs = scaffolding.form_scaffolds(
        bridge.tensor(np.asarray(jm)), bridge.tensor(np.asarray(jg)),
        bridge.tensor(np.asarray(jalive_eff)), n_contigs=C,
        max_members=SMALL_PLAN.max_members)
    _eq_record(scaffs, want["scaffolds"], "form_scaffolds")
    comp = cc.connected_components(
        scaffolding._half(l2.end_a).clamp(min=0),
        scaffolding._half(l2.end_b).clamp(min=0), l2.valid, C)
    _eq(comp, want["components"], "connected_components")


def test_scaffold_entry_point(runs):
    """`scaffolding.scaffold` (links built from the alignments, then
    Algorithm 3 minus gap closing) on the reference's final contigs and
    alignments."""
    jreads, reads, want, _ = runs
    _, al, alive, contigs = _ref_inputs(runs)
    kw = dict(link_capacity=SMALL_PLAN.link_capacity,
              min_support=SMALL_PLAN.min_link_support,
              max_members=SMALL_PLAN.max_members)
    jout = jscaf.scaffold(want["alignments"], jreads, want["contigs"],
                          want["alive"], **kw)
    out = scaffolding.scaffold(al, reads, contigs, alive, **kw)
    _eq_record(out[0], jout[0], "scaffolds")
    _eq_record(out[1], jout[1], "links")
    _eq(out[2], jout[2], "suspended")
    _eq(out[3], jout[3], "components")
    _eq_record(out[0], want["scaffolds"], "scaffolds vs the run")


def test_gap_closing_from_reference_scaffolds(runs):
    jreads, reads, want, _ = runs
    _, al, _, contigs = _ref_inputs(runs)
    k_last = SMALL_PLAN.ks()[-1]
    seqs = gap_closing.close_and_render(
        bridge.to_torch(want["scaffolds"], Scaffolds), contigs, reads,
        al.contig[:, 0], seed_len=min(k_last, 25),
        mer_sizes=SMALL_PLAN.ladder(k_last),
        walk_capacity=SMALL_PLAN.walk_capacity,
        max_scaffold_len=SMALL_PLAN.max_scaffold_len)
    _eq_record(seqs, want["scaffold_seqs"], "scaffold_seqs")


@pytest.mark.parametrize("n_reads", [7, 1200, 1800, 240_000, 600_000])
def test_aligned_frac_is_the_reference_mean(n_reads):
    """IterationStats.aligned_frac: the reference's jnp mean of a bool
    column, for many aligned counts."""
    counts = np.unique(np.r_[0, 1, n_reads - 7, n_reads - 1, n_reads,
                             np.random.default_rng(n_reads).integers(
                                 0, n_reads + 1, 40)].clip(0, n_reads))
    col = np.zeros(n_reads, bool)
    for n in counts:
        col[:] = False
        col[:n] = True
        assert aligned_frac(int(n), n_reads) == float(jnp.asarray(col).mean())
