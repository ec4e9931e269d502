"""The port's assembly JobServer (`repro_torch.serving`) against the JAX
package's (`repro.serving`), on the CPU.

Mirrors `tests/test_serving.py` test for test on the port (spec, price,
workflow, `to_cwl`, the state machine, the scheduler, the server with a
stub generator, the per-job checkpoint directory, the streamed jobs, the
hook and `drive`), and holds the port to the reference:

  * pricing: for the same plans, `price(...).bytes()`, `stage_bytes()`,
    `workflow` and `to_cwl` equal the reference's;
  * with the stub generator in both servers (`_fake_start`), one scenario
    (an over-budget refusal, priority, backfill, cancel while queued and
    while running, pause and resume) gives the same admission order and
    the same journal, every field but `wall`;
  * on `tests/test_serving.py`'s `stream_world` (2 genomes of 300 bp, 96
    pairs of 50 bp, batches of 64 reads), one module-scoped JAX solo
    `assemble_stream` a source, its stage events recorded: the port's
    jobs on `Local("cpu")` (two multiplexed, a paused and resumed one,
    one killed and recovered by a new server over the same journal)
    return the JAX result bit for bit, up to `StreamStats.resumed`; the
    multiplexed run's journal equals the one the reference's server
    writes for the reference's own events.

Tolerance: exact everywhere (integer work; the streamed aligned_frac is
the same Python division in both packages).
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from repro.api import Assembler as JAssembler, AssemblyPlan as JPlan, \
    Local as JLocal
from repro.data import mgsim as jmgsim
from repro.serving import JobServer as JJobServer, JobSpec as JJobSpec, \
    JobState as JJobState, to_cwl as jto_cwl, workflow as jworkflow
from repro.serving.jobs import price as jprice
from repro.stream import batches_from_readset as jbatches_from_readset
from repro.stream import job_checkpoint_dir as jjob_checkpoint_dir
from repro_torch import bridge
from repro_torch.api import Assembler, AssemblyPlan, Local
from repro_torch.api.assembler import STAGES, drive
from repro_torch.core.types import ReadSet
from repro_torch.serving import (
    BudgetScheduler,
    JobError,
    JobServer,
    JobSpec,
    JobState,
    Unschedulable,
    to_cwl,
    workflow,
)
from repro_torch.serving.jobs import Job, price
from repro_torch.stream import batches_from_readset, job_checkpoint_dir

RESULT_KEYS = ("contigs", "alive", "alignments", "links", "suspended",
               "components", "scaffolds", "scaffold_seqs")


def _port_reads(jreads) -> ReadSet:
    return ReadSet(*(bridge.tensor(np.asarray(getattr(jreads, f)))
                     for f in ("bases", "lengths", "mate")),
                   jreads.insert_size)


# ---------------------------------------------------------------------------
# specs, pricing, workflow declaration (no pipeline compute)
# ---------------------------------------------------------------------------


def test_jobspec_requires_exactly_one_source():
    with pytest.raises(JobError, match="exactly one"):
        JobSpec("both", reads=object(), batches=object()).validate()
    with pytest.raises(JobError, match="exactly one"):
        JobSpec("neither").validate()
    with pytest.raises(JobError, match="name"):
        JobSpec("", reads=object()).validate()


@pytest.fixture(scope="module")
def genome_reads():
    _, jreads, _ = jmgsim.single_genome_reads(7, genome_len=200, coverage=5)
    return jreads, _port_reads(jreads)


def test_price_binds_dataset_for_admission(genome_reads):
    _, reads = genome_reads
    plan = price(JobSpec("j", reads=reads))
    assert plan.dataset_shape == (int(reads.num_reads), int(reads.max_len))
    assert plan.bytes() > 0
    # an explicit unbound plan gets bound too, so bytes() prices the
    # read-proportional buffers instead of treating them as zero
    explicit = price(JobSpec("j", reads=reads, plan=AssemblyPlan()))
    assert explicit.dataset_shape is not None


# spec kwargs from (reads, batches, AssemblyPlan) of either package:
# in-memory derived, explicit and sharded; streamed derived, sharded and
# explicit
PRICE_CASES = {
    "dataset": lambda r, b, P: dict(reads=r),
    "dataset_explicit": lambda r, b, P: dict(reads=r, plan=P()),
    "dataset_4_shards": lambda r, b, P: dict(
        reads=r, plan_overrides={"num_shards": 4}),
    "stream": lambda r, b, P: dict(batches=b),
    "stream_4_shards": lambda r, b, P: dict(
        batches=b, plan_overrides={"num_shards": 4, "unique_kmers": 900}),
    "stream_explicit": lambda r, b, P: dict(
        batches=b, plan=P.from_stream(256, 60, (17, 21, 4), num_shards=4)),
}


@pytest.mark.parametrize("case", list(PRICE_CASES))
def test_price_workflow_and_cwl_equal_reference(genome_reads, case):
    jreads, reads = genome_reads
    plan = price(JobSpec(case, **PRICE_CASES[case](
        reads, batches_from_readset(reads, 64), AssemblyPlan)))
    jplan = jprice(JJobSpec(case, **PRICE_CASES[case](
        jreads, jbatches_from_readset(jreads, 64), JPlan)))
    assert plan.bytes() == jplan.bytes() > 0
    assert plan.stage_bytes() == jplan.stage_bytes()
    assert plan.dataset_shape == jplan.dataset_shape
    assert [dataclasses.astuple(s) for s in workflow(plan)] == \
        [dataclasses.astuple(s) for s in jworkflow(jplan)]
    assert to_cwl(plan, name=case) == jto_cwl(jplan, name=case)


def test_workflow_steps_cover_every_stage_byte():
    plan = AssemblyPlan.from_stream(256, 60, (17, 21, 4), num_shards=4)
    steps = workflow(plan)
    assert tuple(s.name for s in steps) == STAGES
    assert sum(s.bytes for s in steps) == plan.bytes()
    by_name = {s.name: s for s in steps}
    assert "bloom_filters" in by_name["analyze"].buffers  # stream plan
    assert "route_buffers" in by_name["align"].buffers    # sharded plan


def test_to_cwl_shape():
    plan = AssemblyPlan.from_stream(256, 60, (17, 21, 4))
    doc = to_cwl(plan, name="wetlands")
    assert doc["class"] == "Workflow"
    assert tuple(doc["steps"]) == STAGES
    # steps chain linearly: reads -> analyze -> ... -> scaffold
    assert doc["steps"]["analyze"]["in"]["data"] == "reads"
    assert doc["steps"]["scaffold"]["in"]["data"] == "align/out"
    assert doc["outputs"]["scaffolds"]["outputSource"] == "scaffold/out"
    for name, step in doc["steps"].items():
        (req,) = step["requirements"]
        assert req["class"] == "ResourceRequirement"
        assert req["ramMin"] >= 1


# ---------------------------------------------------------------------------
# state machine
# ---------------------------------------------------------------------------


def _job(name="j", cost=100, priority=0, seq=0):
    """A Job stand-in with just the fields the scheduler/state code uses."""
    return types.SimpleNamespace(name=name, cost=cost, priority=priority,
                                 seq=seq)


def test_state_machine_legal_path():
    plan = AssemblyPlan.from_stream(64, 50, (17, 17, 4))
    job = Job(JobSpec("j", batches=object(), plan=plan), plan, seq=1)
    assert job.state == JobState.QUEUED
    for st in (JobState.ADMITTED, JobState.RUNNING, JobState.PAUSED,
               JobState.QUEUED, JobState.ADMITTED, JobState.RUNNING,
               JobState.DONE):
        job.transition(st)
    assert job.finished_at is not None


def test_state_machine_rejects_illegal_transitions():
    plan = AssemblyPlan.from_stream(64, 50, (17, 17, 4))
    job = Job(JobSpec("j", batches=object(), plan=plan), plan, seq=1)
    with pytest.raises(JobError, match="QUEUED -> RUNNING"):
        job.transition(JobState.RUNNING)  # cannot skip admission
    job.transition(JobState.CANCELLED)
    with pytest.raises(JobError, match="CANCELLED"):
        job.transition(JobState.QUEUED)   # terminal states are final


# ---------------------------------------------------------------------------
# scheduler: budget, priority, backfill
# ---------------------------------------------------------------------------


def test_scheduler_priority_then_fifo():
    s = BudgetScheduler(1000)
    lo_old = _job("lo-old", cost=10, priority=0, seq=1)
    hi_new = _job("hi-new", cost=10, priority=5, seq=3)
    lo_new = _job("lo-new", cost=10, priority=0, seq=2)
    assert s.pick([lo_old, hi_new, lo_new]) is hi_new
    assert s.pick([lo_old, lo_new]) is lo_old


def test_scheduler_backfill_past_blocked_head():
    s = BudgetScheduler(1000)
    running = _job("running", cost=800)
    s.reserve(running)
    big = _job("big", cost=500, priority=9, seq=1)   # head of queue, blocked
    small = _job("small", cost=150, priority=0, seq=2)
    assert not s.fits(big)
    assert s.pick([big, small]) is small             # backfill
    s.reserve(small)
    assert s.pick([big]) is None                     # still blocked
    s.release(running)
    assert s.pick([big]) is big                      # head runs when space frees
    # release is idempotent and returns the budget
    s.release(small)
    s.release(small)
    assert s.free == 1000


def test_scheduler_refuses_unschedulable():
    s = BudgetScheduler(100)
    with pytest.raises(Unschedulable, match="needs 500"):
        s.check(_job("huge", cost=500))
    s.check(_job("ok", cost=100))  # exactly at budget is schedulable


def test_scheduler_double_reserve_rejected():
    s = BudgetScheduler(100)
    job = _job("j", cost=40)
    s.reserve(job)
    with pytest.raises(RuntimeError, match="already holds"):
        s.reserve(job)


# ---------------------------------------------------------------------------
# server admission + lifecycle (stub generators: no pipeline compute)
# ---------------------------------------------------------------------------


def _fake_start(server, events=2, state=JobState):
    """Patch JobServer._start to run a stub staged generator, so
    admission/lifecycle tests never touch the assembly pipeline."""

    def start(job):
        def gen():
            for i in range(events):
                yield STAGES[min(i, len(STAGES) - 1)], {"i": i}
            return {"job": job.name}

        job._gen = gen()
        job.transition(state.RUNNING)
        server._journal(job, "started", resumed=job.resumed)

    server._start = start


def _stream_plan(P=AssemblyPlan, **kw):
    return P.from_stream(64, 50, (17, 17, 4), **kw)


def test_server_refuses_over_budget_job():
    plan = _stream_plan()
    srv = JobServer(Local("cpu"), budget_bytes=plan.bytes() // 2)
    job = srv.submit(JobSpec("too-big", batches=object(), plan=plan))
    assert job.state == JobState.FAILED
    assert "budget" in job.error
    assert srv.scheduler.reserved == 0  # refused jobs hold nothing


def test_server_backfill_admits_smaller_later_job():
    plan = _stream_plan()
    one = plan.bytes()
    # budget fits one job; the high-priority head is twice that
    big = dataclasses.replace(plan, kmer_capacity=plan.kmer_capacity * 8)
    assert big.bytes() > one
    srv = JobServer(Local("cpu"), budget_bytes=big.bytes() + one)
    _fake_start(srv, events=3)
    a = srv.submit(JobSpec("big", batches=object(), plan=big, priority=9))
    b = srv.submit(JobSpec("small", batches=object(), plan=plan))
    srv.step()
    # big admitted first (priority), small backfilled into the residue
    assert a.state == JobState.RUNNING
    assert b.state == JobState.RUNNING
    c = srv.submit(JobSpec("waits", batches=object(), plan=big))
    srv.step()
    assert c.state == JobState.QUEUED  # no room until a job finishes
    srv.run()
    assert {j.state for j in (a, b, c)} == {JobState.DONE}
    assert srv.result("big") == {"job": "big"}
    assert srv.scheduler.reserved == 0


def test_server_cancel_queued_and_running():
    plan = _stream_plan()
    srv = JobServer(Local("cpu"), budget_bytes=plan.bytes() * 4)
    _fake_start(srv, events=50)
    a = srv.submit(JobSpec("a", batches=object(), plan=plan))
    b = srv.submit(JobSpec("b", batches=object(), plan=plan))
    srv.cancel("b")                       # still QUEUED: immediate
    assert b.state == JobState.CANCELLED
    srv.step()
    assert a.state == JobState.RUNNING
    srv.cancel("a")                       # RUNNING: at the next boundary
    assert a.state == JobState.RUNNING
    srv.step()
    assert a.state == JobState.CANCELLED
    assert a.events == 1                  # stopped mid-workflow
    assert srv.scheduler.reserved == 0
    with pytest.raises(JobError, match="not DONE|CANCELLED"):
        srv.result("a")


def test_server_duplicate_active_name_rejected():
    plan = _stream_plan()
    srv = JobServer(Local("cpu"), budget_bytes=plan.bytes() * 4)
    srv.submit(JobSpec("j", batches=object(), plan=plan))
    with pytest.raises(JobError, match="already active"):
        srv.submit(JobSpec("j", batches=object(), plan=plan))


def test_server_journal_records_lifecycle(tmp_path):
    plan = _stream_plan()
    srv = JobServer(Local("cpu"), budget_bytes=plan.bytes() * 2,
                    journal_dir=str(tmp_path))
    _fake_start(srv, events=2)
    srv.submit(JobSpec("j", batches=object(), plan=plan))
    srv.run()
    with open(tmp_path / "journal.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["event"] for r in recs] == [
        "submitted", "admitted", "started", "stage", "stage", "done"
    ]
    assert srv.journal_replay() == {"j": "DONE"}


def _journal(path):
    """The journal's records without their wall-clock field."""
    with open(os.path.join(path, "journal.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "wall"}
                for line in f]


def _lifecycle(JobServer, JobSpec, JobState, P, ctx, jdir):
    """One scenario on a stub generator: an over-budget refusal, a
    high-priority head, backfill past it, a cancel while queued and one
    while running, a pause and a resume.  Returns the admission order."""
    plan = _stream_plan(P)
    big = dataclasses.replace(plan, kmer_capacity=plan.kmer_capacity * 8)
    srv = JobServer(ctx, budget_bytes=big.bytes() + plan.bytes(),
                    journal_dir=jdir)
    _fake_start(srv, events=4, state=JobState)
    huge = dataclasses.replace(big, kmer_capacity=big.kmer_capacity * 4)
    srv.submit(JobSpec("huge", batches=object(), plan=huge))
    srv.submit(JobSpec("big", batches=object(), plan=big, priority=9))
    srv.submit(JobSpec("small", batches=object(), plan=plan))
    srv.submit(JobSpec("gone", batches=object(), plan=plan))
    srv.submit(JobSpec("late", batches=object(), plan=big, priority=1))
    srv.cancel("gone")
    srv.step()
    srv.pause("big")
    srv.step()
    srv.resume("big")
    srv.step()
    srv.cancel("small")
    srv.run()
    with open(os.path.join(jdir, "journal.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["name"] for r in recs if r["event"] == "admitted"]


def test_server_admission_order_and_journal_equal_reference(tmp_path):
    order = _lifecycle(JobServer, JobSpec, JobState, AssemblyPlan,
                       Local("cpu"), str(tmp_path / "port"))
    jorder = _lifecycle(JJobServer, JJobSpec, JJobState, JPlan, JLocal(),
                        str(tmp_path / "ref"))
    assert order == jorder == ["big", "small", "big", "late"]
    got, want = _journal(tmp_path / "port"), _journal(tmp_path / "ref")
    assert got == want
    events = [r["event"] for r in got]
    for e in ("refused", "cancelled", "paused", "resumed", "done"):
        assert e in events


def test_job_checkpoint_dir_is_safe_and_distinct():
    a = job_checkpoint_dir("/r", "job A/1")
    b = job_checkpoint_dir("/r", "job A 1")
    assert a != b                          # slug collision disambiguated
    assert a == job_checkpoint_dir("/r", "job A/1")  # deterministic
    assert "/" not in os.path.basename(a)
    assert os.path.dirname(a) == "/r"
    for name in ("job A/1", "job A 1", "wetlands", "x" * 100):
        assert job_checkpoint_dir("/r", name) == \
            jjob_checkpoint_dir("/r", name)


# ---------------------------------------------------------------------------
# the real thing: streaming jobs on one shared context
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_world():
    """tests/test_serving.py's stream_world in both packages: the JAX solo
    `assemble_stream` of two sources, each with its stage events."""
    comm = jmgsim.sample_community(seed=1, num_genomes=2, genome_len=300,
                                   abundance_sigma=0.5)
    world = {}
    for name, seed in (("a", 2), ("b", 9)):
        jreads, _ = jmgsim.generate_reads(seed=seed, community=comm,
                                          num_pairs=96, read_len=50,
                                          err_rate=0.004)
        jsrc = jbatches_from_readset(jreads, 64)
        jplan = JPlan.from_stream(64, int(jreads.max_len), (17, 21, 4))
        events = []
        solo = JAssembler(jplan, JLocal()).assemble_stream(
            jsrc, hook=lambda s, i: events.append((s, dict(i))))
        world[name] = dict(src=batches_from_readset(_port_reads(jreads), 64),
                           solo=solo, events=events, jplan=jplan)
    plan = AssemblyPlan.from_stream(64, 50, (17, 21, 4))
    assert plan.bytes() == world["a"]["jplan"].bytes()
    world["plan"] = plan
    return world


def assert_same_as_reference(got, want):
    """Bit-identical to the JAX result up to StreamStats.resumed
    (checkpoint bookkeeping)."""
    for key in RESULT_KEYS:
        g, w = bridge.to_numpy(got[key], key), want[key]
        if isinstance(g, dict):
            for f, a in g.items():
                np.testing.assert_array_equal(a, np.asarray(getattr(w, f)),
                                              err_msg=f"{key}.{f}")
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)
    assert [dataclasses.asdict(s) for s in got["stats"]] == \
        [dataclasses.asdict(s) for s in want["stats"]]
    norm = lambda ss: {k: {**dataclasses.asdict(v), "resumed": False}
                       for k, v in ss.items()}
    assert norm(got["stream_stats"]) == norm(want["stream_stats"])
    assert got["overflow"] == want["overflow"]


def _replay_start(server, world):
    """The reference's server driving the reference's own recorded events
    (each job's solo run), so it writes the journal it would for them."""

    def start(job):
        def gen():
            for stage, info in world[job.name]["events"]:
                yield stage, info
            return world[job.name]["solo"]

        job._gen = gen()
        job.transition(JJobState.RUNNING)
        server._journal(job, "started", resumed=job.resumed)

    server._start = start


def test_concurrent_stream_jobs_bit_identical_to_solo(stream_world,
                                                      tmp_path):
    w = stream_world
    plan = w["plan"]
    # checkpoint_root on: each job binds its OWN checkpoint dir, so this
    # also pins ctx.spawn(): on a shared context instance, job b's
    # prepare_stream would clobber job a's binding and fingerprint-fail
    srv = JobServer(Local("cpu"), budget_bytes=4 * plan.bytes(),
                    journal_dir=str(tmp_path / "journal"),
                    checkpoint_root=str(tmp_path / "ckpt"))
    a = srv.submit(JobSpec("a", batches=w["a"]["src"], plan=plan))
    b = srv.submit(JobSpec("b", batches=w["b"]["src"], plan=plan))
    srv.run()
    # both ran interleaved on ONE shared context...
    assert a.state == b.state == JobState.DONE, (a.error, b.error)
    assert a.events == len(w["a"]["events"]) > 0
    # ...and neither perturbed the other
    assert_same_as_reference(srv.result("a"), w["a"]["solo"])
    assert_same_as_reference(srv.result("b"), w["b"]["solo"])
    # the journal, record by record, is the reference server's for the
    # reference's events: every stage event's info survives its
    # int/float/str filter in both
    jplan = w["a"]["jplan"]
    ref = JJobServer(JLocal(), budget_bytes=4 * jplan.bytes(),
                     journal_dir=str(tmp_path / "ref"))
    _replay_start(ref, w)
    ref.submit(JJobSpec("a", batches=object(), plan=jplan))
    ref.submit(JJobSpec("b", batches=object(), plan=jplan))
    ref.run()
    got = _journal(tmp_path / "journal")
    assert got == _journal(tmp_path / "ref")
    infos = [r["info"] for r in got if r["event"] == "stage"]
    assert len(infos) == a.events + b.events
    assert all(infos)  # no info emptied by the filter


def test_pause_resume_bit_identical(stream_world, tmp_path):
    w = stream_world
    plan = w["plan"]
    srv = JobServer(Local("cpu"), budget_bytes=4 * plan.bytes(),
                    checkpoint_root=str(tmp_path))
    job = srv.submit(JobSpec("j", batches=w["a"]["src"], plan=plan))
    ticks = 0
    while srv.step():
        ticks += 1
        if ticks == 2:
            srv.pause("j")
        if job.state == JobState.PAUSED:
            assert srv.scheduler.reserved == 0  # pause releases the budget
            srv.resume("j")
    assert job.state == JobState.DONE, job.error
    assert job.resumed
    assert_same_as_reference(srv.result("j"), w["a"]["solo"])


def test_kill_and_restart_resumes_bit_identical(stream_world, tmp_path):
    w = stream_world
    plan = w["plan"]
    jdir, cdir = str(tmp_path / "journal"), str(tmp_path / "ckpt")
    spec = lambda: JobSpec("crashy", batches=w["a"]["src"], plan=plan)

    srv = JobServer(Local("cpu"), budget_bytes=4 * plan.bytes(),
                    journal_dir=jdir, checkpoint_root=cdir)
    job = srv.submit(spec())
    for _ in range(4):  # die mid-stream
        srv.step()
    assert job.state == JobState.RUNNING
    del srv

    srv2 = JobServer(Local("cpu"), budget_bytes=4 * plan.bytes(),
                     journal_dir=jdir, checkpoint_root=cdir)
    srv2.recover([spec()])
    job2 = srv2.jobs["crashy"]
    assert job2.state == JobState.QUEUED and job2.resumed
    srv2.run()
    assert job2.state == JobState.DONE, job2.error
    out = srv2.result("crashy")
    # the k-mer analysis fast-forwarded from the per-job checkpoint, onto
    # the job context's device
    assert any(s.resumed for s in out["stream_stats"].values())
    assert out["contigs"].bases.device.type == "cpu"
    assert_same_as_reference(out, w["a"]["solo"])

    # a third recover sees DONE in the journal and does not re-run
    srv3 = JobServer(Local("cpu"), budget_bytes=4 * plan.bytes(),
                     journal_dir=jdir, checkpoint_root=cdir)
    srv3.recover([spec()])
    assert srv3.jobs["crashy"].state == JobState.DONE
    assert not srv3.step()  # nothing left to do


def test_a_failing_job_fails_alone(stream_world):
    """A job whose run raises ends FAILED with the error, its budget
    released, and the server finishes the others (the reference's
    semantics; a caller that needs every job done checks each state)."""
    w = stream_world
    plan = w["plan"]
    bad = dataclasses.replace(plan, min_count=1)  # refused by the stream
    srv = JobServer(Local("cpu"), budget_bytes=4 * plan.bytes())
    x = srv.submit(JobSpec("bad", batches=w["a"]["src"], plan=bad))
    srv.run()
    assert x.state == JobState.FAILED and "min_count" in x.error
    assert srv.scheduler.reserved == 0


def test_hook_abort_stops_assemble(stream_world):
    """drive()'s hook is the cancellation seam: raising aborts cleanly."""
    w = stream_world

    class Stop(Exception):
        pass

    seen = []

    def hook(stage, info):
        seen.append(stage)
        raise Stop()

    with pytest.raises(Stop):
        Assembler(w["plan"], Local("cpu")).assemble_stream(w["a"]["src"],
                                                          hook=hook)
    assert seen == ["analyze"]


def test_drive_returns_generator_value():
    def gen():
        yield "analyze", {}
        return {"x": 1}

    assert drive(gen()) == {"x": 1}
    events = []
    assert drive(gen(), lambda s, i: events.append(s)) == {"x": 1}
    assert events == ["analyze"]


def test_server_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """`JobServer(Local())` is on the card: without one, `Local()` raises
    before a server exists; `Local("cpu")` is the CPU's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JobServer(Local(), budget_bytes=1)
    srv = JobServer(Local("cpu"), budget_bytes=1)
    assert srv.ctx.device.type == "cpu"
