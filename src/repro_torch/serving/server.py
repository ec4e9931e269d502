"""The assembly job server (DESIGN.md §9; mirrors `repro.serving.server`).

`JobServer` multiplexes many assembly jobs onto ONE shared
`ExecutionContext` under a declared device-memory budget:

- **submit** prices the spec (`jobs.price` -> `AssemblyPlan`), refuses
  jobs that can never fit the total budget (FAILED immediately), and
  queues the rest.
- **step** is the scheduler tick: admit whatever fits the residual
  budget (priority + backfill, `BudgetScheduler.pick`), then advance
  every RUNNING job by one staged-assembly event.  Jobs are plain
  Python generators (`assemble_iter` / `assemble_stream_iter`), so
  "concurrency" is cooperative and deterministic: one job computes at a
  time, interleaved at stage/batch boundaries — exactly the granularity
  at which the shared context's buffers are quiescent, which is why a
  multiplexed run is bit-identical to solo runs.
- **cancel / pause / resume** act at those same boundaries.  Pause
  drops the live generator and releases the job's budget; resume
  re-queues it, and a streaming job's re-run fast-forwards its k-mer
  analysis from the per-batch `StreamCheckpoint` instead of recounting.
- **journal + recover**: every state transition appends a JSONL record.
  After a crash, a new server with the same journal/checkpoint roots
  `recover(specs)`-s: terminal jobs stay terminal, interrupted jobs
  re-queue with `resumed=True` and pick up their checkpoints.

Dataset sources (arrays, generators) are deliberately NOT journaled —
the journal records decisions, the checkpoints record expensive partial
state, and the caller re-supplies specs on restart (the same contract as
re-running a CWL workflow with cached steps).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

from repro_torch.api.assembler import Assembler
from repro_torch.stream.analysis import job_checkpoint_dir

from .jobs import TERMINAL, Job, JobError, JobSpec, JobState, price, to_cwl
from .scheduler import BudgetScheduler, Unschedulable


class JobServer:
    """Multi-tenant assembly server over one shared ExecutionContext."""

    def __init__(self, ctx, budget_bytes: int, *,
                 journal_dir: Optional[str] = None,
                 checkpoint_root: Optional[str] = None):
        self.ctx = ctx
        self.scheduler = BudgetScheduler(budget_bytes)
        self.jobs: Dict[str, Job] = {}
        self._seq = 0
        self.journal_dir = journal_dir
        self.checkpoint_root = checkpoint_root
        self._journal_path = None
        if journal_dir is not None:
            os.makedirs(journal_dir, exist_ok=True)
            self._journal_path = os.path.join(journal_dir, "journal.jsonl")

    # -- journal ------------------------------------------------------------

    def _journal(self, job: Job, event: str, **extra) -> None:
        if self._journal_path is None:
            return
        rec = {"name": job.name, "event": event,
               "state": job.state.value, "priority": job.priority,
               "bytes": int(job.cost), "wall": time.time(), **extra}
        with open(self._journal_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def journal_replay(self) -> Dict[str, str]:
        """Last journaled state per job name (tolerates a torn final
        line from a crash mid-append)."""
        last: Dict[str, str] = {}
        if self._journal_path is None or not os.path.exists(self._journal_path):
            return last
        with open(self._journal_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                last[rec["name"]] = rec["state"]
        return last

    # -- submission / lifecycle --------------------------------------------

    def _shards(self) -> int:
        return int(getattr(self.ctx, "num_shards", 1))

    def submit(self, spec: JobSpec) -> Job:
        """Price, validate, and queue a job; unschedulable specs FAIL
        immediately (never sit in the queue forever)."""
        if spec.name in self.jobs and self.jobs[spec.name].state not in TERMINAL:
            raise JobError(f"job {spec.name!r} already active")
        if spec.plan is None and "num_shards" not in spec.plan_overrides:
            # price for the context the job will actually run on
            spec.plan_overrides = {**spec.plan_overrides,
                                   "num_shards": self._shards()}
        plan = price(spec)
        self._seq += 1
        job = Job(spec, plan, self._seq)
        self.jobs[spec.name] = job
        try:
            self.scheduler.check(job)
        except Unschedulable as e:
            job.error = str(e)
            job.transition(JobState.FAILED)
            self._journal(job, "refused", error=job.error)
            return job
        self._journal(job, "submitted")
        return job

    def cancel(self, name: str) -> Job:
        """Cancel a job.  Idle states flip immediately; a RUNNING job is
        stopped at its next stage/batch boundary (the request is checked
        before each event)."""
        job = self._get(name)
        if job.state in TERMINAL:
            return job
        if job.state == JobState.RUNNING:
            job.cancel_requested = True
        else:
            self.scheduler.release(job)
            job.transition(JobState.CANCELLED)
            self._journal(job, "cancelled")
        return job

    def pause(self, name: str) -> Job:
        """Pause a RUNNING job at its next boundary: the generator is
        dropped and the budget released; progress persists only through
        checkpoints (streaming analysis), so resume recomputes the rest."""
        job = self._get(name)
        if job.state != JobState.RUNNING:
            raise JobError(f"job {name!r} is {job.state.value}, not RUNNING")
        job.pause_requested = True
        return job

    def resume(self, name: str) -> Job:
        job = self._get(name)
        if job.state != JobState.PAUSED:
            raise JobError(f"job {name!r} is {job.state.value}, not PAUSED")
        job.resumed = True
        job.transition(JobState.QUEUED)
        self._journal(job, "resumed")
        return job

    def recover(self, specs: List[JobSpec]) -> None:
        """Restart recovery: re-submit `specs`; the journal decides each
        job's fate.  Terminal jobs are recreated terminal (results are
        not persisted — only decisions and checkpoints are); interrupted
        jobs re-queue with `resumed=True` and their streaming analysis
        fast-forwards from the per-job checkpoint dir."""
        last = self.journal_replay()
        for spec in specs:
            prev = last.get(spec.name)
            job = self.submit(spec)
            if job.state in TERMINAL:
                continue  # refused on re-price; journaled already
            if prev in ("DONE", "FAILED", "CANCELLED"):
                # recreate the terminal record without re-running
                job.state = JobState(prev)
                job.finished_at = time.monotonic()
                self._journal(job, "recovered-terminal")
            elif prev in ("RUNNING", "PAUSED", "ADMITTED"):
                job.resumed = True
                self._journal(job, "recovered-requeued")

    # -- the scheduler tick -------------------------------------------------

    def _start(self, job: Job) -> None:
        # each job runs on its own spawn of the shared context: same
        # device (and shard count), fresh per-run bindings — interleaved
        # jobs must not clobber each other's plan/checkpoint/overflow state
        try:
            ctx = self.ctx.spawn()
        except NotImplementedError:
            ctx = self.ctx
        asm = Assembler(job.plan, ctx)
        if job.spec.streaming:
            ckpt = None
            if self.checkpoint_root is not None:
                ckpt = job_checkpoint_dir(self.checkpoint_root, job.name)
            job._gen = asm.assemble_stream_iter(
                job.spec.batches, checkpoint_dir=ckpt)
        else:
            job._gen = asm.assemble_iter(job.spec.reads)
        job.transition(JobState.RUNNING)
        self._journal(job, "started", resumed=job.resumed)

    def _advance(self, job: Job) -> None:
        """One staged-assembly event for one RUNNING job; cancel/pause
        requests take effect here, at the boundary."""
        if job.cancel_requested:
            job._gen.close()
            self.scheduler.release(job)
            job.transition(JobState.CANCELLED)
            self._journal(job, "cancelled")
            return
        if job.pause_requested:
            job.pause_requested = False
            job._gen.close()
            self.scheduler.release(job)
            job.transition(JobState.PAUSED)
            self._journal(job, "paused", stage=job.stage)
            return
        try:
            stage, info = next(job._gen)
        except StopIteration as stop:
            job.result = stop.value
            self.scheduler.release(job)
            job.transition(JobState.DONE)
            self._journal(job, "done", events=job.events)
            return
        except Exception as e:  # noqa: BLE001 — job failure must not kill the server
            job.error = f"{type(e).__name__}: {e}"
            self.scheduler.release(job)
            job.transition(JobState.FAILED)
            self._journal(job, "failed", error=job.error)
            return
        job.note_event(stage, info)
        self._journal(job, "stage", stage=stage,
                      info={k: v for k, v in info.items()
                            if isinstance(v, (int, float, str))})

    def step(self) -> bool:
        """One scheduler tick: admit everything that fits, then advance
        each RUNNING job by one event (round-robin in admission order).
        Returns True while any job is non-terminal."""
        # admission: keep picking until nothing fits
        queued = [j for j in self.jobs.values() if j.state == JobState.QUEUED]
        while queued:
            job = self.scheduler.pick(queued)
            if job is None:
                break
            self.scheduler.reserve(job)
            job.transition(JobState.ADMITTED)
            self._journal(job, "admitted", free=self.scheduler.free)
            queued.remove(job)
        # start + advance
        for job in list(self.jobs.values()):
            if job.state == JobState.ADMITTED:
                self._start(job)
        for job in list(self.jobs.values()):
            if job.state == JobState.RUNNING:
                self._advance(job)
        return any(j.state not in TERMINAL for j in self.jobs.values())

    def run(self, max_ticks: int = 1_000_000) -> Dict[str, Job]:
        """Drive until every job is terminal (or the tick bound trips —
        a backstop against a stuck generator, not a tuning knob)."""
        for _ in range(max_ticks):
            if not self.step():
                return dict(self.jobs)
        states = {j.name: j.state.value for j in self.jobs.values()}
        raise RuntimeError(
            f"server did not quiesce in {max_ticks} ticks; states: {states}"
        )

    # -- introspection ------------------------------------------------------

    def _get(self, name: str) -> Job:
        if name not in self.jobs:
            raise JobError(f"unknown job {name!r}")
        return self.jobs[name]

    def status(self, name: Optional[str] = None):
        if name is not None:
            return self._get(name).status()
        return {"budget": self.scheduler.snapshot(),
                "jobs": [j.status() for j in
                         sorted(self.jobs.values(), key=lambda j: j.seq)]}

    def describe(self, name: str) -> dict:
        """CWL-shaped workflow declaration for one job (jobs.to_cwl)."""
        job = self._get(name)
        return to_cwl(job.plan, name=job.name)

    def result(self, name: str) -> dict:
        job = self._get(name)
        if job.state != JobState.DONE:
            raise JobError(
                f"job {name!r} is {job.state.value}, not DONE"
                + (f" ({job.error})" if job.error else "")
            )
        return job.result
