"""Plan-priced admission control + scheduling (DESIGN.md §9; mirrors
`repro.serving.scheduler`).

The scheduler owns one number: the server's declared device-memory
budget in bytes.  Each job's bill is its plan's `bytes()` — the same
upfront capacity provisioning that sizes every buffer in the pipeline
(paper §II-B), so admission is a comparison of two statically known
integers, not a guess about runtime behaviour:

    admit(job)  iff  job.plan.bytes() <= budget - sum(running bills)

Policy is FIFO-within-priority **with backfill**: the queue is scanned
in (priority desc, submission seq asc) order, and a job that does not
fit is skipped rather than blocking the scan — a smaller, later job may
be admitted into the residual budget (classic HPC backfill; the paper's
runs share Cori/Summit via the same discipline).  A job whose bill
exceeds the *total* budget can never run and is refused outright
(`Unschedulable`) instead of waiting forever.
"""
from __future__ import annotations

from typing import List, Optional

from .jobs import Job


class Unschedulable(RuntimeError):
    """Job's plan can never fit the server's total budget."""


class BudgetScheduler:
    """Admission control against a fixed byte budget, priority + backfill."""

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive, got {budget_bytes}")
        self.budget = int(budget_bytes)
        self.reserved = 0
        self._holders: dict = {}   # job name -> reserved bytes

    # -- reservations -------------------------------------------------------

    @property
    def free(self) -> int:
        return self.budget - self.reserved

    def fits(self, job: Job) -> bool:
        return job.cost <= self.free

    def check(self, job: Job) -> None:
        """Refuse a job that can never run at this budget."""
        if job.cost > self.budget:
            raise Unschedulable(
                f"job {job.name!r} needs {job.cost} B but the server budget "
                f"is {self.budget} B — shrink the plan (smaller batch_reads/"
                f"kmer_capacity) or raise the budget"
            )

    def reserve(self, job: Job) -> None:
        if job.name in self._holders:
            raise RuntimeError(f"job {job.name!r} already holds a reservation")
        if not self.fits(job):
            raise RuntimeError(
                f"job {job.name!r} ({job.cost} B) does not fit the free "
                f"budget ({self.free} B); call fits() first"
            )
        self._holders[job.name] = job.cost
        self.reserved += job.cost

    def release(self, job: Job) -> None:
        held = self._holders.pop(job.name, None)
        if held is not None:
            self.reserved -= held

    # -- admission scan -----------------------------------------------------

    def pick(self, queued: List[Job]) -> Optional[Job]:
        """Next job to admit: highest priority first, FIFO within a
        priority, and backfill past any job that doesn't fit the current
        residual budget."""
        for job in sorted(queued, key=lambda j: (-j.priority, j.seq)):
            if self.fits(job):
                return job
        return None

    def snapshot(self) -> dict:
        return {
            "budget": self.budget,
            "reserved": self.reserved,
            "free": self.free,
            "holders": dict(self._holders),
        }
