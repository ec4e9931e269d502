"""Assembly-as-a-service: a multi-tenant job server with plan-priced
admission control (DESIGN.md §9; mirrors `repro.serving`).

    from repro_torch.api import AssemblyPlan, Local
    from repro_torch.serving import JobServer, JobSpec

    srv = JobServer(Local(), budget_bytes=1 << 30,
                    journal_dir="runs/journal", checkpoint_root="runs/ckpt")
    srv.submit(JobSpec("wetlands", batches=src, priority=1))
    srv.submit(JobSpec("mock-community", reads=reads))
    jobs = srv.run()
    scaffolds = srv.result("wetlands")["scaffolds"]

Every job is priced upfront by its `AssemblyPlan` (`plan.bytes()`),
admitted only when it fits the server's residual device-memory budget
(FIFO within priority, with backfill), and driven as a staged workflow
(analyze -> contig_rounds -> align -> scaffold) whose boundaries are the
cancel/pause/resume and crash-recovery points.  The jobs of one server
share its context's device (`Local()`: the CUDA card; `Mesh(S)`: S
shards on it), each on its own `spawn()`.

A job whose run raises ends FAILED with the exception in `job.error`,
and the server goes on with the others; a caller that needs every job
done checks each job's state.  The token-decode `Engine` lives in
`repro_torch.models.decode_engine`.
"""
from .jobs import (
    STEP_BUFFERS,
    Job,
    JobError,
    JobSpec,
    JobState,
    Step,
    price,
    to_cwl,
    workflow,
)
from .scheduler import BudgetScheduler, Unschedulable
from .server import JobServer

__all__ = [
    "BudgetScheduler",
    "Job",
    "JobError",
    "JobServer",
    "JobSpec",
    "JobState",
    "STEP_BUFFERS",
    "Step",
    "Unschedulable",
    "price",
    "to_cwl",
    "workflow",
]
