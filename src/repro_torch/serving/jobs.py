"""Job model for assembly-as-a-service (DESIGN.md §9; mirrors
`repro.serving.jobs`).

A *job* is one assembly run: a `JobSpec` names the dataset source (an
in-memory `ReadSet` or a re-iterable streaming batch source), the plan
derivation knobs, and a priority.  `price()` turns a spec into an
`AssemblyPlan` the §II-B way (`from_dataset` / `from_stream` derive
every capacity upfront), so `plan.bytes()` states the job's
device-memory bill *before admission*, and `plan.stage_bytes()` breaks
it down per stage.

Each job runs as a **staged workflow** in the shape of the CWL
`targeted_assembly.cwl` exemplar (SNIPPETS.md): named steps with
per-step capacity declarations, executed through the staged-assembly
event protocol (`repro_torch.api.assembler.STAGES`), so status reporting
and resume are per stage, not per job.  `workflow()` declares the steps
for a plan; `to_cwl()` renders the declaration as a CWL-Workflow-shaped
dict (steps with ResourceRequirement ramMin) for status endpoints and
debug dumps.

The job **state machine**:

    QUEUED -> ADMITTED -> RUNNING -> {DONE, FAILED, CANCELLED}
    RUNNING -> PAUSED -> QUEUED (resume; re-admission re-prices the
                                 residual budget)
    QUEUED/ADMITTED -> CANCELLED, QUEUED -> FAILED (unschedulable)

Transitions outside `_TRANSITIONS` raise: a job cannot silently skip
admission or resurrect from a terminal state.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Optional

from repro_torch.api.assembler import STAGES
from repro_torch.api.plan import AssemblyPlan, PlanError


class JobState(str, enum.Enum):
    QUEUED = "QUEUED"
    ADMITTED = "ADMITTED"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


TERMINAL = (JobState.DONE, JobState.FAILED, JobState.CANCELLED)

_TRANSITIONS = {
    JobState.QUEUED: {JobState.ADMITTED, JobState.CANCELLED,
                      JobState.FAILED},
    JobState.ADMITTED: {JobState.RUNNING, JobState.CANCELLED,
                        JobState.FAILED},
    JobState.RUNNING: {JobState.DONE, JobState.FAILED, JobState.CANCELLED,
                       JobState.PAUSED},
    JobState.PAUSED: {JobState.QUEUED, JobState.CANCELLED},
    JobState.DONE: set(),
    JobState.FAILED: set(),
    JobState.CANCELLED: set(),
}


class JobError(RuntimeError):
    """Invalid job operation (bad spec, illegal state transition)."""


@dataclasses.dataclass
class JobSpec:
    """One assembly request: dataset source + plan overrides + priority.

    Exactly one of `reads` (in-memory ReadSet) and `batches` (re-iterable
    fixed-shape batch source, `repro_torch.stream.batches` contract) must
    be set.  `plan` pins an explicit pre-priced plan; otherwise the server
    derives one via `AssemblyPlan.from_dataset` / `from_stream` with
    `k_range` and `plan_overrides`.  Higher `priority` schedules first;
    ties break FIFO by submission order.
    """

    name: str
    reads: Optional[Any] = None
    batches: Optional[Any] = None
    k_range: tuple = (17, 21, 4)
    priority: int = 0
    plan: Optional[AssemblyPlan] = None
    plan_overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def streaming(self) -> bool:
        return self.batches is not None

    def validate(self) -> None:
        if not self.name:
            raise JobError("JobSpec needs a non-empty name")
        if (self.reads is None) == (self.batches is None):
            raise JobError(
                f"JobSpec {self.name!r}: exactly one of reads (in-memory) "
                f"and batches (streaming) must be set"
            )


def price(spec: JobSpec) -> AssemblyPlan:
    """Derive + bind the job's capacity plan; `plan.bytes()` is the
    admission-control memory bill (upfront provisioning, paper §II-B)."""
    spec.validate()
    if spec.plan is not None:
        plan = spec.plan
        if spec.reads is not None and plan.dataset_shape is None:
            plan = plan.bind(spec.reads)
        return plan
    if spec.streaming:
        from repro_torch.stream.batches import check_batch_shapes

        batch_reads, max_len = check_batch_shapes(spec.batches)
        return AssemblyPlan.from_stream(
            batch_reads, max_len, spec.k_range, **spec.plan_overrides
        )
    return AssemblyPlan.from_dataset(
        spec.reads, spec.k_range, **spec.plan_overrides
    )


# ---------------------------------------------------------------------------
# staged workflow declaration (the CWL targeted_assembly.cwl shape)
# ---------------------------------------------------------------------------

# which plan.stage_bytes() buffers each workflow step declares.  Keys
# absent from a given plan's stage_bytes (e.g. bloom_filters on an
# in-memory plan) contribute 0.
STEP_BUFFERS = {
    "analyze": ("kmer_occurrences", "kmer_tables", "bloom_filters"),
    "contig_rounds": ("contigs", "walk_tables"),
    "align": ("seed_index", "alignments", "route_buffers"),
    "scaffold": ("links", "scaffolds"),
}
assert tuple(STEP_BUFFERS) == STAGES


@dataclasses.dataclass(frozen=True)
class Step:
    """One declared workflow step: name + its capacity declaration."""

    name: str
    bytes: int
    buffers: tuple


def workflow(plan: AssemblyPlan) -> list:
    """Per-stage capacity declarations for one job's staged workflow."""
    sb = plan.stage_bytes()
    steps = []
    for name in STAGES:
        keys = tuple(k for k in STEP_BUFFERS[name] if k in sb)
        steps.append(Step(name=name, bytes=int(sum(sb[k] for k in keys)),
                          buffers=keys))
    unclaimed = set(sb) - {k for keys in STEP_BUFFERS.values() for k in keys}
    if unclaimed:
        raise PlanError(
            f"stage_bytes keys {sorted(unclaimed)} are not declared by any "
            f"workflow step — admission would under-price the job"
        )
    return steps


def to_cwl(plan: AssemblyPlan, *, name: str = "assembly") -> dict:
    """Render the staged workflow as a CWL-Workflow-shaped declaration.

    The shape follows SNIPPETS.md's `targeted_assembly.cwl`: a
    `class: Workflow` document whose steps chain analyze ->
    contig_rounds -> align -> scaffold, each declaring its capacity as a
    ResourceRequirement (ramMin, MiB).  Purely declarative: status
    endpoints and debug dumps emit it; nothing executes CWL.
    """
    steps = workflow(plan)
    doc = {
        "cwlVersion": "v1.0",
        "class": "Workflow",
        "label": f"{name}: staged metagenome assembly "
                 f"(k={plan.k_min}..{plan.k_max})",
        "inputs": {"reads": "File"},
        "outputs": {"scaffolds": {"type": "File",
                                  "outputSource": "scaffold/out"}},
        "steps": {},
    }
    prev = "reads"
    for step in steps:
        doc["steps"][step.name] = {
            "in": {"data": prev},
            "out": ["out"],
            "requirements": [{
                "class": "ResourceRequirement",
                "ramMin": max(1, -(-step.bytes // (1 << 20))),
            }],
            "doc": f"buffers: {', '.join(step.buffers) or 'none'}",
        }
        prev = f"{step.name}/out"
    return doc


# ---------------------------------------------------------------------------
# the Job record
# ---------------------------------------------------------------------------


class Job:
    """One submitted job: spec + priced plan + state machine + progress.

    The server owns the lifecycle; this object owns the bookkeeping:
    state transitions (validated against `_TRANSITIONS`), per-stage
    progress from the staged-assembly events, and submit/finish
    timestamps.
    """

    def __init__(self, spec: JobSpec, plan: AssemblyPlan, seq: int):
        self.spec = spec
        self.plan = plan
        self.seq = seq              # FIFO tiebreak within a priority
        self.cost = plan.bytes()
        self.steps = workflow(plan)
        self.state = JobState.QUEUED
        self.stage: Optional[str] = None   # last event's stage
        self.events = 0
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.resumed = False
        self.cancel_requested = False
        self.pause_requested = False
        self.submitted_at = time.monotonic()
        self.finished_at: Optional[float] = None
        self._gen = None            # live staged-assembly generator

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def priority(self) -> int:
        return self.spec.priority

    def transition(self, new: JobState) -> None:
        if new not in _TRANSITIONS[self.state]:
            raise JobError(
                f"job {self.name!r}: illegal transition "
                f"{self.state.value} -> {new.value}"
            )
        self.state = new
        if new in TERMINAL:
            self.finished_at = time.monotonic()
            self._gen = None

    def note_event(self, stage: str, info: dict) -> None:
        self.stage = stage
        self.events += 1

    def stage_status(self) -> dict:
        """Per-stage view (the CWL workflow steps): pending | active |
        done.  A stage is done once a later stage has emitted an event;
        on DONE every stage is done."""
        if self.state == JobState.DONE:
            return {s.name: "done" for s in self.steps}
        cur = STAGES.index(self.stage) if self.stage in STAGES else -1
        out = {}
        for i, s in enumerate(self.steps):
            out[s.name] = ("done" if i < cur else
                           "active" if i == cur else "pending")
        return out

    def status(self) -> dict:
        """Machine-readable status row (journal/HTTP shape)."""
        return {
            "name": self.name,
            "state": self.state.value,
            "priority": self.priority,
            "bytes": int(self.cost),
            "stage_bytes": {s.name: s.bytes for s in self.steps},
            "stages": self.stage_status(),
            "streaming": self.spec.streaming,
            "events": self.events,
            "resumed": self.resumed,
            "error": self.error,
        }
