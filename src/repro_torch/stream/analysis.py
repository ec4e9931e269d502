"""Two-pass streaming k-mer analysis over batch sources (paper §II-A/B;
mirrors `repro.stream.analysis`).

  pass 1  every batch's canonical occurrences enter Bloom filter f1; a key
          already in f1 (sighted in an earlier batch) or duplicated within
          its own batch marks f2, "seen at least twice";
  pass 2  the batches re-stream; only occurrences whose key is in f2 are
          counted, and each batch's partial table folds into a persistent
          running table with `merge_counts`.

The device holds one batch plus fixed-capacity filters and tables,
whatever the read count.  Over S shards
(`sharded_streaming_kmer_analysis`), both filters and the running table
are owner-partitioned: occurrences route to their hash owner
(`dist.kmer_owner`) before they touch filter or table state, so each
key's admission and count are globally exact (`dist.stages`).  Over the
W ranks of a mesh, each rank holds its S/W shards' filters and table
slices, reads the whole batch stream and keeps its blocks of each batch.

Batch boundaries are checkpoint boundaries: `StreamCheckpoint` saves
(filters, running table, counters, a fingerprint of the data and
parameters) after every batch through `train.checkpoint.Checkpointer`,
so an interrupted analysis resumes at the last completed batch.  Over
W > 1 ranks each rank keeps its own shards' state in a subdirectory
`rank{r}-of-{W}`, and a resume under another W is refused.
"""
from __future__ import annotations

import dataclasses
import os
import re
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bloom, kmer_analysis
from repro_torch.train.checkpoint import Checkpointer

from .batches import require_reiterable


@dataclasses.dataclass
class StreamStats:
    """Accounting for one streamed analysis (reported, like overflow)."""

    batches_pass1: int = 0
    batches_pass2: int = 0
    occurrences_total: int = 0
    occurrences_admitted: int = 0
    table_overflow: int = 0
    route_overflow: int = 0
    resumed: bool = False

    @property
    def admitted_frac(self) -> float:
        return self.occurrences_admitted / max(self.occurrences_total, 1)


class StreamCheckpoint:
    """Batch-boundary checkpoint/resume of streaming state.

    The checkpoint step encodes (pass, next_batch) as
    `pass * PHASE + next_batch`; the state is a flat dict of tensors
    holding a fingerprint, and restoring against another fingerprint
    raises instead of serving a previous run's table.
    """

    PHASE = 1 << 20  # batches per pass bound for step encoding

    def __init__(self, directory: str):
        self.ck = Checkpointer(directory, keep=2)

    def save(self, phase: int, next_batch: int, state: dict) -> None:
        self.ck.save(phase * self.PHASE + next_batch, state)

    def latest(self) -> int:
        """The newest saved step, 0 if none."""
        return self.ck.latest_step() or 0

    def restore(self, template: dict, step: Optional[int] = None):
        """-> (state, phase, next_batch) of step `step` (default the
        newest), or (template, 0, 0) at step 0 or with none saved."""
        step = self.latest() if step is None else step
        if step == 0:
            return template, 0, 0
        state, step = self.ck.restore(template, step=step)
        if int(state["fp"]) != int(template["fp"]):
            raise ValueError(
                "checkpoint directory holds streaming state for a "
                "different dataset or plan (fingerprint mismatch) — point "
                "checkpoint_dir at a fresh directory per run"
            )
        return state, step // self.PHASE, step % self.PHASE


def job_checkpoint_dir(root: str, job: str) -> str:
    """Stable per-job streaming-checkpoint directory under `root`: the job
    name slugged to a filesystem-safe form and suffixed with a CRC of the
    raw name, so names that slug alike still differ."""
    slug = "".join(c if c.isalnum() or c in "-_" else "_" for c in job)[:64]
    return os.path.join(root, f"{slug}-{zlib.crc32(job.encode()):08x}")


def rank_checkpoint_dir(directory: str, mesh) -> str:
    """Where a rank of `mesh` keeps its streamed state under `directory`:
    the directory itself over one rank, `rank{r}-of-{W}` below it over W.
    Raises if `directory` holds state of a run over another number of
    ranks: its shards' filters and tables would not be this run's."""
    W = mesh.world_size
    found = set()
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            hit = re.fullmatch(r"rank\d+-of-(\d+)", name)
            if hit:
                found.add(int(hit.group(1)))
            elif name.startswith("step_"):
                found.add(1)
    if found - {W}:
        raise ValueError(
            f"checkpoint directory {directory} holds streamed state of a "
            f"run over {sorted(found - {W})} rank(s), not {W}: resume under "
            f"the same number of ranks, or point checkpoint_dir at a fresh "
            f"directory")
    if W == 1:
        return directory
    return os.path.join(directory, f"rank{mesh.rank}-of-{W}")


def _fingerprint(batches, **params) -> int:
    """CRC of the analysis parameters and the first batch's content."""
    h = zlib.crc32(repr(sorted(params.items())).encode())
    for batch in batches:
        h = zlib.crc32(batch.bases.cpu().numpy().tobytes(), h)
        h = zlib.crc32(batch.lengths.cpu().numpy().tobytes(), h)
        break
    return h


_COUNTERS = ("batches_pass1", "batches_pass2", "occurrences_total",
             "occurrences_admitted", "table_overflow", "route_overflow")


def _counters(stats: StreamStats) -> torch.Tensor:
    return torch.tensor([getattr(stats, f) for f in _COUNTERS],
                        dtype=torch.int64)


def _restore_counters(stats: StreamStats, t: torch.Tensor) -> None:
    for f, v in zip(_COUNTERS, t.tolist()):
        setattr(stats, f, int(v))


def _run_two_pass(batches, *, stats: StreamStats, checkpoint_dir,
                  fingerprint_params: dict, state_fn, load_fn,
                  pass1_step, pass2_step, mesh=None) -> None:
    """The two-pass skeleton: checkpoint restore (with the fingerprint
    guard), batch skipping, per-batch saves, counter persistence and the
    pass-1 against pass-2 batch count check.  `state_fn(fp)` snapshots the
    state, `load_fn(state)` restores it, `pass1_step(batch)` /
    `pass2_step(batch)` process one batch.

    Over the ranks of `mesh` every rank resumes at the ranks' earliest
    saved step.  A rank saves a batch only once every rank has finished
    the previous one (each batch's exchanges wait for all), so a run
    stopped between two ranks' saves leaves them one batch apart, and the
    step before a rank's newest is still on disk (the checkpoint keeps
    2)."""
    require_reiterable(batches)
    ck = StreamCheckpoint(checkpoint_dir) if checkpoint_dir else None
    fp = 0
    phase, start = 0, 0
    if ck is not None:
        fp = _fingerprint(batches, **fingerprint_params)
        step = ck.latest()
        if mesh is not None:
            step = int(mesh.min(torch.tensor(step)))
        state, phase, start = ck.restore(state_fn(fp), step)
        load_fn(state)
        _restore_counters(stats, state["counters"])
        stats.resumed = phase > 0 or start > 0

    if phase == 0:
        for i, batch in enumerate(batches):
            if i < start:
                continue
            pass1_step(batch)
            stats.batches_pass1 += 1
            if ck is not None:
                ck.save(0, i + 1, state_fn(fp))
        phase, start = 1, 0

    for i, batch in enumerate(batches):
        if i < start:
            continue
        pass2_step(batch)
        stats.batches_pass2 += 1
        if ck is not None:
            ck.save(1, i + 1, state_fn(fp))
    if not stats.resumed and stats.batches_pass2 != stats.batches_pass1:
        raise RuntimeError(
            f"batch source yielded {stats.batches_pass1} batches in pass 1 "
            f"but {stats.batches_pass2} in pass 2 — the source must "
            f"re-stream identically (is it deterministic?)"
        )


def streaming_kmer_analysis(
    batches,
    *,
    k: int,
    capacity: int,
    bloom_bits: int,
    num_hashes: int = 3,
    checkpoint_dir: Optional[str] = None,
    backend=None,
    device=None,
):
    """Single-device two-pass streamed count table.

    Args:
      batches: re-iterable source of fixed-shape ReadSet batches; iterated
        twice.  Each batch moves to `device` (default: the first batch's
        device) while it is processed.
      capacity: running-table rows, sized for the true (>= 2-sighting)
        k-mer population, not the raw occurrence population.
      bloom_bits: slots per Bloom filter (two filters are kept).
      checkpoint_dir: when set, state checkpoints after every batch and a
        later call with the same directory resumes there.
    Returns:
      (run, stats): the running count-table dict (the schema of
      `count_occurrences`) and a `StreamStats`.
    """
    if device is None:
        require_reiterable(batches)
        device = next(iter(batches)).bases.device
    f1 = bloom.empty(bloom_bits, num_hashes, device=device)
    f2 = bloom.empty(bloom_bits, num_hashes, device=device)
    run = kmer_analysis.empty_count_table(capacity, device=device)
    stats = StreamStats()

    def state_fn(fp):
        return {"f1_bits": f1.bits, "f2_bits": f2.bits,
                "counters": _counters(stats),
                "fp": torch.tensor(fp, dtype=torch.int64),
                **{f"run_{key}": v for key, v in run.items()}}

    def load_fn(state):
        nonlocal f1, f2, run
        f1 = bloom.BloomFilter(bits=state["f1_bits"], num_hashes=num_hashes)
        f2 = bloom.BloomFilter(bits=state["f2_bits"], num_hashes=num_hashes)
        run = {key[len("run_"):]: v for key, v in state.items()
               if key.startswith("run_")}

    def pass1_step(batch):
        nonlocal f1, f2
        hi, lo, _, _, valid = kmer_analysis.occurrences(
            batch.to(device), k=k, backend=backend)
        f1, f2 = kmer_analysis.bloom_observe(f1, f2, hi, lo, valid)

    def pass2_step(batch):
        nonlocal run
        hi, lo, left, right, valid = kmer_analysis.occurrences(
            batch.to(device), k=k, backend=backend)
        admitted = kmer_analysis.bloom_admit(f2, hi, lo, valid)
        stats.occurrences_total += int(valid.sum())
        stats.occurrences_admitted += int(admitted.sum())
        tab = kmer_analysis.count_occurrences(
            hi, lo, left, right, admitted, capacity=capacity)
        del hi, lo, left, right, valid, admitted
        run = kmer_analysis.merge_counts(run, tab, capacity=capacity)
        # per-fold overflow events (>= 1 means keys were cut); the
        # counters checkpoint with the state, so a resume keeps them
        stats.table_overflow += int(tab["overflow"]) + int(run["overflow"])

    _run_two_pass(
        batches, stats=stats, checkpoint_dir=checkpoint_dir,
        fingerprint_params=dict(k=k, capacity=capacity,
                                bloom_bits=bloom_bits,
                                num_hashes=num_hashes),
        state_fn=state_fn, load_fn=load_fn,
        pass1_step=pass1_step, pass2_step=pass2_step,
    )
    return run, stats


def sharded_streaming_kmer_analysis(
    batches,
    mesh,
    *,
    k: int,
    capacity: int,
    bloom_bits: int,
    pre_capacity: int,
    route_capacity: Optional[int] = None,
    num_hashes: int = 3,
    checkpoint_dir: Optional[str] = None,
    backend=None,
    device=None,
):
    """Owner-partitioned two-pass streamed count table over S shards.

    Filters and the running table are sharded by k-mer hash ownership:
    each batch pre-combines a shard, routes entries to their owners, and
    an owner updates its filter shard and folds into its slice of the
    running table (`dist.stages.sharded_bloom_observe` /
    `sharded_stream_fold`), so admission and counts are globally exact.

    Args:
      mesh: the shard count S, a `DataMesh` or a `Mesh` context.  Over W
        ranks a rank holds S/W shards' filters and table slices.
      bloom_bits: slots of each per-shard filter ([S/W, bloom_bits] bits
        a rank for each of the two filters).
      capacity: per-shard running-table rows.
      checkpoint_dir: over W > 1 ranks each rank's state goes to its own
        subdirectory (`rank_checkpoint_dir`).
    Returns:
      (run, stats): the running table with flat [S * capacity] arrays in
      the owner layout of `sharded_kmer_analysis` (keys hi, lo, count,
      left_cnt, right_cnt), gathered over the ranks, and a `StreamStats`
      with the route overflow.
    """
    from repro_torch.dist import stages
    from repro_torch.dist.pipeline import data_mesh_of

    m = data_mesh_of(mesh)
    S, n = m.num_shards, m.local_shards
    if device is None:
        require_reiterable(batches)
        device = next(iter(batches)).bases.device
    if checkpoint_dir:
        checkpoint_dir = rank_checkpoint_dir(checkpoint_dir, m)
    f1_bits = torch.zeros((n, bloom_bits), dtype=torch.bool, device=device)
    f2_bits = torch.zeros((n, bloom_bits), dtype=torch.bool, device=device)
    empty = kmer_analysis.empty_count_table(capacity, device=device)
    # owner layout: rows [i*capacity, (i+1)*capacity) are the slice of
    # the rank's i-th shard
    run = {key: empty[key].repeat((n,) + (1,) * (empty[key].dim() - 1))
           for key in stages.RUN_KEYS}
    stats = StreamStats()

    def state_fn(fp):
        return {"f1_bits": f1_bits, "f2_bits": f2_bits,
                "counters": _counters(stats),
                "fp": torch.tensor(fp, dtype=torch.int64),
                **{f"run_{key}": v for key, v in run.items()}}

    def load_fn(state):
        nonlocal f1_bits, f2_bits, run
        f1_bits, f2_bits = state["f1_bits"], state["f2_bits"]
        run = {key[len("run_"):]: v for key, v in state.items()
               if key.startswith("run_")}

    def pass1_step(batch):
        nonlocal f1_bits, f2_bits
        f1_bits, f2_bits, route_ovf, pre_ovf = stages.sharded_bloom_observe(
            batch.to(device), m, f1_bits, f2_bits, k=k,
            pre_capacity=pre_capacity, route_capacity=route_capacity,
            num_hashes=num_hashes, backend=backend)
        stats.route_overflow += int(route_ovf)
        stats.table_overflow += int(pre_ovf)

    def pass2_step(batch):
        nonlocal run
        run, counts, route_ovf, table_ovf = stages.sharded_stream_fold(
            batch.to(device), m, f2_bits, run, k=k, capacity=capacity,
            pre_capacity=pre_capacity, route_capacity=route_capacity,
            num_hashes=num_hashes, backend=backend)
        stats.occurrences_total += int(counts[0])
        stats.occurrences_admitted += int(counts[1])
        stats.route_overflow += int(route_ovf)
        stats.table_overflow += int(table_ovf)

    _run_two_pass(
        batches, stats=stats, checkpoint_dir=checkpoint_dir,
        fingerprint_params=dict(k=k, capacity=capacity,
                                bloom_bits=bloom_bits,
                                num_hashes=num_hashes, num_shards=S),
        state_fn=state_fn, load_fn=load_fn,
        pass1_step=pass1_step, pass2_step=pass2_step, mesh=m,
    )
    return {key: m.gather(v) for key, v in run.items()}, stats
