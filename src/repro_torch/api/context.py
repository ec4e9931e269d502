"""Execution contexts: where the read-proportional stages run (mirrors
`repro.api.context`).

`Assembler` drives Algorithm 1 + Algorithm 3 against the stage protocol
below: the in-memory stages (`prepare`, `kmer_set`, `align`, `extend`,
`link_candidates`) and the streaming ones (`prepare_stream`,
`stream_kmer_set`, `align_batch`).  Everything a context returns is in
the global layout, so the Assembler never branches on the context.

  * `Local()` runs every stage on one device;
  * `Mesh(num_shards)` runs the read-proportional stages (k-mer analysis,
    alignment, local assembly, link witnesses) per shard with the paper's
    owner exchanges between them (`repro_torch.dist`), and the
    contig-scale graph work once.  Its shards run one after another on
    one device, each on its row block, the exchange a transpose, so each
    shard computes what the reference's shard computes on its own device.
    `Mesh(num_shards, group=g)` spreads the shards over the W ranks of a
    process group, one device a rank (`launch.mesh`): rank r holds shards
    [r*S/W, (r+1)*S/W), the exchanges are NCCL (or gloo) all-to-alls,
    and the contig-scale work runs replicated on every rank, which all
    return the same result.

Both run on the CUDA card unless the caller asks for the CPU, and never
fall back: without a visible card and without `device="cpu"` they raise.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.core import alignment, kmer_analysis, local_assembly, \
    scaffolding
from repro_torch.core.exchange import DataMesh
from repro_torch.launch.mesh import group_mesh


def _device(device, who: str) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}(): no CUDA device is visible; pass "
                f"{who}(device='cpu') to run on the CPU")
        device = "cuda"
    return torch.device(device)


class ExecutionContext:
    """Stage protocol (`prepare`, `kmer_set`, `align`, `extend`,
    `link_candidates`)."""

    num_shards: int = 1

    def prepare(self, reads, plan) -> None:
        """Bind the dataset + plan; called once per run."""
        raise NotImplementedError

    def kmer_set(self, k: int, prev):
        """Counted, finalized k-mer set for this round; `prev` is None or
        the previous round's (contigs, alive).  Returns (KmerSet, dict)."""
        raise NotImplementedError

    def align(self, contigs, alive, k: int):
        """Alignments of every read against the live contigs ([R, 2])."""
        raise NotImplementedError

    def extend(self, contigs, alive, al, k: int):
        """Local-assembly extension of contig ends (§II-G)."""
        raise NotImplementedError

    def link_candidates(self, al, contigs, alive):
        """Per-read splint/span link witnesses (flat candidate arrays)."""
        raise NotImplementedError

    # ---- streaming protocol ----

    def prepare_stream(self, plan, *, checkpoint_dir=None) -> None:
        """Bind a plan for out-of-core execution (no resident read set)."""
        raise NotImplementedError

    def stream_kmer_set(self, k: int, batches, prev):
        """Two-pass streamed k-mer set over a re-iterable batch source:
        returns (KmerSet, overflow dict, StreamStats)."""
        raise NotImplementedError

    def align_batch(self, batch, contigs, sidx, seed_len: int):
        """Alignments of one batch (already on the context's device)
        against the seed index."""
        raise NotImplementedError

    def _kmer_ckpt_dir(self, k: int):
        base = getattr(self, "_stream_ckpt", None)
        return None if base is None else os.path.join(base, f"k{k}")

    def spawn(self) -> "ExecutionContext":
        """A fresh context of the same kind on the same device (and shard
        count), sharing none of a run's state (bound plan, checkpoint
        dir, overflow counters): runs multiplexed onto one device each
        take a spawn, or they would clobber each other's bindings."""
        raise NotImplementedError

    def overflow(self) -> dict:
        """Accumulated overflow counts (reported, never dropped)."""
        return dict(self._overflow)

    def _note_overflow(self, key: str, n) -> None:
        self._overflow[key] = self._overflow.get(key, 0) + int(n)

    def _reset_overflow(self) -> None:
        self._overflow = {}


class Local(ExecutionContext):
    """Single-device execution.

    device=None means the CUDA card, and raises if none is visible; pass
    device="cpu" to run the plain versions of the kernels on the CPU.
    """

    def __init__(self, device=None):
        self.device = _device(device, "Local")
        self._reset_overflow()

    def spawn(self) -> "Local":
        return Local(device=self.device)

    def prepare(self, reads, plan) -> None:
        self.reads = reads.to(self.device)
        self.plan = plan
        self._reset_overflow()

    def kmer_set(self, k: int, prev):
        plan = self.plan
        hi, lo, left, right, valid = kmer_analysis.occurrences(
            self.reads, k=k, backend=plan.kernel_backend)
        if plan.low_memory:
            valid = kmer_analysis.admit_two_sightings(
                hi, lo, valid,
                bloom_bits=max(1 << 16, plan.kmer_capacity * 8))
        tab = kmer_analysis.count_occurrences(
            hi, lo, left, right, valid, capacity=plan.kmer_capacity)
        del hi, lo, left, right, valid
        if prev is not None:
            from .assembler import extract_contig_kmers

            contigs, alive = prev
            ptab = extract_contig_kmers(
                contigs, alive, k=k, capacity=plan.kmer_capacity,
                weight=plan.contig_pseudo_weight,
                backend=plan.kernel_backend)
            tab = kmer_analysis.merge_counts(tab, ptab,
                                             capacity=plan.kmer_capacity)
        overflow = bool(tab["overflow"])
        self._note_overflow("kmer_table", overflow)
        kset = kmer_analysis.finalize(tab, min_count=plan.min_count,
                                      policy=plan.policy)
        return kset, {"table": overflow}

    def align(self, contigs, alive, k: int):
        seed_len = min(k, 27)
        sidx = alignment.build_seed_index(
            contigs, alive, seed_len=seed_len, capacity=self.plan.seed_cap,
            backend=self.plan.kernel_backend)
        return alignment.align_reads(
            self.reads, contigs, sidx, seed_len=seed_len,
            stride=self.plan.seed_stride, gapped=self.plan.gapped_align,
            backend=self.plan.kernel_backend)

    def extend(self, contigs, alive, al, k: int):
        extended, _walk = local_assembly.extend_contigs(
            self.reads, contigs, alive, al.contig[:, 0],
            mer_sizes=self.plan.ladder(k),
            capacity=self.plan.walk_capacity,
            max_ext=self.plan.max_ext,
            backend=self.plan.kernel_backend)
        return extended

    def link_candidates(self, al, contigs, alive):
        clens = torch.where(alive, contigs.lengths, 0)
        return scaffolding.candidate_links(al, self.reads, clens)

    # ---- streaming ----

    def prepare_stream(self, plan, *, checkpoint_dir=None) -> None:
        self.plan = plan
        self._stream_ckpt = checkpoint_dir
        self._reset_overflow()

    def stream_kmer_set(self, k: int, batches, prev):
        from repro_torch.stream import analysis as stream_analysis

        plan = self.plan
        run, sstats = stream_analysis.streaming_kmer_analysis(
            batches, k=k, capacity=plan.kmer_capacity,
            bloom_bits=plan.bloom_slots,
            checkpoint_dir=self._kmer_ckpt_dir(k),
            backend=plan.kernel_backend, device=self.device)
        if prev is not None:
            from .assembler import extract_contig_kmers

            contigs, alive = prev
            ptab = extract_contig_kmers(
                contigs, alive, k=k, capacity=plan.kmer_capacity,
                weight=plan.contig_pseudo_weight,
                backend=plan.kernel_backend)
            run = kmer_analysis.merge_counts(run, ptab,
                                             capacity=plan.kmer_capacity)
            sstats.table_overflow += int(run["overflow"])
        self._note_overflow("kmer_table", sstats.table_overflow)
        kset = kmer_analysis.finalize(run, min_count=plan.min_count,
                                      policy=plan.policy)
        return kset, {"table": bool(sstats.table_overflow)}, sstats

    def align_batch(self, batch, contigs, sidx, seed_len: int):
        return alignment.align_reads(
            batch, contigs, sidx, seed_len=seed_len,
            stride=self.plan.seed_stride, gapped=self.plan.gapped_align,
            backend=self.plan.kernel_backend)


class Mesh(ExecutionContext):
    """Distributed execution over `num_shards` shards (the reference's
    `Mesh` on a 1-D "data" mesh of devices).

    Read-proportional stages run per shard through `repro_torch.dist`;
    k-mer and link state move through the owner exchanges; contig-scale
    graph work runs once.  Without a group the shards run on one device:
    the CUDA card unless `device="cpu"`; without a visible card and
    without it, raises.  `group`, a `torch.distributed` process group
    (`launch.mesh.make_data_mesh(S).group`), spreads them over its W
    ranks, W dividing num_shards: each rank holds its shards' read rows
    and owner tables on its card `cuda:{local_rank}` over NCCL, or on the
    CPU over gloo with `device="cpu"`, and every rank returns the same
    result.
    """

    def __init__(self, num_shards: int = 8, *, device=None, group=None):
        if num_shards < 1:
            raise ValueError(f"Mesh needs num_shards >= 1, got {num_shards}")
        self.num_shards = int(num_shards)
        if group is None:
            self.data_mesh = DataMesh(self.num_shards,
                                      _device(device, "Mesh"))
        else:
            self.data_mesh = group_mesh(self.num_shards, group,
                                        device=device)
        self.device = self.data_mesh.device
        self.group = group
        self._reset_overflow()

    def spawn(self) -> "Mesh":
        # the device, the shard count and the group carry over; per-run
        # bindings (plan, sharded reads, checkpoints, overflow) start fresh
        return Mesh(num_shards=self.num_shards, device=self.device,
                    group=self.group)

    def _adapt_plan(self, plan, constructor: str):
        """Validate a plan for this shard count (in-memory and streaming).

        A single-shard plan adapts: the global capacities carry over and
        the per-shard ones (pre_cap, route_cap, ...) re-derive for S
        shards, so exchange buffers and plan.bytes() are priced for S."""
        if plan.num_shards not in (1, self.num_shards):
            raise ValueError(
                f"plan was sized for {plan.num_shards} shards but the mesh "
                f"has {self.num_shards}; re-plan with "
                f"AssemblyPlan.{constructor}(..., num_shards="
                f"{self.num_shards})"
            )
        if plan.num_shards != self.num_shards:
            plan = dataclasses.replace(plan, num_shards=self.num_shards)
        return plan

    def prepare(self, reads, plan) -> None:
        from repro_torch.dist import pipeline as dist

        self.plan = self._adapt_plan(plan, "from_dataset")
        # the rank's shards' rows only, cut before they reach the device
        self.sharded = dist.shard_reads(reads, self.num_shards,
                                        self.data_mesh.shards, self.device)
        self._reset_overflow()

    def kmer_set(self, k: int, prev):
        from repro_torch.dist import pipeline as dist, stages

        plan = self.plan
        if isinstance(prev, dict):
            # a precomputed count table has no shard layout to exchange;
            # refusing beats dropping the §II-H evidence
            raise NotImplementedError(
                "Mesh.kmer_set needs (contigs, alive) for the contig-kmer "
                "owner exchange; a precomputed table dict is Local-only")
        # route_capacity: the plan's explicit override if any, else the
        # stage derives it a round (contig-carrying rounds need wider lanes)
        kset_sh, route_ovf, table_ovf = stages.sharded_kmer_analysis(
            self.sharded, self.data_mesh, k=k,
            pre_capacity=plan.pre_cap,
            capacity=plan.shard_table_cap,
            route_capacity=plan.route_capacity,
            min_count=plan.min_count, policy=plan.policy,
            prev_contigs=prev,
            contig_weight=plan.contig_pseudo_weight,
            backend=plan.kernel_backend)
        route_ovf, table_ovf = int(route_ovf), int(table_ovf)
        self._note_overflow("kmer_route", route_ovf)
        self._note_overflow("kmer_table", table_ovf)
        merged = dist.gather_ksets(kset_sh, capacity=plan.kmer_capacity,
                                   mesh=self.data_mesh)
        del kset_sh
        gather_ovf = bool(merged["overflow"])
        self._note_overflow("kmer_gather", gather_ovf)
        # the per-shard finalize applied the globally correct min_count
        # (ownership is total); finalizing the gathered table recomputes
        # the extensions from the summed histograms
        kset = kmer_analysis.finalize(merged, min_count=plan.min_count,
                                      policy=plan.policy)
        return kset, {"table": bool(table_ovf) or gather_ovf,
                      "route": route_ovf}

    def align(self, contigs, alive, k: int):
        from repro_torch.dist import stages

        seed_len = min(k, 27)
        sidx = alignment.build_seed_index(
            contigs, alive, seed_len=seed_len, capacity=self.plan.seed_cap,
            backend=self.plan.kernel_backend)
        return stages.sharded_align(
            self.sharded, contigs, sidx, self.data_mesh,
            seed_len=seed_len, stride=self.plan.seed_stride,
            gapped=self.plan.gapped_align,
            backend=self.plan.kernel_backend)

    def extend(self, contigs, alive, al, k: int):
        from repro_torch.dist import stages

        extended, ovf = stages.sharded_extend(
            self.sharded, contigs, alive, al, self.data_mesh,
            mer_sizes=self.plan.ladder(k),
            capacity=self.plan.walk_capacity,
            max_ext=self.plan.max_ext,
            out_factor=self.plan.localize_out_factor,
            backend=self.plan.kernel_backend)
        self._note_overflow("localize", ovf)
        return extended

    def link_candidates(self, al, contigs, alive):
        from repro_torch.dist import stages

        cands, ovf = stages.sharded_link_candidates(
            self.sharded, al, contigs, alive, self.data_mesh,
            out_factor=self.plan.localize_out_factor)
        self._note_overflow("localize_pairs", ovf)
        return cands

    # ---- streaming ----

    def prepare_stream(self, plan, *, checkpoint_dir=None) -> None:
        self.plan = self._adapt_plan(plan, "from_stream")
        self._stream_ckpt = checkpoint_dir
        self._reset_overflow()

    def stream_kmer_set(self, k: int, batches, prev):
        from repro_torch.stream import analysis as stream_analysis

        plan = self.plan
        run, sstats = stream_analysis.sharded_streaming_kmer_analysis(
            batches, self.data_mesh, k=k,
            capacity=plan.shard_table_cap,
            bloom_bits=plan.bloom_slots,
            pre_capacity=plan.pre_cap,
            route_capacity=plan.route_capacity,
            checkpoint_dir=self._kmer_ckpt_dir(k),
            backend=plan.kernel_backend, device=self.device)
        # ownership is total, so the owner slices merge into one key-sorted
        # table by a re-sort, before any finalize, so §II-H contig evidence
        # merges into raw counts as on the Local streaming path
        merged = kmer_analysis.aggregate_weighted(
            run["hi"], run["lo"], run["count"], run["left_cnt"],
            run["right_cnt"], run["count"] > 0,
            capacity=plan.kmer_capacity)
        del run
        sstats.table_overflow += int(merged["overflow"])
        if prev is not None:
            from .assembler import extract_contig_kmers

            contigs, alive = prev
            ptab = extract_contig_kmers(
                contigs, alive, k=k, capacity=plan.kmer_capacity,
                weight=plan.contig_pseudo_weight,
                backend=plan.kernel_backend)
            merged = kmer_analysis.merge_counts(merged, ptab,
                                                capacity=plan.kmer_capacity)
            sstats.table_overflow += int(merged["overflow"])
        self._note_overflow("kmer_table", sstats.table_overflow)
        self._note_overflow("kmer_route", sstats.route_overflow)
        kset = kmer_analysis.finalize(merged, min_count=plan.min_count,
                                      policy=plan.policy)
        return kset, {"table": bool(sstats.table_overflow),
                      "route": int(sstats.route_overflow)}, sstats

    def align_batch(self, batch, contigs, sidx, seed_len: int):
        from repro_torch.dist import pipeline as dist, stages

        sharded = dist.shard_reads(batch, self.num_shards,
                                   self.data_mesh.shards)
        al = stages.sharded_align(
            sharded, contigs, sidx, self.data_mesh,
            seed_len=seed_len, stride=self.plan.seed_stride,
            gapped=self.plan.gapped_align,
            backend=self.plan.kernel_backend)
        B = batch.num_reads
        return alignment.Alignments(*(x[:B] for x in al))
