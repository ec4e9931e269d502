"""Execution contexts: where the read-proportional stages run (mirrors
`repro.api.context`; `Local` only).

`Assembler` drives Algorithm 1 + Algorithm 3 against the stage protocol
below: the in-memory stages (`prepare`, `kmer_set`, `align`, `extend`,
`link_candidates`) and the streaming ones (`prepare_stream`,
`stream_kmer_set`, `align_batch`).  `Local` runs every stage on one
device: the CUDA card unless the caller asks for the CPU.  It never falls
back: without a visible card and without `device="cpu"` it raises.
"""
from __future__ import annotations

import os

import torch

from repro_torch.core import alignment, kmer_analysis, local_assembly, \
    scaffolding


class ExecutionContext:
    """Stage protocol (`prepare`, `kmer_set`, `align`, `extend`,
    `link_candidates`)."""

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
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Local(): no CUDA device is visible; pass "
                    "Local(device='cpu') to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self._reset_overflow()

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
