"""AssemblyPlan: one derived capacity plan for a run (mirrors
`repro.api.plan`).

`AssemblyPlan.from_dataset(reads, k_range, slack=...)` derives every stage
capacity from the dataset shape the paper's §II-B way: provision from an
upfront cardinality estimate, report overflow, never grow.
`AssemblyPlan.from_stream(batch_reads, max_len, ...)` sizes an out-of-core
plan from the batch shape and the estimated k-mer population instead, so
its bill does not grow with the read count.  `plan.bytes()` states the
memory bill before any array is allocated, per shard when the plan is
sized for `num_shards` shards of a `Mesh` context.  The fields are the
reference's, so a reference plan's `dataclasses.asdict` builds this one
(`bridge.plan_from_fields`).  One difference: `kernel_backend` is None
(kernels on the card, plain versions on the CPU) or "torch" (plain
versions everywhere), see `kernels.ops`.

The bill is the reference's, per shard.  On one card a `Mesh` keeps all
S shards' owner tables and route buffers resident at once, so its peak
is not `bytes()`; `chip_smoke.py` prints the two side by side.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.kmer_analysis import ExtensionPolicy
from repro_torch.dist.capacity import default_route_capacity, next_pow2

BACKENDS = (None, "torch")


class PlanError(ValueError):
    """A plan parameter is invalid (raised before any work starts)."""


def _ladder(k: int, step: int) -> tuple:
    """Mer-size ladder for the dynamic walk (§II-G)."""
    return (max(11, k - step), k, min(k + step, 27))


def _normalize_k_range(k_range: tuple) -> tuple:
    """(k_min, k_max) -> (k_min, k_max, step); 3-tuples pass through."""
    if len(k_range) == 2:
        return (k_range[0], k_range[1], max(k_range[1] - k_range[0], 1))
    return tuple(k_range)


def _clamp_contig_cap(base: dict, overrides: dict) -> dict:
    """Respect the (contig, mer) tag-space limit of the walk ladder unless
    the caller pinned contig_cap explicitly."""
    if "contig_cap" not in overrides:
        step = base.get("walk_ladder_step", 4)
        hi_mer = min(base["k_max"] + step, 27)
        base["contig_cap"] = min(
            base["contig_cap"], 1 << min(16, 62 - 2 * hi_mer)
        )
    return base


def validate_assembly_params(
    *,
    k_min: int,
    k_max: int,
    k_step: int,
    min_count: int,
    kmer_capacity: int,
    contig_cap: int,
    max_contig_len: int,
    walk_capacity: int,
    link_capacity: int,
    max_scaffold_len: int,
    max_members: int,
    max_ext: int,
    walk_ladder_step: int,
    seed_stride: int,
    where: str = "AssemblyPlan",
) -> None:
    """Reject invalid parameters with actionable errors (fail fast)."""
    if k_min > k_max:
        raise PlanError(
            f"{where}: k_min={k_min} > k_max={k_max}; the iterative-k "
            f"schedule runs k_min..k_max and must be non-empty"
        )
    if k_step <= 0:
        raise PlanError(f"{where}: k_step={k_step} must be positive")
    for k in range(k_min, k_max + 1, k_step):
        if k % 2 == 0:
            raise PlanError(
                f"{where}: k={k} is even; even k makes a k-mer equal its "
                f"own reverse complement, breaking canonicalization — use "
                f"odd k (adjust k_min/k_step)"
            )
        if not 3 <= k <= 31:
            raise PlanError(
                f"{where}: k={k} outside the dual-lane packing range 3..31"
            )
        lo, mid, hi = _ladder(k, walk_ladder_step)
        if not lo < mid < hi:
            raise PlanError(
                f"{where}: walk ladder {(lo, mid, hi)} for k={k} is not "
                f"strictly increasing; the dynamic mer-walk needs a rung "
                f"below and above k (11 < k < 27 with "
                f"walk_ladder_step={walk_ladder_step})"
            )
        # the (contig, mer) walk tables embed the contig id in the spare
        # high bits of the dual-lane key (kmer.embed_tag); the ladder's
        # top rung fixes how many bits are spare
        tag_bits = min(16, 62 - 2 * hi)
        if contig_cap > (1 << tag_bits):
            raise PlanError(
                f"{where}: contig_cap={contig_cap} exceeds the (contig, "
                f"mer) tag space 2**{tag_bits} left by the k={k} walk "
                f"ladder (top rung {hi}); lower contig_cap or "
                f"walk_ladder_step"
            )
    caps = {
        "min_count": min_count,
        "kmer_capacity": kmer_capacity,
        "contig_cap": contig_cap,
        "max_contig_len": max_contig_len,
        "walk_capacity": walk_capacity,
        "link_capacity": link_capacity,
        "max_scaffold_len": max_scaffold_len,
        "max_members": max_members,
        "max_ext": max_ext,
        "seed_stride": seed_stride,
    }
    for name, v in caps.items():
        if int(v) <= 0:
            raise PlanError(
                f"{where}: {name}={v} must be positive — capacities are "
                f"static buffer sizes chosen before data is seen"
            )


@dataclasses.dataclass(frozen=True)
class AssemblyPlan:
    """Per-stage, per-shard capacity plan + algorithm knobs for one run.

    Capacities are global unless suffixed otherwise; the per-shard ones
    (`pre_capacity`, `shard_table_capacity`, `route_capacity`) matter only
    on a `Mesh` context and default to values derived from the global
    plan and `num_shards`.
    """

    # --- k schedule + thresholds (Alg. 1) ---
    k_min: int = 17
    k_max: int = 21
    k_step: int = 4
    min_count: int = 2
    policy: ExtensionPolicy = ExtensionPolicy()
    contig_pseudo_weight: int = 4
    low_memory: bool = False
    # --- pruning ---
    prune_alpha: float = 0.25
    prune_beta: float = 0.5
    # --- alignment ---
    seed_stride: int = 16
    gapped_align: bool = False
    # --- kernels: None (by tensor device) or "torch" (plain versions) ---
    kernel_backend: Optional[str] = None
    # --- local assembly ---
    walk_ladder_step: int = 4
    max_ext: int = 64
    run_local_assembly: bool = True
    # --- scaffolding ---
    min_link_support: int = 2
    max_members: int = 32
    # --- capacities (global) ---
    kmer_capacity: int = 1 << 15
    contig_cap: int = 512
    max_contig_len: int = 4096
    seed_capacity: Optional[int] = None   # default: 2 * kmer_capacity
    walk_capacity: int = 1 << 16
    link_capacity: int = 1 << 12
    max_scaffold_len: int = 1 << 13
    # --- distributed execution (Mesh) ---
    num_shards: int = 1
    slack: float = 2.0
    pre_capacity: Optional[int] = None          # per-shard pre-combine rows
    shard_table_capacity: Optional[int] = None  # per-shard owner-table rows
    route_capacity: Optional[int] = None        # per-(sender, dest) rows
    localize_out_factor: int = 2
    # --- streaming execution ---
    # batch_reads: rows per streamed batch (None = in-memory plan);
    # bloom_bits: per-shard Bloom filter slots of the two-pass admission
    # (None = derive from kmer_capacity).  Both set by `from_stream`.
    batch_reads: Optional[int] = None
    bloom_bits: Optional[int] = None
    # dataset shape (num_reads, max_len), recorded by `from_dataset` /
    # `bind` so `bytes()` can price the read-proportional buffers; for a
    # streaming plan (batch_reads, max_len)
    dataset_shape: Optional[tuple] = None

    def __post_init__(self):
        validate_assembly_params(
            k_min=self.k_min, k_max=self.k_max, k_step=self.k_step,
            min_count=self.min_count, kmer_capacity=self.kmer_capacity,
            contig_cap=self.contig_cap, max_contig_len=self.max_contig_len,
            walk_capacity=self.walk_capacity,
            link_capacity=self.link_capacity,
            max_scaffold_len=self.max_scaffold_len,
            max_members=self.max_members, max_ext=self.max_ext,
            walk_ladder_step=self.walk_ladder_step,
            seed_stride=self.seed_stride, where="AssemblyPlan",
        )
        if self.kernel_backend not in BACKENDS:
            raise PlanError(
                f"AssemblyPlan: kernel_backend={self.kernel_backend!r} "
                f"unknown; valid: {BACKENDS}"
            )
        if self.num_shards < 1:
            raise PlanError(f"AssemblyPlan: num_shards={self.num_shards} < 1")
        for name in ("seed_capacity", "pre_capacity",
                     "shard_table_capacity", "route_capacity"):
            v = getattr(self, name)
            if v is not None and int(v) <= 0:
                raise PlanError(
                    f"AssemblyPlan: {name}={v} must be positive (or None "
                    f"to derive it) — capacities are static buffer sizes"
                )
        if self.localize_out_factor < 1:
            raise PlanError(
                f"AssemblyPlan: localize_out_factor="
                f"{self.localize_out_factor} < 1 would drop reads by "
                f"construction"
            )
        if self.slack <= 0:
            raise PlanError(f"AssemblyPlan: slack={self.slack} must be > 0")
        if self.batch_reads is not None and (
            self.batch_reads < 2 or self.batch_reads % 2
        ):
            raise PlanError(
                f"AssemblyPlan: batch_reads={self.batch_reads} must be even "
                f"and >= 2 — batches hold whole read pairs"
            )
        if self.bloom_bits is not None and (
            self.bloom_bits <= 0 or self.bloom_bits & (self.bloom_bits - 1)
        ):
            raise PlanError(
                f"AssemblyPlan: bloom_bits={self.bloom_bits} must be a "
                f"positive power of two (Bloom positions mask the hash)"
            )

    def ks(self) -> list:
        return list(range(self.k_min, self.k_max + 1, self.k_step))

    def ladder(self, k: int) -> tuple:
        return _ladder(k, self.walk_ladder_step)

    @property
    def seed_cap(self) -> int:
        return self.seed_capacity or 2 * self.kmer_capacity

    @property
    def pre_cap(self) -> int:
        """Per-shard local pre-combine table rows (Mesh k-mer analysis)."""
        if self.pre_capacity is not None:
            return self.pre_capacity
        return max(1 << 8, next_pow2(-(-self.kmer_capacity
                                       // self.num_shards)) * 2)

    @property
    def shard_table_cap(self) -> int:
        """Per-shard owner-table rows (hash ownership splits ~evenly)."""
        if self.shard_table_capacity is not None:
            return self.shard_table_capacity
        return self.pre_cap

    @property
    def route_cap(self) -> int:
        if self.route_capacity is not None:
            return self.route_capacity
        return default_route_capacity(self.pre_cap, self.num_shards,
                                      slack=self.slack)

    @property
    def bloom_slots(self) -> int:
        """Per-shard Bloom filter slots of the streamed two-pass
        admission: 16x the shard's share of the k-mer table by default, so
        the filter sketches the raw distinct population (true k-mers +
        error singletons) at a low false-positive rate."""
        if self.bloom_bits is not None:
            return self.bloom_bits
        return next_pow2(max(1 << 14,
                             16 * self.kmer_capacity // self.num_shards))

    @classmethod
    def from_dataset(
        cls,
        reads,
        k_range: tuple = (17, 21, 4),
        *,
        num_shards: int = 1,
        slack: float = 2.0,
        unique_rate: float = 0.5,
        **overrides,
    ) -> "AssemblyPlan":
        """Size every stage capacity from dataset shape (§II-B).

        Args:
          reads: anything with `num_reads` / `max_len`; only the shape is
            read.
          k_range: (k_min, k_max, k_step) iterative-k schedule.
          num_shards: planned execution width (1 = Local).
          slack: the single headroom dial every capacity scales with.
          unique_rate: expected unique-kmer : occurrence ratio (~1/coverage
            for clean data; ->1 for error-heavy data).
          overrides: any AssemblyPlan field, overriding the derivation.
        """
        k_min, k_max, k_step = _normalize_k_range(k_range)
        R = int(reads.num_reads)
        L = int(reads.max_len)
        windows = max(L - k_min + 1, 1)
        occ = R * windows
        unique = max(int(unique_rate * occ), 1)
        kmer_capacity = max(1 << 10, next_pow2(int(slack * unique)))
        contig_cap = max(256, next_pow2(int(slack * unique // (2 * k_min))))
        max_contig_len = int(min(max(1 << 11, next_pow2(unique // 4)),
                                 1 << 15))
        walk_capacity = max(1 << 12, next_pow2(int(slack * occ / 2)))
        link_capacity = max(1 << 10, next_pow2(int(slack * 3 * R // 2) // 4))
        max_scaffold_len = int(min(4 * max_contig_len, 1 << 16))
        base = dict(
            k_min=k_min, k_max=k_max, k_step=k_step,
            kmer_capacity=kmer_capacity,
            contig_cap=contig_cap,
            max_contig_len=max_contig_len,
            walk_capacity=walk_capacity,
            link_capacity=link_capacity,
            max_scaffold_len=max_scaffold_len,
            num_shards=num_shards,
            slack=slack,
            dataset_shape=(R, L),
        )
        base.update(overrides)
        return cls(**_clamp_contig_cap(base, overrides))

    @classmethod
    def from_stream(
        cls,
        batch_reads: int,
        max_len: int,
        k_range: tuple = (17, 21, 4),
        *,
        unique_kmers: Optional[int] = None,
        bloom_bits: Optional[int] = None,
        num_shards: int = 1,
        slack: float = 2.0,
        unique_rate: float = 0.1,
        total_reads: Optional[int] = None,
        **overrides,
    ) -> "AssemblyPlan":
        """Size a streaming plan from the batch shape, not the dataset size.

        `plan.bytes()` is a function of `batch_reads`, `max_len` and the
        capacity estimates; `total_reads` is accepted for symmetry and
        ignored, so the bill does not grow with the dataset.

        Args:
          batch_reads: rows per streamed batch (even; whole pairs).
          max_len: batch column width (max read length).
          unique_kmers: estimate of the distinct true k-mer population
            (community genome content, the paper's §II-B cardinality
            estimate); defaults to `unique_rate` x one batch's occurrences.
          bloom_bits: per-shard Bloom filter slots (default: from the
            k-mer table).
          num_shards: planned execution width (1 = Local).
          total_reads: ignored for sizing.
        """
        del total_reads  # sizing must not depend on dataset size
        k_min, k_max, k_step = _normalize_k_range(k_range)
        B = int(batch_reads)
        L = int(max_len)
        windows = max(L - k_min + 1, 1)
        occ_batch = B * windows
        unique = max(int(unique_kmers or unique_rate * occ_batch), 1)
        kmer_capacity = max(1 << 10, next_pow2(int(slack * unique)))
        contig_cap = max(256, next_pow2(int(slack * unique // (2 * k_min))))
        max_contig_len = int(min(max(1 << 11, next_pow2(unique // 4)),
                                 1 << 15))
        # (contig, mer) pairs are occurrence-collapsed and bounded by the
        # assembled bases x rungs: a function of `unique`, not of reads
        walk_capacity = max(1 << 12, next_pow2(int(slack * 2 * unique)))
        # the link store is contig-pair scale (witnesses stream per batch)
        link_capacity = int(min(max(1 << 10,
                                    next_pow2(int(slack * 16 * contig_cap))),
                                1 << 16))
        max_scaffold_len = int(min(4 * max_contig_len, 1 << 16))
        base = dict(
            k_min=k_min, k_max=k_max, k_step=k_step,
            kmer_capacity=kmer_capacity,
            contig_cap=contig_cap,
            max_contig_len=max_contig_len,
            walk_capacity=walk_capacity,
            link_capacity=link_capacity,
            max_scaffold_len=max_scaffold_len,
            num_shards=num_shards,
            slack=slack,
            batch_reads=B,
            bloom_bits=bloom_bits,
            dataset_shape=(B, L),
        )
        base.update(overrides)
        return cls(**_clamp_contig_cap(base, overrides))

    def stage_bytes(self) -> dict:
        """Estimated peak static-buffer bytes per stage, per shard (the
        reference's bill): occurrence lanes 11 B a row, count tables 48 B
        a row, the seed index a dual-lane table + side arrays."""
        R, L = self.dataset_shape or (0, 0)
        per_shard_R = -(-R // self.num_shards) if R else 0
        occ_rows = per_shard_R * (max(L - self.k_min + 1, 1) if L else 0)
        out = {
            "kmer_occurrences": occ_rows * 11,
            # pre-combine + owner/merged count tables + finalized KmerSet
            "kmer_tables": (self.pre_cap if self.num_shards > 1 else
                            self.kmer_capacity) * 48
            + self.kmer_capacity * 48 * 2,
            "contigs": self.contig_cap * (self.max_contig_len + 12),
            "seed_index": self.seed_cap * 22,
            "alignments": per_shard_R * 2 * 20,
            "walk_tables": 3 * self.walk_capacity * 48,
            "links": self.link_capacity * 24,
            "scaffolds": self.contig_cap * (
                self.max_members * 9 + self.max_scaffold_len
            ),
        }
        if self.num_shards > 1:
            out["route_buffers"] = (
                self.num_shards * self.route_cap * 56
                + self.localize_out_factor * per_shard_R * (L + 8)
            )
        if self.batch_reads is not None:
            # two persistent Bloom filters (one byte a slot)
            out["bloom_filters"] = 2 * self.bloom_slots
        return out

    def bind(self, reads) -> "AssemblyPlan":
        """Copy of this plan with the dataset shape attached."""
        return dataclasses.replace(
            self, dataset_shape=(int(reads.num_reads), int(reads.max_len))
        )

    def bytes(self) -> int:
        """Estimated peak working-set bytes per shard for one run."""
        return int(sum(self.stage_bytes().values()))
