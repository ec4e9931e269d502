"""Shared assembly plans for examples and benchmarks (mirrors
`repro.configs.assembly_presets`, on the port's `AssemblyPlan` and
`ExtensionPolicy`).

These are presets for the small MGSim communities the walkthroughs use;
real datasets should size their plan with `AssemblyPlan.from_dataset`
instead.  Keyword overrides replace the preset's fields.
"""
from __future__ import annotations

from repro_torch.api.plan import AssemblyPlan
from repro_torch.core.kmer_analysis import ExtensionPolicy


def small_community_plan(**overrides) -> AssemblyPlan:
    """Single-k contig-generation plan for ~10^2-kb MGSim communities:
    one k (21), no local assembly, capacities roomy for ~1k x 60 bp
    reads."""
    base = dict(
        k_min=21, k_max=21, k_step=4,
        kmer_capacity=1 << 15,
        contig_cap=256,
        max_contig_len=2048,
        run_local_assembly=False,
        policy=ExtensionPolicy(err_rate=0.05),
    )
    base.update(overrides)
    return AssemblyPlan(**base)


def quality_plan(**overrides) -> AssemblyPlan:
    """Iterative-k full-pipeline plan for the Table-I style quality runs."""
    base = dict(
        k_min=17, k_max=21, k_step=4,
        kmer_capacity=1 << 15,
        contig_cap=512,
        max_contig_len=2048,
        walk_capacity=1 << 16,
        link_capacity=1 << 11,
        max_scaffold_len=1 << 12,
        policy=ExtensionPolicy(err_rate=0.05),
    )
    base.update(overrides)
    return AssemblyPlan(**base)
