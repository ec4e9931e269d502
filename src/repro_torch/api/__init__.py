"""Assembler front door (mirrors `repro.api`).

    from repro_torch.api import Assembler, AssemblyPlan, Local, Mesh
"""
from .assembler import Assembler, IterationStats, extract_contig_kmers
from .context import ExecutionContext, Local, Mesh
from .plan import AssemblyPlan, PlanError, validate_assembly_params

__all__ = [
    "Assembler",
    "AssemblyPlan",
    "ExecutionContext",
    "IterationStats",
    "Local",
    "Mesh",
    "PlanError",
    "extract_contig_kmers",
    "validate_assembly_params",
]
