"""PyTorch/CUDA port of the MetaHipMer reproduction in `repro`.

The JAX package `repro` is the reference; this package mirrors its module
layout (`core/`, `kernels/`, `api/`, `data/`, `stream/`, `train/`) so
each module here can be checked against the reference module of the same
name.  It imports `torch`, never `jax`, and nothing of `repro`.

    from repro_torch.api import Assembler, AssemblyPlan, Local
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4))
    out = Assembler(plan, Local()).assemble(reads)
    splan = AssemblyPlan.from_stream(32768, 150, unique_kmers=500_000)
    out = Assembler(splan, Local()).assemble_stream(batch_source)

`Local()` runs on the CUDA card; `Local(device="cpu")` runs the plain
PyTorch versions of the kernels on the CPU.
"""
