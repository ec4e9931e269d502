"""Out-of-core streaming ingest + assembly (mirrors `repro.stream`).

Datasets far larger than device memory enter here: a dataset is a *batch
source* (a re-iterable stream of fixed-shape `ReadSet` batches on the
host), k-mer analysis is the two-pass Bloom admission of §II-A/§II-B with
persistent filter state, and every per-batch partial folds into
fixed-capacity tables, so device memory is a function of the batch size
and the plan's capacities, never of the read count.

    from repro_torch.api import Assembler, AssemblyPlan, Local
    from repro_torch.data.fastq import iter_fastq_batches
    from repro_torch.stream import BatchSource

    src = BatchSource(lambda: iter_fastq_batches(
        path, batch_reads=32768, max_len=150, insert_size=400))
    plan = AssemblyPlan.from_stream(32768, 150, unique_kmers=500_000)
    out = Assembler(plan, Local()).assemble_stream(src)
"""
from .analysis import (
    StreamCheckpoint,
    StreamStats,
    job_checkpoint_dir,
    sharded_streaming_kmer_analysis,
    streaming_kmer_analysis,
)
from .batches import (
    BatchSource,
    batches_from_readset,
    check_batch_shapes,
    pad_batch,
    require_reiterable,
)

__all__ = [
    "BatchSource",
    "StreamCheckpoint",
    "StreamStats",
    "batches_from_readset",
    "check_batch_shapes",
    "job_checkpoint_dir",
    "pad_batch",
    "require_reiterable",
    "sharded_streaming_kmer_analysis",
    "streaming_kmer_analysis",
]
