"""Distributed assembly (mirrors `repro.dist`).

`repro_torch.core` is the single-shard pipeline; this package shards it
with the paper's three distributed mechanisms: the owner exchange of
k-mer stores (§II-A), read localization (§II-I), and the per-shard
capacity discipline that keeps weak scaling flat (Table II).  The shards
run over a leading shard axis: all of them in one process on one card,
the exchange a transpose, or S/W a rank over the W ranks of a process
group (`core.exchange.DataMesh`), the exchange an all-to-all
(`core.exchange`).
"""
from . import capacity, pipeline
from . import stages  # noqa: F401  (distributed stages beyond k-mer analysis)
from .pipeline import (
    ShardedReads,
    distributed_kmer_analysis,
    gather_ksets,
    kmer_owner,
    localize_reads,
    shard_reads,
)

__all__ = [
    "ShardedReads",
    "capacity",
    "stages",
    "distributed_kmer_analysis",
    "gather_ksets",
    "kmer_owner",
    "localize_reads",
    "pipeline",
    "shard_reads",
]
