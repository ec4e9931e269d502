"""Iterative graph pruning (paper Algorithm 2, §II-E; mirrors
`repro.core.pruning`).

The depth cutoff tau rises geometrically (tau *= 1 + alpha); a contig is
pruned when it is short (<= 2k) and its depth is <= min(tau, beta *
neighbors-depth).  Rounds end when tau passes the maximum contig depth or
a round past tau > beta * max_depth prunes nothing.  All depth arithmetic
is float32, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PruneResult(NamedTuple):
    alive: torch.Tensor   # [C] bool
    rounds: int           # rounds executed
    pruned: int           # contigs removed


def neighbor_depth(depths, alive, ends_nbr, num_kmers: int):
    """Max depth among alive contigs sharing a fork vertex with each contig
    (the contig itself included)."""
    C = depths.shape[0]
    flat = ends_nbr.reshape(C, 8).to(torch.int64)
    live_depth = torch.where(alive, depths, 0.0)
    sel = torch.where(alive[:, None] & (flat >= 0), flat, num_kmers)
    fork_max = torch.zeros((num_kmers + 1,), dtype=torch.float32,
                           device=depths.device)
    fork_max.scatter_reduce_(0, sel.reshape(-1),
                             live_depth.repeat_interleave(8), "amax")
    gathered = torch.where(flat >= 0, fork_max[flat.clamp(min=0)], 0.0)
    return gathered.max(dim=-1).values


def prune(lengths, depths, ends_nbr, alive_in, *, k: int, num_kmers: int,
          alpha: float = 0.25, beta: float = 0.5) -> PruneResult:
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=depths.device)
    alive = alive_in & (lengths > 0)
    max_depth = torch.where(alive, depths, 0.0).max()
    short = lengths <= 2 * k
    tau, growth, beta_t = f32(1.0), f32(1.0 + alpha), f32(beta)
    rounds = removed = 0
    converged = False
    while bool(tau < max_depth) and not converged:
        nbr = neighbor_depth(depths, alive, ends_nbr, num_kmers)
        cut = torch.minimum(tau, beta_t * nbr)
        prune_now = alive & short & (depths <= cut)
        n_now = int(prune_now.sum())
        converged = n_now == 0 and bool(tau > beta_t * max_depth)
        alive = alive & ~prune_now
        removed += n_now
        tau = tau * growth
        rounds += 1
    return PruneResult(alive=alive, rounds=rounds, pruned=removed)
