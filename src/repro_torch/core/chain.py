"""Parallel chain formation by pointer doubling (mirrors `repro.core.chain`).

The graphs here are functional (<= 1 successor and <= 1 predecessor per
node after mutual-agreement filtering), so chains contract in O(log N)
bulk-synchronous rounds of pointer doubling.  Cycles are detected when a
node's accumulated distance reaches N and broken at the minimum-index node.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

NONE = -1


class Chains(NamedTuple):
    head: torch.Tensor       # [N] int64 chain head node (self for heads)
    dist: torch.Tensor       # [N] int32 distance from head
    was_cycle: torch.Tensor  # [N] bool node belonged to a cycle


def _double(pred, n_rounds: int):
    """Pointer doubling: returns (root, dist, minv) after n_rounds jumps."""
    n = pred.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=pred.device)
    has = pred >= 0
    root = torch.where(has, pred.to(torch.int64), idx)
    dist = has.to(torch.int32)
    minv = torch.minimum(idx, root)
    for _ in range(n_rounds):
        dist = dist + dist[root]
        minv = torch.minimum(minv, minv[root])
        root = root[root]
    return root, dist, minv


def form_chains(pred) -> Chains:
    """Chain head + offset for every node of a functional pred-graph."""
    n = pred.shape[0]
    rounds = max(1, math.ceil(math.log2(max(n, 2)))) + 1
    root, dist, minv = _double(pred, rounds)
    in_cycle = dist >= n
    idx = torch.arange(n, dtype=torch.int64, device=pred.device)
    cut = in_cycle & (idx == minv)
    pred2 = torch.where(cut, NONE, pred)
    root2, dist2, _ = _double(pred2, rounds)
    return Chains(head=root2, dist=dist2, was_cycle=in_cycle)


def chain_stats(chains: Chains, alive):
    """Per-node chain length (= #nodes in its chain) of the alive nodes,
    via segment max."""
    n = chains.head.shape[0]
    live = torch.nonzero(alive).squeeze(1)
    maxd = torch.full((n,), -1, dtype=torch.int32, device=chains.head.device)
    maxd.scatter_reduce_(0, chains.head[live], chains.dist[live], "amax")
    return torch.where(alive, maxd[chains.head] + 1, 0)
