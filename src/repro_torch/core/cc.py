"""Shiloach–Vishkin connected components (paper §III-C; mirrors
`repro.core.cc`).

Deterministic min-label hooking plus pointer-jumping shortcuts, as bulk
scatter/gather rounds: the hooking is a scatter-min, associative and so
independent of the order of the writes.
"""
from __future__ import annotations

import torch


def connected_components(u, v, valid, n: int):
    """Component label (min vertex id) for each of n vertices.

    Args:
      u, v: [E] int32 edge endpoints.
      valid: [E] bool live edges.
    Returns:
      [n] int32 labels; label[i] == min vertex id of i's component.
    Rounds run until no label changes.
    """
    parent = torch.arange(n, dtype=torch.int32, device=u.device)
    live = valid.nonzero().squeeze(1)
    eu, ev = u[live].to(torch.int64), v[live].to(torch.int64)
    while True:
        pu, pv = parent[eu], parent[ev]
        new_parent = parent.clone()
        new_parent.scatter_reduce_(0, torch.maximum(pu, pv).to(torch.int64),
                                   torch.minimum(pu, pv), "amin")
        # pointer jumping (shortcut twice per round)
        new_parent = new_parent[new_parent.to(torch.int64)]
        new_parent = new_parent[new_parent.to(torch.int64)]
        changed = bool((new_parent != parent).any())
        parent = new_parent
        if not changed:
            return parent
