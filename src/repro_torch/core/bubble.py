"""Bubble merging + hair removal (paper §II-D; mirrors `repro.core.bubble`).

SNP bubbles: contigs whose endpoint k-mers hang off the same pair of fork
vertices, with the same length.  One sort groups contigs by their
(fork_a, fork_b, length) signature and keeps the deepest member of each
group.  Hair: dangling contigs shorter than 2k attached at exactly one end.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NONE = -1
_BIG = 0x7FFFFFFF


class BubbleResult(NamedTuple):
    alive: torch.Tensor        # [C] bool survivors
    merged_away: torch.Tensor  # [C] bool removed as non-representative arm
    hair: torch.Tensor         # [C] bool removed as hair


def _side_signature(rows):
    """Collapse a contig end's <=4 fork rows into (min_row, fork_count)."""
    present = rows >= 0
    min_row = torch.where(present, rows, _BIG).min(dim=-1).values
    count = present.sum(dim=-1)
    return torch.where(count > 0, min_row, NONE), count


def _lexsort(keys):
    """Stable sort permutation by keys[0], then keys[1], ... (as lax.sort
    with num_keys=len(keys), whose sort is stable)."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def merge_bubbles(contigs_lengths, contigs_depths, ends_nbr, *,
                  k: int) -> BubbleResult:
    """Mark bubble arms (contigs of <= 2k + 1 bases) and hair dead.

    ends_nbr: [C, 2, 4] int32 fork k-mer rows per end
    (`dbg.end_neighbor_forks`).
    """
    C = contigs_lengths.shape[0]
    alive = contigs_lengths > 0
    sigL, cntL = _side_signature(ends_nbr[:, 0])
    sigR, cntR = _side_signature(ends_nbr[:, 1])
    a = torch.minimum(sigL, sigR)
    b = torch.maximum(sigL, sigR)
    eligible = (alive & (sigL >= 0) & (sigR >= 0)
                & (contigs_lengths <= 2 * k + 1))
    ka = torch.where(eligible, a, _BIG)
    kb = torch.where(eligible, b, _BIG)
    kl = torch.where(eligible, contigs_lengths, _BIG)
    # group key, then depth descending: each group's first row is its best
    # (0 - depth, not -depth: no -0.0 for a radix sort to order apart)
    perm = _lexsort([ka, kb, kl, 0.0 - contigs_depths])
    ska, skb, skl = ka[perm], kb[perm], kl[perm]
    same_as_prev = torch.zeros((C,), dtype=torch.bool,
                               device=contigs_lengths.device)
    same_as_prev[1:] = ((ska[1:] == ska[:-1]) & (skb[1:] == skb[:-1])
                        & (skl[1:] == skl[:-1]) & (ska[1:] != _BIG))
    merged = torch.zeros_like(same_as_prev)
    merged[perm] = same_as_prev
    merged = merged & eligible
    one_sided = ((cntL > 0) & (cntR == 0)) | ((cntL == 0) & (cntR > 0))
    hair = alive & one_sided & (contigs_lengths < 2 * k)
    return BubbleResult(alive=alive & ~merged & ~hair, merged_away=merged,
                        hair=hair)
