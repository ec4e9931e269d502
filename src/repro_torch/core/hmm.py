"""Profile-HMM Viterbi scorer (paper §III-C rRNA rule; mirrors
`repro.core.hmm`).

MetaHipMer runs HMMER to flag contigs that match conserved ribosomal
profiles; the ends of flagged contigs stay extendable under competing
links.  This is the mechanism: a match/insert/delete profile HMM scored
by Viterbi in log space, local in the sequence (free start and end) and
against a uniform null model.  `build_profile` makes a profile from
equal-length reference sequences, and `hmm_hits` gives the per-contig
flag the scaffolder takes.

The reference maps a scan over the sequence over the contigs; here one
loop over the positions updates the [C, M] states of all contigs at
once, in float32 throughout, with the reference's order of additions
and maxima, so scores are the reference's bit for bit.  A contig's
states freeze past its length (its `pos_ok`), so the loop runs to the
longest contig and, at each position, only over the contigs still that
long (rows sorted by length): the frozen rows' states and best scores
are what the reference's full-width loop leaves them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = -1e9


class ProfileHMM(NamedTuple):
    match_logp: torch.Tensor  # [M, 4] float32 log emission probs
    log_t: dict               # transition log-probs (Python floats)

    @property
    def length(self) -> int:
        return self.match_logp.shape[0]


def build_profile(seqs: list, pseudocount: float = 1.0,
                  device=None) -> ProfileHMM:
    """Ungapped-alignment profile from equal-length reference sequences."""
    arr = np.stack([np.asarray(s) for s in seqs])
    M = arr.shape[1]
    counts = np.full((M, 4), pseudocount, np.float64)
    for j in range(M):
        col = arr[:, j]
        for b in range(4):
            counts[j, b] += (col == b).sum()
    probs = counts / counts.sum(axis=1, keepdims=True)
    log_t = {
        "mm": float(np.log(0.95)),   # match -> match
        "mi": float(np.log(0.025)),  # match -> insert
        "md": float(np.log(0.025)),  # match -> delete
        "im": float(np.log(0.5)),
        "ii": float(np.log(0.5)),
        "dm": float(np.log(0.5)),
        "dd": float(np.log(0.5)),
    }
    return ProfileHMM(
        match_logp=torch.from_numpy(np.log(probs).astype(np.float32)).to(
            device),
        log_t=log_t)


def _viterbi(hmm: ProfileHMM, bases, lengths):
    """Best local log-odds of the profile within each row: [C] float32."""
    C = bases.shape[0]
    M = hmm.length
    dev = bases.device
    f32 = torch.float32
    # the reference adds weakly typed Python floats to float32 states:
    # each constant rounds to float32 first
    t = {key: float(np.float32(v)) for key, v in hmm.log_t.items()}
    null = torch.log(torch.tensor(0.25, dtype=f32, device=dev))
    em = hmm.match_logp.to(dev) - null  # log-odds emissions [M, 4]
    # emission row a base: 0..3 the profile's, 4 (N / pad) NEG
    em5 = torch.cat([em.t(), torch.full((1, M), NEG, dtype=f32,
                                        device=dev)])
    lengths = lengths.to(torch.int64)
    order = torch.argsort(lengths, descending=True, stable=True)
    lens_sorted = lengths[order].cpu()
    L = int(lens_sorted[0]) if C else 0
    # active[l]: rows (in length order) still inside their sequence at l,
    # the first rows with length > l
    active = torch.searchsorted(-lens_sorted, -torch.arange(L)).tolist()
    sb = bases[order, :L].clamp(max=4)
    # states with a leading column holding the "previous state" of
    # profile position 0: 0 for match and insert, NEG for delete
    vm = torch.full((C, M + 1), NEG, dtype=f32, device=dev)
    vi = torch.full((C, M + 1), NEG, dtype=f32, device=dev)
    vd = torch.full((C, M + 1), NEG, dtype=f32, device=dev)
    vm[:, 0] = 0
    vi[:, 0] = 0
    best = torch.full((C,), NEG, dtype=f32, device=dev)
    for pos in range(L):
        n = active[pos]
        m, i, d = vm[:n], vi[:n], vd[:n]
        e = em5[sb[:n, pos].to(torch.int64)]
        prev_m, prev_i, prev_d = m[:, :-1], i[:, :-1], d[:, :-1]
        nm = e + torch.maximum(torch.maximum(prev_m + t["mm"],
                                             prev_i + t["im"]),
                               prev_d + t["dm"])
        # local start: profile state 0 may begin anywhere with score e
        nm[:, 0] = torch.maximum(nm[:, 0], e[:, 0])
        ni = torch.maximum(m[:, 1:] + t["mi"], i[:, 1:] + t["ii"])
        nd = torch.maximum(prev_m + t["md"], prev_d + t["dd"])
        m[:, 1:] = nm
        i[:, 1:] = ni
        d[:, 1:] = nd
        best[:n] = torch.maximum(best[:n], nm.max(dim=1).values)
    out = torch.empty_like(best)
    out[order] = best
    return out


def viterbi_score(hmm: ProfileHMM, seq_bases, seq_len):
    """Best local-alignment log-odds of the profile within one sequence
    (seq_bases [L] uint8; free start and end, uniform 0.25 null)."""
    lengths = torch.as_tensor(seq_len, device=seq_bases.device).reshape(1)
    return _viterbi(hmm, seq_bases[None], lengths)[0]


def hmm_hits(hmm: ProfileHMM, contig_bases, contig_lengths, *,
             min_score_per_state: float = 0.25):
    """Per-contig HMM-hit flag: Viterbi log-odds above the threshold.

    A single-sequence profile with pseudocount 1 caps the per-state
    log-odds at log(0.4/0.25) ~ 0.47, so 0.25 a state flags sequences that
    match most of the profile while random DNA scores near zero.
    Returns (flags [C] bool, scores [C] float32).
    """
    scores = _viterbi(hmm, contig_bases, contig_lengths)
    threshold = min_score_per_state * hmm.length
    return (scores >= threshold) & (contig_lengths > 0), scores
