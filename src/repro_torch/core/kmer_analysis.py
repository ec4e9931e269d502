"""K-mer analysis (paper §II-B; mirrors `repro.core.kmer_analysis`).

Counting is sort + run-length segmentation: sort the canonical codes,
find the equal-key runs, and segment-sum the occurrence counts and the
extension histograms.  `compute_extensions` applies MetaHipMer's adaptive
extension threshold t_hq = max(t_base, err_rate * depth) (§II-C).  The
Bloom two-sighting admission (`bloom_observe`, `bloom_admit`,
`admit_two_sightings`) keeps error singletons out of the count table; it
serves `analyze(low_memory=True)` and the streamed analysis
(`repro_torch.stream`).

The sort key is `types.sort_key`, whose signed order is the unsigned
(hi, lo) order, so invalid rows (keyed 0xFFFFFFFF, 0xFFFFFFFF) sort last as
in the reference's `lax.sort`; sorts are stable, as XLA's is.  Rows the
reference's scatters drop (`mode="drop"` at index `capacity`) are left
out before scattering here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

from . import bloom
from .types import EMPTY_HI, EXT_F, EXT_X, KmerSet, ReadSet, lane_const, \
    sort_key

_EMPTY = lane_const(EMPTY_HI)


class ExtensionPolicy(NamedTuple):
    """MetaHipMer §II-C extension rule.

    A side's extension is the most common base iff
      (a) its count >= min_ext
      (b) contradicting occurrences <= max(t_base, err_rate * depth)
    """

    min_ext: int = 2
    t_base: float = 2.0
    err_rate: float = 0.05


def occurrences(reads: ReadSet, *, k: int, backend=None):
    """Flat canonical k-mer occurrences of a read batch.

    Returns (hi, lo, left, right, valid), each [R * (L-k+1)].
    """
    lanes = ops.kmer_extract(reads.bases, reads.lengths, k=k, backend=backend)
    W = reads.bases.shape[1] - k + 1
    flat = lambda x: x[:, :W].reshape(-1)
    return (flat(lanes.hi), flat(lanes.lo), flat(lanes.left),
            flat(lanes.right), flat(lanes.valid))


def pseudo_count_table(bases, lengths, *, k: int, capacity: int,
                       weight: int, backend=None) -> dict:
    """Pseudo-counted k-mer table from dense sequence rows (§II-H)."""
    seqs = ReadSet(bases=bases, lengths=lengths,
                   mate=torch.full(lengths.shape, -1, dtype=torch.int32,
                                   device=lengths.device),
                   insert_size=0)
    hi, lo, left, right, valid = occurrences(seqs, k=k, backend=backend)
    tab = count_occurrences(hi, lo, left, right, valid, capacity=capacity)
    return {
        **tab,
        "count": tab["count"] * weight,
        "left_cnt": tab["left_cnt"] * weight,
        "right_cnt": tab["right_cnt"] * weight,
    }


def _group_segments(shi, slo, sv):
    """Boundary flags + segment ids of equal-key runs in sorted order."""
    prev_ne = torch.ones_like(sv)
    prev_ne[1:] = (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])
    new_grp = sv & prev_ne
    seg = torch.cumsum(new_grp, dim=0, dtype=torch.int64) - 1
    n_unique = torch.where(sv.any(), seg[-1] + 1, 0).to(torch.int32)
    return new_grp, seg, n_unique


def _sorted_by_key(hi, lo, valid):
    """Stable sort of rows by (hi, lo), invalid rows keyed to sort last."""
    shi = torch.where(valid, hi, _EMPTY)
    slo = torch.where(valid, lo, _EMPTY)
    _, perm = torch.sort(sort_key(shi, slo), stable=True)
    return shi[perm], slo[perm], valid[perm], perm


def _live_rows(sv, seg, capacity: int) -> int:
    """Sorted rows [0, m) are valid and fall inside the table: valid rows
    sort first and segment ids only grow.  The reference's scatters drop
    every other row; here they are never scattered, so no row piles onto
    one spare slot (atomic contention on the card)."""
    return int((sv & (seg < capacity)).sum())


def _table(shi, slo, new_grp, seg, m, counts, lcnt, rcnt, n_unique,
           capacity):
    """Assemble a count table dict; key rows come from the run heads."""
    out_hi = torch.full((capacity,), _EMPTY, dtype=torch.int32,
                        device=shi.device)
    out_lo = torch.zeros((capacity,), dtype=torch.int32, device=shi.device)
    heads = torch.nonzero(new_grp[:m]).squeeze(1)
    out_hi[seg[heads]] = shi[heads]
    out_lo[seg[heads]] = slo[heads]
    return {
        "hi": out_hi,
        "lo": out_lo,
        "count": counts,
        "left_cnt": lcnt,
        "right_cnt": rcnt,
        "n_unique": n_unique,
        "overflow": n_unique > capacity,
    }


def count_occurrences(hi, lo, left, right, valid, *, capacity: int) -> dict:
    """Sort-based exact counting of canonical k-mer occurrences.

    Returns a dict of dense arrays of length `capacity`; live entries are
    packed at the front in sorted key order.  `n_unique` may exceed
    `capacity` — callers check `overflow`.
    """
    shi, slo, sv, perm = _sorted_by_key(hi, lo, valid)
    new_grp, seg, n_unique = _group_segments(shi, slo, sv)
    m = _live_rows(sv, seg, capacity)
    seg_m = seg[:m]
    dev = hi.device
    counts = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    counts.index_add_(0, seg_m, torch.ones_like(seg_m, dtype=torch.int32))
    hists = []
    for ext in (left[perm[:m]], right[perm[:m]]):
        has = torch.nonzero(ext < 4).squeeze(1)
        h = torch.zeros((capacity, 4), dtype=torch.int32, device=dev)
        h.index_put_((seg_m[has], ext[has].to(torch.int64)),
                     torch.ones_like(has, dtype=torch.int32), accumulate=True)
        hists.append(h)
    return _table(shi, slo, new_grp, seg, m, counts, hists[0], hists[1],
                  n_unique, capacity)


def aggregate_weighted(hi, lo, cnt, lcnt, rcnt, valid, *,
                       capacity: int) -> dict:
    """Sum weighted partial counts per key (sort + segment reduce)."""
    shi, slo, sv, perm = _sorted_by_key(hi, lo, valid)
    new_grp, seg, n_unique = _group_segments(shi, slo, sv)
    m = _live_rows(sv, seg, capacity)
    seg_m, rows = seg[:m], perm[:m]
    dev = hi.device
    counts = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    counts.index_add_(0, seg_m, cnt[rows])
    lout = torch.zeros((capacity, 4), dtype=torch.int32, device=dev)
    lout.index_add_(0, seg_m, lcnt[rows])
    rout = torch.zeros((capacity, 4), dtype=torch.int32, device=dev)
    rout.index_add_(0, seg_m, rcnt[rows])
    return _table(shi, slo, new_grp, seg, m, counts, lout, rout, n_unique,
                  capacity)


def merge_counts(a: dict, b: dict, *, capacity: int) -> dict:
    """Union two count tables (same k), summing histograms (§II-H)."""
    cat = lambda key: torch.cat([a[key], b[key]])
    return aggregate_weighted(
        cat("hi"), cat("lo"), cat("count"), cat("left_cnt"),
        cat("right_cnt"), torch.cat([a["count"] > 0, b["count"] > 0]),
        capacity=capacity,
    )


def compute_extensions(count, left_cnt, right_cnt, policy: ExtensionPolicy):
    """EXT_* code per side under the MetaHipMer adaptive threshold.

    float32 throughout, as the reference: depth, the threshold and the
    contradiction count are float32 values of integers.
    """
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=count.device)
    depth = count.to(torch.float32)
    t_hq = torch.maximum(f32(policy.t_base), f32(policy.err_rate) * depth)

    def side(cnt):
        total = cnt.sum(dim=-1)
        c1 = cnt.max(dim=-1).values
        b1 = cnt.argmax(dim=-1).to(torch.uint8)
        contradict = (total - c1).to(torch.float32)
        ok = (c1 >= policy.min_ext) & (contradict <= t_hq)
        code = torch.where(ok, b1, EXT_F)
        return torch.where(total == 0, EXT_X, code).to(torch.uint8)

    return side(left_cnt), side(right_cnt)


def dup_in_chunk(hi, lo, valid):
    """Flag the 2nd+ occurrence of each valid key within the chunk (exact;
    stable sort, so the first occurrence in row order is the one left
    unflagged)."""
    shi, slo, sv, perm = _sorted_by_key(hi, lo, valid)
    dup_sorted = torch.zeros_like(sv)
    dup_sorted[1:] = ((shi[1:] == shi[:-1]) & (slo[1:] == slo[:-1])
                      & (shi[1:] != _EMPTY))
    out = torch.zeros_like(valid)
    out[perm] = dup_sorted
    return out


def bloom_observe(f1: bloom.BloomFilter, f2: bloom.BloomFilter, hi, lo,
                  valid):
    """One pass-1 step of the two-sighting rule over one occurrence batch.

    Keys already in f1 (sighted in an earlier batch) or duplicated within
    this batch are marked "seen twice" in f2; every valid key then enters
    f1.  Returns (f1, f2).
    """
    seen = bloom.query(f1, hi, lo) | dup_in_chunk(hi, lo, valid)
    f2 = bloom.insert(f2, hi, lo, valid & seen)
    f1 = bloom.insert(f1, hi, lo, valid)
    return f1, f2


def bloom_admit(f2: bloom.BloomFilter, hi, lo, valid):
    """Pass-2 admission: occurrences whose key was sighted >= twice (no
    false negatives; the exact min_count floor removes the false
    positives)."""
    return valid & bloom.query(f2, hi, lo)


def empty_count_table(capacity: int, device=None) -> dict:
    """An empty count table, the identity element of `merge_counts`."""
    return {
        "hi": torch.full((capacity,), _EMPTY, dtype=torch.int32,
                         device=device),
        "lo": torch.zeros((capacity,), dtype=torch.int32, device=device),
        "count": torch.zeros((capacity,), dtype=torch.int32, device=device),
        "left_cnt": torch.zeros((capacity, 4), dtype=torch.int32,
                                device=device),
        "right_cnt": torch.zeros((capacity, 4), dtype=torch.int32,
                                 device=device),
        "n_unique": torch.zeros((), dtype=torch.int32, device=device),
        "overflow": torch.zeros((), dtype=torch.bool, device=device),
    }


def admit_two_sightings(hi, lo, valid, *, bloom_bits: int,
                        num_chunks: int = 4):
    """The paper's Bloom-filter two-pass admission (§II-B) over one
    occurrence set: pass 1 streams `num_chunks` chunks through
    `bloom_observe`, pass 2 admits with `bloom_admit`."""
    n = hi.shape[0]
    chunk = -(-n // num_chunks)
    f1 = bloom.empty(bloom_bits, device=hi.device)
    f2 = bloom.empty(bloom_bits, device=hi.device)
    for c in range(num_chunks):
        sl = slice(c * chunk, min((c + 1) * chunk, n))
        if sl.start >= n:
            break
        f1, f2 = bloom_observe(f1, f2, hi[sl], lo[sl], valid[sl])
    return bloom_admit(f2, hi, lo, valid)


def analyze(reads: ReadSet, *, k: int, capacity: int, min_count: int = 2,
            policy: ExtensionPolicy = ExtensionPolicy(),
            low_memory: bool = False, bloom_bits: int = 1 << 16,
            backend=None) -> KmerSet:
    """Single-device k-mer analysis: occurrences -> counted KmerSet;
    `low_memory=True` admits only k-mers sighted at least twice."""
    hi, lo, left, right, valid = occurrences(reads, k=k, backend=backend)
    if low_memory:
        valid = admit_two_sightings(hi, lo, valid, bloom_bits=bloom_bits)
    tab = count_occurrences(hi, lo, left, right, valid, capacity=capacity)
    return finalize(tab, min_count=min_count, policy=policy)


def finalize(tab: dict, *, min_count: int, policy: ExtensionPolicy) -> KmerSet:
    """Apply the count floor and extension policy to a raw count table."""
    used = tab["count"] >= min_count
    lext, rext = compute_extensions(tab["count"], tab["left_cnt"],
                                    tab["right_cnt"], policy)
    return KmerSet(
        hi=tab["hi"],
        lo=tab["lo"],
        count=torch.where(used, tab["count"], 0),
        left_cnt=tab["left_cnt"],
        right_cnt=tab["right_cnt"],
        left_ext=torch.where(used, lext, EXT_X).to(torch.uint8),
        right_ext=torch.where(used, rext, EXT_X).to(torch.uint8),
        used=used,
    )
