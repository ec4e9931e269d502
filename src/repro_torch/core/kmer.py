"""Dual-lane (hi, lo) k-mer codec, k <= 31 (mirrors `repro.core.kmer`).

Codes are packed MSB-first: the first base of the k-mer sits in the highest
2 bits of the 2k-bit code, so the packed order is the lexicographic order of
the string.  Public functions take and return int32 lane bit patterns (see
`types`); the `*64` helpers work on lanes widened to int64 (values in
[0, 2**32)) and re-apply the uint32 wrap after every left shift and product,
so each op gives the bits the reference's uint32 op gives.
"""
from __future__ import annotations

import torch

from .types import INVALID_BASE, U32_MASK, narrow, widen

MAX_K = 31


def _masks(k: int):
    """Static (lo, hi) masks for a 2k-bit code."""
    assert 1 <= k <= MAX_K, f"k={k} out of range (1..{MAX_K})"
    bits = 2 * k
    if bits >= 32:
        return U32_MASK, (1 << (bits - 32)) - 1
    return (1 << bits) - 1, 0


def _shl(x, s: int):
    return (x << s) & U32_MASK


def _append64(hi, lo, base, k: int):
    """code' = ((code << 2) | base) masked to 2k bits.

    The base is ORed in unmasked, as in the reference: an N (code 4) sets
    bit 2 of the low lane.  Windows holding an N are invalid, but their
    lanes still reach outputs (seed_probe's orient of unplaced reads).
    """
    mask_lo, mask_hi = _masks(k)
    new_hi = (_shl(hi, 2) | (lo >> 30)) & mask_hi
    new_lo = (_shl(lo, 2) | base.to(torch.int64)) & mask_lo
    return new_hi, new_lo


def _prepend64(hi, lo, base, k: int):
    """code' = (code >> 2) | (base << 2*(k-1)) (drop newest base)."""
    b = base.to(torch.int64)
    new_lo = (lo >> 2) | _shl(hi, 30)
    new_hi = hi >> 2
    shift = 2 * (k - 1)
    if shift >= 32:
        return new_hi | _shl(b, shift - 32), new_lo
    mask_lo, mask_hi = _masks(k)
    return new_hi & mask_hi, (new_lo | _shl(b, shift)) & mask_lo


def _rev32_2bit(x):
    """Reverse the 16 two-bit groups inside each 32-bit lane."""
    x = _shl(x & 0x33333333, 2) | ((x >> 2) & 0x33333333)
    x = _shl(x & 0x0F0F0F0F, 4) | ((x >> 4) & 0x0F0F0F0F)
    x = _shl(x & 0x00FF00FF, 8) | ((x >> 8) & 0x00FF00FF)
    return _shl(x, 16) | (x >> 16)


def _rc64(hi, lo, k: int):
    """RC of a packed k-mer: complement each base, reverse base order."""
    mask_lo, mask_hi = _masks(k)
    clo = (lo ^ U32_MASK) & mask_lo
    if k <= 16:
        r = _rev32_2bit(clo)
        rlo = r >> (32 - 2 * k) if k < 16 else r
        return torch.zeros_like(hi), rlo
    chi = (hi ^ U32_MASK) & mask_hi
    rhi64 = _rev32_2bit(clo)
    rlo64 = _rev32_2bit(chi)
    s = 64 - 2 * k
    if s == 0:
        return rhi64, rlo64
    if s >= 32:
        return torch.zeros_like(hi), rhi64 >> (s - 32)
    return rhi64 >> s, (rlo64 >> s) | _shl(rhi64, 32 - s)


def _less(hi_a, lo_a, hi_b, lo_b):
    return (hi_a < hi_b) | ((hi_a == hi_b) & (lo_a < lo_b))


def _canonical64(hi, lo, k: int):
    rhi, rlo = _rc64(hi, lo, k)
    flip = _less(rhi, rlo, hi, lo)
    return torch.where(flip, rhi, hi), torch.where(flip, rlo, lo), flip


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x, c < 2**32 without int64 overflow."""
    lo16 = x & 0xFFFF
    hi16 = x >> 16
    return (lo16 * c + _shl((hi16 * c) & 0xFFFF, 16)) & U32_MASK


def _mix32(x):
    """murmur3 fmix32 on widened lanes."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _hash64(hi, lo):
    return _mix32(hi ^ _mix32(lo ^ 0x9E3779B9))


def append_base(hi, lo, base, *, k: int):
    return tuple(map(narrow, _append64(widen(hi), widen(lo), base, k)))


def prepend_base(hi, lo, base, *, k: int):
    return tuple(map(narrow, _prepend64(widen(hi), widen(lo), base, k)))


def last_base(hi, lo, *, k: int):
    del hi, k
    return (lo & 3).to(torch.uint8)


def reverse_complement(hi, lo, *, k: int):
    return tuple(map(narrow, _rc64(widen(hi), widen(lo), k)))


def canonical(hi, lo, *, k: int):
    """Return (hi, lo, flipped): lexicographic min of the k-mer and its RC."""
    chi, clo, flip = _canonical64(widen(hi), widen(lo), k)
    return narrow(chi), narrow(clo), flip


def kmer_hash(hi, lo):
    """32-bit avalanche hash of the dual-lane code (int32 lanes)."""
    return narrow(_hash64(widen(hi), widen(lo)))


def _pack64(bases, k: int):
    """Pack a [..., k] base window into widened (hi, lo) lanes."""
    hi = torch.zeros(bases.shape[:-1], dtype=torch.int64, device=bases.device)
    lo = torch.zeros_like(hi)
    for i in range(k):
        hi, lo = _append64(hi, lo, bases[..., i], k)
    return hi, lo


def pack_window(bases, *, k: int):
    """Pack a [..., k] uint8 base window into a dual-lane code."""
    return tuple(map(narrow, _pack64(bases, k)))


def _embed_tag64(hi, lo, tag, k: int, tag_bits: int):
    """Tag bits above the 2k code bits, on widened lanes."""
    t = widen(tag.to(torch.int32)) & ((1 << tag_bits) - 1)
    shift = 2 * k
    if shift >= 32:
        return hi | _shl(t, shift - 32), lo
    return hi | (t >> (32 - shift)), lo | _shl(t, shift)


def embed_tag(hi, lo, tag, *, k: int, tag_bits: int):
    """Pack an integer tag above the 2k code bits (for (contig, mer) keys).

    Requires 2k + tag_bits <= 62 so the tagged key still fits the dual-lane
    convention (hi's top two bits stay clear for the EMPTY sentinel).
    """
    assert 2 * k + tag_bits <= 62, f"tag does not fit: 2*{k}+{tag_bits} > 62"
    return tuple(map(narrow, _embed_tag64(widen(hi), widen(lo), tag, k,
                                          tag_bits)))


def decode(hi, lo, *, k: int):
    """Unpack a dual-lane code into [..., k] uint8 bases."""
    whi, wlo = widen(hi), widen(lo)
    outs = []
    for i in range(k):
        shift = 2 * (k - 1 - i)
        b = (whi >> (shift - 32)) & 3 if shift >= 32 else (wlo >> shift) & 3
        outs.append(b.to(torch.uint8))
    return torch.stack(outs, dim=-1)


def _extract64(bases, lengths, k: int):
    """All k-mer windows of a dense [R, L] batch, lanes widened to int64."""
    R, L = bases.shape
    W = L - k + 1
    assert W >= 1, f"reads shorter than k: L={L} k={k}"
    hi = torch.zeros((R, W), dtype=torch.int64, device=bases.device)
    lo = torch.zeros((R, W), dtype=torch.int64, device=bases.device)
    for i in range(k):
        hi, lo = _append64(hi, lo, bases[:, i : i + W], k)
    inv = (bases >= INVALID_BASE).to(torch.int32)
    csum = torch.cat(
        [torch.zeros((R, 1), dtype=torch.int64, device=bases.device),
         torch.cumsum(inv, dim=1)], dim=1)
    no_invalid = (csum[:, k:] - csum[:, :-k]) == 0
    pos = torch.arange(W, dtype=torch.int32, device=bases.device)[None, :]
    lens = lengths[:, None]
    valid = no_invalid & (pos + k <= lens)
    absent = torch.full((R, 1), INVALID_BASE, dtype=torch.uint8,
                        device=bases.device)
    left = torch.cat([absent, bases[:, : W - 1]], dim=1)
    right = torch.cat([bases[:, k:], absent], dim=1)
    right = torch.where(pos + k < lens, right, INVALID_BASE)
    left = torch.where(pos > 0, left, INVALID_BASE)
    return hi, lo, valid, left, right


def extract_kmers(bases, lengths, *, k: int):
    """All k-mer windows: (hi, lo, valid, left, right), each [R, L-k+1]."""
    hi, lo, valid, left, right = _extract64(bases, lengths, k)
    return narrow(hi), narrow(lo), valid, left, right


def complement_base(b):
    """3 - b for real bases; INVALID stays invalid."""
    return torch.where(b < 4, (3 - b).to(b.dtype), b)


def canonicalize_occurrences(hi, lo, left, right, *, k: int):
    """Canonical form of k-mer occurrences, swapping/complementing extensions."""
    chi, clo, flip = canonical(hi, lo, k=k)
    cleft = torch.where(flip, complement_base(right), left)
    cright = torch.where(flip, complement_base(left), right)
    return chi, clo, cleft, cright, flip
