"""Plain PyTorch versions of the kernels (mirrors `repro.kernels.ref`).

Each `*_ref` has its kernel's interface and the reference's semantics op
for op: `kmer_extract_ref`, `dht_lookup_ref`, `dht_insert_ref` and
`seed_probe_ref` follow `repro/kernels/ref.py` and the jnp table rounds of
`repro/core/dht.py` (`insert_jnp`, `lookup_jnp`).  `kernels.ops` serves them
for CPU tensors, and `chip_smoke.py` holds each CUDA kernel against them on
the card.  Lanes are int32 bit patterns, widened to int64 for arithmetic
(`core.types`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kmer
from repro_torch.core.types import INVALID_BASE, narrow, widen

# Rows of the plain extraction per chunk: bounds its int64 temporaries to
# ~2**24 windows, whatever the batch.  Results do not depend on it.
_CHUNK_WINDOWS = 1 << 24


class KmerLanes(NamedTuple):
    """Per-window output lanes, each [R, L] (last k-1 columns are padding).

    Lanes at ~valid positions are what the packing gives; consumers mask.
    """

    hi: torch.Tensor     # [R, L] int32 lane: canonical code, high word
    lo: torch.Tensor     # [R, L] int32 lane: canonical code, low word
    hash: torch.Tensor   # [R, L] int32 lane: owner hash of the code
    left: torch.Tensor   # [R, L] uint8 canonicalized left extension (4 absent)
    right: torch.Tensor  # [R, L] uint8 canonicalized right extension
    flip: torch.Tensor   # [R, L] bool canonical form is the reverse complement
    valid: torch.Tensor  # [R, L] bool window inside read, no N bases


def kmer_extract_ref(bases, lengths, *, k: int) -> KmerLanes:
    """Plain version of the kmer_extract kernel (padded to [R, L]).

    The codec's rolling extraction, canonicalized with its extensions and
    hashed: `repro/kernels/ref.py:kmer_extract_ref`.
    """
    R, L = bases.shape
    W = L - k + 1
    assert W >= 1, f"reads narrower than k: L={L} k={k}"
    # padding columns: codes 0, extension bases 4, flags False
    z32 = lambda: torch.zeros((R, L), dtype=torch.int32, device=bases.device)
    b4 = lambda: torch.full((R, L), INVALID_BASE, dtype=torch.uint8,
                            device=bases.device)
    f = lambda: torch.zeros((R, L), dtype=torch.bool, device=bases.device)
    out = KmerLanes(z32(), z32(), z32(), b4(), b4(), f(), f())
    step = max(1, _CHUNK_WINDOWS // L)
    for r0 in range(0, R, step):
        rows = slice(r0, min(R, r0 + step))
        hi, lo, valid, left, right = kmer._extract64(
            bases[rows], lengths[rows], k)
        chi, clo, flip = kmer._canonical64(hi, lo, k)
        cleft = torch.where(flip, kmer.complement_base(right), left)
        cright = torch.where(flip, kmer.complement_base(left), right)
        out.hi[rows, :W] = narrow(chi)
        out.lo[rows, :W] = narrow(clo)
        out.hash[rows, :W] = narrow(kmer._hash64(chi, clo))
        out.left[rows, :W] = cleft
        out.right[rows, :W] = cright
        out.flip[rows, :W] = flip
        out.valid[rows, :W] = valid
    return out


def dht_lookup_ref(slot_hi, slot_lo, used, max_probe, hi, lo, valid):
    """Plain version of dht_lookup: `repro/core/dht.py:lookup_jnp`.

    Linear probe from hash & (cap-1); a query stops at its key, at an
    unused slot, or after max_probe + 2 steps.  Returns int32 slots shaped
    like `hi`, -1 where absent or invalid.  Only still-open queries are
    carried from step to step; results are those of the full-width loop.
    """
    cap = slot_hi.shape[0]
    shape = hi.shape
    fhi, flo = hi.reshape(-1), lo.reshape(-1)
    result = torch.full((fhi.shape[0],), -1, dtype=torch.int32,
                        device=hi.device)
    live = valid.reshape(-1).nonzero().squeeze(1)
    qhi, qlo = fhi[live], flo[live]
    attempt = kmer._hash64(widen(qhi), widen(qlo)) & (cap - 1)
    bound = int(max_probe) + 1
    i = 0
    while i <= bound and live.numel():
        u = used[attempt]
        match = u & (slot_hi[attempt] == qhi) & (slot_lo[attempt] == qlo)
        result[live[match]] = attempt[match].to(torch.int32)
        go = u & ~match
        live, qhi, qlo = live[go], qhi[go], qlo[go]
        attempt = (attempt[go] + 1) & (cap - 1)
        i += 1
    return result.reshape(shape)


def dht_insert_ref(slot_hi, slot_lo, used, max_probe, hi, lo, valid):
    """Plain version of dht_insert: `repro/core/dht.py:insert_jnp`.

    Bulk-synchronous claim rounds.  Per round every pending key looks at
    its slot: a slot holding the key itself finishes it (dedupe); keys on
    an empty slot race and the highest batch index wins and writes it; a
    key on a slot holding a different key advances one slot; a race loser
    stays and retries the same slot.  A key that probed `cap` slots is
    exhausted and overflows (slot -1) without stopping the others.
    Returns (slot_hi, slot_lo, used, max_probe, slots), inputs untouched.
    Only valid keys are carried through the rounds; each keeps its batch
    index for the race, so the winners are those of the full batch.
    """
    cap = slot_hi.shape[0]
    slot_hi, slot_lo, used = slot_hi.clone(), slot_lo.clone(), used.clone()
    dev = hi.device
    idx = valid.nonzero().squeeze(1)
    khi, klo = hi[idx], lo[idx]
    attempt = kmer._hash64(widen(khi), widen(klo)) & (cap - 1)
    probes = torch.zeros_like(attempt)
    done = torch.zeros_like(attempt, dtype=torch.bool)
    while True:
        pending = ~done & (probes < cap)
        if not bool(pending.any()):
            break
        cur_used = used[attempt]
        cur_match = (cur_used & (slot_hi[attempt] == khi)
                     & (slot_lo[attempt] == klo))
        done_dup = pending & cur_match
        can_try = pending & ~cur_used
        owner = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        bid = torch.nonzero(can_try).squeeze(1)
        owner.scatter_reduce_(0, attempt[bid], idx[bid], "amax")
        winner = can_try & (owner[attempt] == idx)
        w = attempt[winner]
        slot_hi[w] = khi[winner]
        slot_lo[w] = klo[winner]
        used[w] = True
        done = done | winner | done_dup
        advance = pending & cur_used & ~cur_match
        attempt = torch.where(advance, (attempt + 1) & (cap - 1), attempt)
        probes = probes + advance.to(probes.dtype)
    slots = torch.full(hi.shape, -1, dtype=torch.int32, device=dev)
    slots[idx[done]] = attempt[done].to(torch.int32)
    mp = torch.as_tensor(max_probe, dtype=torch.int32, device=dev)
    if probes.numel():
        mp = torch.maximum(mp, probes.max().to(torch.int32))
    return slot_hi, slot_lo, used, mp, slots


def seed_probe_ref(bases, lengths, slot_hi, slot_lo, used, max_probe,
                   contig, pos, flip, multi, *, seed_len: int,
                   positions: tuple):
    """Plain version of seed_probe: `repro/kernels/ref.py:seed_probe_ref`.

    Full-width extraction lanes taken at the seed columns, a probe of the
    seed index, placements from the flip parity, the O(S^2) agreement vote
    and the top-2 distinct-contig choice (first maximum on ties).  Returns
    (contig, cstart, orient), each [R, 2].
    """
    lanes = kmer_extract_ref(bases, lengths, k=seed_len)
    dev = bases.device
    pcols = torch.tensor(positions, dtype=torch.int64, device=dev)
    chi, clo = lanes.hi[:, pcols], lanes.lo[:, pcols]
    sval, rflip = lanes.valid[:, pcols], lanes.flip[:, pcols]
    del lanes
    slots = dht_lookup_ref(slot_hi, slot_lo, used, max_probe, chi, clo, sval)
    sl = slots.clamp(min=0).to(torch.int64)
    ok = (slots >= 0) & ~multi[sl]
    cpos = pos[sl]
    same = rflip == flip[sl]
    j = pcols.to(torch.int32)[None, :]
    L = lengths[:, None]
    cstart = torch.where(same, cpos - j, cpos - (L - j - seed_len))
    orient = torch.where(same, 0, 1).to(torch.uint8)
    cc = torch.where(ok, contig[sl], -1)
    cstart = torch.where(ok, cstart, 0).to(torch.int32)
    agree = ((cc[:, :, None] == cc[:, None, :])
             & (cstart[:, :, None] == cstart[:, None, :])
             & (orient[:, :, None] == orient[:, None, :])
             & (cc[:, :, None] >= 0))
    support = torch.where(cc >= 0, agree.sum(dim=-1), 0)
    best = torch.argmax(support, dim=-1)
    take = lambda a, i: torch.gather(a, 1, i[:, None])[:, 0]
    c1, s1, o1 = take(cc, best), take(cstart, best), take(orient, best)
    support2 = torch.where((cc != c1[:, None]) & (cc >= 0), support, 0)
    best2 = torch.argmax(support2, dim=-1)
    has2 = support2.max(dim=-1).values > 0
    c2 = torch.where(has2, take(cc, best2), -1)
    s2, o2 = take(cstart, best2), take(orient, best2)
    return (torch.stack([c1, c2], dim=1).to(torch.int32),
            torch.stack([s1, s2], dim=1),
            torch.stack([o1, o2], dim=1))
