"""Plain PyTorch versions of the kernels (mirrors `repro.kernels.ref`).

Each `*_ref` has its kernel's interface and the reference's semantics op
for op: `kmer_extract_ref`, `dht_lookup_ref`, `dht_insert_ref`,
`seed_probe_ref`, `mer_walk_ref`, `sw_extend_ref` and
`flash_attention_ref` follow `repro/kernels/ref.py` and the jnp table
rounds of `repro/core/dht.py` (`insert_jnp`, `lookup_jnp`);
`ssd_scan_ref` is the chunked SSD of `repro/models/ssm.py:ssd_chunked`
with the causal mask taken before `exp`.
`kernels.ops` serves them for CPU tensors, and `chip_smoke.py` holds each
CUDA kernel against them on the card.  Lanes are int32 bit patterns,
widened to int64 for arithmetic (`core.types`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kmer
from repro_torch.core.types import INVALID_BASE, narrow, widen

# walk status codes (HIT: a gap walk reached its target seed) and the width
# of the walk's rolling suffix buffer, as `repro/kernels/mer_walk.py`
ACTIVE, DEADEND, FORK, DONE, HIT = 0, 1, 2, 3, 4
BUF_K = 31

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


def _probe(slot_hi, slot_lo, used, max_probe, fhi, flo, live):
    """Probe chains of the flat queries at indices `live`: (slots, probes).

    Linear probe from hash & (cap-1); a query stops at its key, at an
    unused slot, or after max_probe + 2 steps.  `probes` counts the slots
    examined.  Only still-open queries are carried from step to step;
    results are those of the full-width loop.
    """
    cap = slot_hi.shape[0]
    result = torch.full((fhi.shape[0],), -1, dtype=torch.int32,
                        device=fhi.device)
    qhi, qlo = fhi[live], flo[live]
    attempt = kmer._hash64(widen(qhi), widen(qlo)) & (cap - 1)
    bound = int(max_probe) + 1
    i = probes = 0
    while i <= bound and live.numel():
        probes += live.numel()
        u = used[attempt]
        match = u & (slot_hi[attempt] == qhi) & (slot_lo[attempt] == qlo)
        result[live[match]] = attempt[match].to(torch.int32)
        go = u & ~match
        live, qhi, qlo = live[go], qhi[go], qlo[go]
        attempt = (attempt[go] + 1) & (cap - 1)
        i += 1
    return result, probes


def dht_lookup_ref(slot_hi, slot_lo, used, max_probe, hi, lo, valid):
    """Plain version of dht_lookup: `repro/core/dht.py:lookup_jnp`.

    Returns int32 slots shaped like `hi`, -1 where absent or invalid.
    """
    live = valid.reshape(-1).nonzero().squeeze(1)
    slots, _ = _probe(slot_hi, slot_lo, used, max_probe, hi.reshape(-1),
                      lo.reshape(-1), live)
    return slots.reshape(hi.shape)


def dht_lookup_work(slot_hi, slot_lo, used, max_probe, hi, lo, valid) -> dict:
    """What a lookup of these queries needs, for its bound: the rows, the
    valid rows, the table slots their probe chains examine (`_probe`), and
    the bytes: `valid` read and the slot written for every row (5 a row),
    the valid rows' key lanes (8 a row), 9 a slot examined (`used`,
    `slot_hi`, `slot_lo`) and max_probe (4).  'bytes_every_row' counts
    every row's key lanes and 9 bytes a valid row instead (13 n + 9 n_valid
    + 4), the count the kernel was first held to."""
    live = valid.reshape(-1).nonzero().squeeze(1)
    _, slots = _probe(slot_hi, slot_lo, used, max_probe, hi.reshape(-1),
                      lo.reshape(-1), live)
    n, n_valid = hi.numel(), live.numel()
    return dict(rows=n, valid=n_valid, slots=slots,
                bytes=5 * n + 8 * n_valid + 9 * slots + 4,
                bytes_every_row=13 * n + 9 * n_valid + 4)


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


class MerWalkOut(NamedTuple):
    """Walk outputs for E walkers.

    `hit`/`hit_pos` are all-False/-1 unless a target mer was supplied
    (seed_len > 0); `hit_pos` is the number of accepted bases after which
    the target seed first appeared as the buffer suffix.
    """

    ext_bases: torch.Tensor  # [E, max_ext] uint8 accepted bases (4 pad)
    ext_len: torch.Tensor    # [E] int32
    status: torch.Tensor     # [E] int32 final status code
    hit: torch.Tensor        # [E] bool target seed reached
    hit_pos: torch.Tensor    # [E] int32 accepted-base count at the hit (-1)


def _choose(hist, min_votes: int, dominance: int):
    """(base, kind) of the §II-G vote; kind 0 accept, 1 dead end, 2 fork.
    The base is the first maximal one."""
    c1 = hist.max(dim=-1).values
    b1 = hist.argmax(dim=-1)
    viable = (hist >= min_votes).sum(dim=-1)
    second = hist.sum(dim=-1) - c1
    uncontested = (viable == 1) & (c1 >= min_votes)
    dominated = ((viable > 1) & (c1 >= dominance * second.clamp(min=1))
                 & (c1 >= min_votes + 1))
    accept = uncontested | dominated
    kind = torch.where(accept, 0, torch.where(viable == 0, 1, 2))
    return b1, kind


def mer_walk_ref(start_hi, start_lo, contig, active, target_hi, target_lo,
                 keys_hi, keys_lo, used, max_probe, right_hist, left_hist, *,
                 mer_sizes: tuple, tag_bits: int, max_ext: int,
                 min_votes: int = 1, dominance: int = 4, seed_len: int = 0,
                 counts: dict | None = None) -> MerWalkOut:
    """Plain version of mer_walk: `repro/kernels/ref.py:mer_walk_ref`.

    Per step, every ACTIVE walker takes the canonical suffix mer of its
    current rung, tags it with its contig id, probes that rung's table,
    votes over the extension histogram (the left one, reversed, when the
    canonical mer is the reverse complement), then accepts a base, moves
    up a rung on a fork or down on a dead end, or stops.  With
    seed_len > 0 a walker whose buffer suffix becomes its target seed
    stops with status HIT.  At most max_ext steps.

    The table arguments are per-rung sequences ([cap] lanes, [cap, 4]
    histograms), not stacked.  Only the walker's current rung is probed
    (probes have no side effects, so the reference's probes of the other
    rungs change nothing) and only ACTIVE walkers are carried from step
    to step.  `counts`, if given, receives the walker steps taken, the
    table slots examined and the steps of the longest walk, which are the
    loop's iterations ('steps', 'probes', 'rounds').
    """
    E = start_hi.shape[0]
    dev = start_hi.device
    n_rungs = len(mer_sizes)
    buf_hi, buf_lo = widen(start_hi), widen(start_lo)
    t_hi, t_lo = widen(target_hi), widen(target_lo)
    rung = torch.full((E,), n_rungs // 2, dtype=torch.int64, device=dev)
    last_shift = torch.zeros((E,), dtype=torch.int64, device=dev)
    status = torch.where(active, ACTIVE, DONE).to(torch.int32)
    out = torch.full((E, max_ext), INVALID_BASE, dtype=torch.uint8,
                     device=dev)
    out_len = torch.zeros((E,), dtype=torch.int32, device=dev)
    hit = torch.zeros((E,), dtype=torch.bool, device=dev)
    hit_pos = torch.full((E,), -1, dtype=torch.int32, device=dev)
    live = active.nonzero().squeeze(1)
    steps = probes = rounds = 0
    for _ in range(max_ext):
        if not live.numel():
            break
        rounds += 1
        steps += live.numel()
        bh, bl, rg = buf_hi[live], buf_lo[live], rung[live]
        hist = torch.zeros((live.numel(), 4), dtype=torch.int32, device=dev)
        for r, m in enumerate(mer_sizes):
            sel = (rg == r).nonzero().squeeze(1)
            if not sel.numel():
                continue
            mask_lo, mask_hi = kmer._masks(m)
            chi, clo, flip = kmer._canonical64(bh[sel] & mask_hi,
                                               bl[sel] & mask_lo, m)
            thi, tlo = kmer._embed_tag64(chi, clo, contig[live[sel]], m,
                                         tag_bits)
            every = torch.arange(sel.numel(), device=dev)
            slots, n = _probe(keys_hi[r], keys_lo[r], used[r], max_probe[r],
                              narrow(thi), narrow(tlo), every)
            probes += n
            s = slots.clamp(min=0).to(torch.int64)
            h = torch.where(flip[:, None], left_hist[r][s].flip(-1),
                            right_hist[r][s])
            hist[sel] = torch.where((slots >= 0)[:, None], h, 0)
        base, kind = _choose(hist, min_votes, dominance)
        ls = last_shift[live]
        stop_fork = (kind == 2) & ((rg == n_rungs - 1) | (ls == -1))
        stop_dead = (kind == 1) & ((rg == 0) | (ls == 1))
        up = (kind == 2) & ~stop_fork
        down = (kind == 1) & ~stop_dead
        accept = kind == 0
        rung[live] = rg + up.to(torch.int64) - down.to(torch.int64)
        last_shift[live] = torch.where(up, 1, torch.where(
            down, -1, torch.where(accept, 0, ls)))
        nh, nl = kmer._append64(bh, bl, base, BUF_K)
        bh = torch.where(accept, nh, bh)
        bl = torch.where(accept, nl, bl)
        buf_hi[live], buf_lo[live] = bh, bl
        ol = out_len[live]
        out[live[accept], ol[accept].to(torch.int64)] = \
            base[accept].to(torch.uint8)
        ol = ol + accept.to(torch.int32)
        out_len[live] = ol
        st = torch.where(stop_fork, FORK,
                         torch.where(stop_dead, DEADEND, status[live]))
        if seed_len > 0:
            mask_lo, mask_hi = kmer._masks(seed_len)
            match = (accept & ((bh & mask_hi) == t_hi[live])
                     & ((bl & mask_lo) == t_lo[live]) & ~hit[live])
            hit_pos[live] = torch.where(match, ol, hit_pos[live])
            hit[live] = hit[live] | match
            st = torch.where(match, HIT, st)
        status[live] = st.to(torch.int32)
        live = live[st == ACTIVE]
    if counts is not None:
        counts["steps"] = counts.get("steps", 0) + steps
        counts["probes"] = counts.get("probes", 0) + probes
        counts["rounds"] = counts.get("rounds", 0) + rounds
    return MerWalkOut(out, out_len, status, hit, hit_pos)


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


SW_NEGINF = -(1 << 20)


def sw_extend_ref(query, target, qlen, tlen, *, band: int = 15,
                  match: int = 1, mismatch: int = -1, gap: int = -1):
    """Plain version of sw_extend: banded semi-global extension DP.

    Computes what `repro/kernels/ref.py:sw_extend_ref` (the reference's
    dense [QL+1, TL+1] DP) computes, in the band form of the TPU kernel
    (`repro/kernels/sw_extend.py`): one step per query row over [B, 2*band+1]
    cells stored target-relative (offset o = j - ii + band).  The in-row
    gap chain is an exact max-plus prefix scan (shifts 1, 2, 4, ... with
    penalties d * gap).  The band form equals the dense DP when
    mismatch >= 2 * gap (a cell left of the band reaches it only through a
    left gap, which the diagonal always beats), as at +1/-1/-1.

    query [B, QL] / target [B, TL] uint8, qlen / tlen [B] int32.  Returns
    (best_score, best_qpos, best_tpos), each [B] int32: the largest valid
    cell of rows >= 1, the first row that reaches it and the first column
    in that row; (0, 0, 0) without a positive cell.
    """
    B, QL = query.shape
    TL = target.shape[1]
    dev = query.device
    BW = 2 * band + 1
    # band-padded target: tpad[:, i + o] is t[j - 1] at row ii = i + 1
    width = max(TL, QL) + 2 * band
    tpad = torch.full((B, width), INVALID_BASE, dtype=torch.uint8,
                      device=dev)
    tpad[:, band:band + TL] = target
    off = torch.arange(BW, dtype=torch.int32, device=dev)[None, :]
    qlen, tlen = qlen[:, None], tlen[:, None]
    neg = torch.full((B, 1), SW_NEGINF, dtype=torch.int32, device=dev)
    j0 = off - band
    row = torch.where((j0 >= 0) & (j0 <= tlen.clamp(max=band)), j0 * gap,
                      SW_NEGINF).to(torch.int32)
    best = torch.zeros((B,), dtype=torch.int32, device=dev)
    bq = torch.zeros_like(best)
    bt = torch.zeros_like(best)
    for i in range(QL):
        ii = i + 1
        ts = tpad[:, i:i + BW]
        qi = query[:, i:i + 1]
        sub = torch.where((ts == qi) & (qi < 4), match,
                          mismatch).to(torch.int32)
        up = torch.cat([row[:, 1:], neg], dim=1) + gap
        cand = torch.maximum(row + sub, up)
        j = off - band + ii
        cand = torch.where(j == 0, ii * gap, cand)
        d = 1
        while d < BW:  # left chain: max over d' < 2d of cand[o - d'] + d' gap
            shifted = torch.cat([neg.expand(B, d), cand[:, :-d]], dim=1)
            cand = torch.maximum(cand, shifted + d * gap)
            d *= 2
        valid = (j >= 0) & (j <= tlen) & (ii <= qlen)
        row = torch.where(valid, cand, SW_NEGINF)
        rb = row.max(dim=1).values
        rj = torch.argmax(row, dim=1).to(torch.int32) - band + ii
        upd = rb > best
        best = torch.where(upd, rb, best)
        bq = torch.where(upd, ii, bq)
        bt = torch.where(upd, rj, bt)
    return best, bq, bt


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Plain softmax attention, the oracle of the flash kernel.

    q [B, H, S, D]; k, v [B, KH, S, D] with H % KH == 0 (query head h reads
    KV head h // (H // KH)).  Products in the inputs' dtype, logits and
    softmax in fp32, causal mask -1e30, output in q's dtype: the
    reference's `flash_attention_ref` op for op.
    """
    B, H, S, D = q.shape
    KH = k.shape[1]
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bhsd,bhtd->bhst", q, k).float() * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def ssd_chunk(S: int, chunk: int) -> int:
    """The chunk the scan takes: Q = min(chunk, S), and S % Q == 0 (the
    reference's rule, `repro/models/ssm.py:ssd_chunked`)."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_scan: S={S} is not a positive multiple of "
                         f"the chunk min(chunk={chunk}, S)={Q}")
    return Q


def ssd_scan_ref(x, a, b, c, *, chunk: int = 128):
    """Chunked Mamba-2 SSD scan (scalar decay per head), the plain version
    of the ssd_scan kernel and the port's `ssm.ssd_chunked`.

    x [B, S, H, P]; a [B, S, H] log-decays; b, c [B, S, H, N].  Per chunk
    of Q = min(chunk, S) rows, with cum = cumsum(a):
      y[t]  = sum_{s<=t} exp(cum[t] - cum[s]) (c[t] . b[s]) x[s]
              + exp(cum[t]) (c[t] . state)
      state = exp(cum[Q-1]) state + sum_s exp(cum[Q-1] - cum[s]) x[s] b[s]^T
    The reference's op order, with two changes.  The decay exponent is
    masked to -inf above the diagonal before `exp`: the reference forms
    exp(cum[t] - cum[s]) for every (t, s) and multiplies by the mask after,
    which gives inf * 0 = NaN once a chunk's decays sum below about -88.7
    (ROADMAP.md Queue 3).  And cum is summed and differenced in fp64, then
    rounded to the working type before `exp`: a chunk's decays sum to about
    -100 at zamba2-7b's widths, where an fp32 cum[t] - cum[s] carries the
    sums' rounding (about 1e-5, and it depends on the order each device
    sums in) into every weight.  Products in fp32 (fp64 for fp64 inputs);
    y in x's dtype.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = ssd_chunk(S, chunk)
    nc = S // Q
    dt = torch.promote_types(x.dtype, torch.float32)
    xq = x.reshape(B, nc, Q, H, P).to(dt)
    aq = a.reshape(B, nc, Q, H).to(dt)
    bq = b.reshape(B, nc, Q, H, N).to(dt)
    cq = c.reshape(B, nc, Q, H, N).to(dt)
    cum = torch.cumsum(aq.double(), dim=2)  # [B, nc, Q, H], fp64
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    expo = torch.where(tri[:, :, None],
                       (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(dt),
                       float("-inf"))
    cb = torch.einsum("bgthn,bgshn->bgtsh", cq, bq)
    y_intra = torch.einsum("bgtsh,bgshp->bgthp", cb * torch.exp(expo), xq)
    del expo, cb
    tail = torch.exp((cum[:, :, -1:, :] - cum).to(dt))  # [B, nc, Q, H]
    upd = torch.einsum("bgqhp,bgqhn->bghpn", xq * tail[..., None], bq)
    cum = cum.to(dt)
    total = torch.exp(cum[:, :, -1, :])  # [B, nc, H]
    state = torch.zeros((B, H, P, N), dtype=dt, device=x.device)
    prev = []  # the state entering each chunk
    for g in range(nc):
        prev.append(state)
        state = state * total[:, g, :, None, None] + upd[:, g]
    y_state = torch.einsum("bghpn,bgqhn->bgqhp", torch.stack(prev, dim=1),
                           cq) * torch.exp(cum)[..., None]
    return (y_intra + y_state).reshape(B, S, H, P).to(x.dtype)
