"""The arithmetic of the dht_insert and kmer_extract kernels, held on the CPU.

Both CUDA kernels (`repro_torch/kernels/csrc/dht_probe.cu`,
`csrc/kmer_extract.cu`) run only on the card.  Here a numpy model of each
design, step for step as the kernel takes it, is held to the reference:

* dht_insert: a streaming pass puts the valid rows on a compact worklist
  in whatever order the block atomics give; each round claims against the
  table as it stood at the round's start (a key that meets itself
  finishes, one that meets another key moves to the next list one slot
  on, one on an empty slot bids its batch index with atomicMax and goes
  to the bid list), then resolves the bid list (the highest bidder writes
  the slot, a loser whose winner holds its own key finishes on the slot at
  once, the other losers go to the next list); owner is never reset; a
  key's probes are (slot - h0) & (cap - 1), and it is exhausted when its
  next slot is h0.  Held to the JAX `repro.core.dht.insert_jnp`: table,
  slots and max_probe bit for bit, whatever the order of the lists.
* kmer_extract: a thread takes V consecutive windows of the flattened
  [R, L] batch from the bases its block staged (N outside the batch), does
  one division for the row and column of its first window, packs its
  first k - 1 bases four at a time (code << 8 | b0 << 6 | b1 << 4 |
  b2 << 2 | b3) and rolls the code and an N count from there.  Held to
  the port's plain `ref.kmer_extract_ref` (held to JAX in
  test_torch_kmer.py), every lane of every window, padding included.

Tolerance: exact.  Numpy and a few small JAX inserts: a few seconds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dht as jdht
from repro_torch.kernels import ref

M32 = np.uint64(0xFFFFFFFF)


def _mix32(x):
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & M32
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & M32
    return x ^ (x >> np.uint64(16))


def _hash(hi, lo):
    """repro::kmer_hash on uint32 lanes."""
    return _mix32(hi.astype(np.uint64) ^ _mix32(
        lo.astype(np.uint64) ^ np.uint64(0x9E3779B9)))


# ---------------------------------------------------------------- insert


def model_insert(table, hi, lo, valid, rng):
    """The cooperative dht_insert, round by round, on numpy arrays.

    Returns ((slot_hi, slot_lo, used, max_probe), slots, rounds,
    pending after round 1).  `rng` shuffles every list: the kernel's
    block atomics fix no order."""
    slot_hi, slot_lo, used = (np.array(x) for x in table[:3])
    cap = len(used)
    mask = np.uint64(cap - 1)
    n = len(hi)
    h0 = (_hash(hi, lo) & mask).astype(np.int64)
    slots = np.full(n, -1, np.int32)   # the streaming pass
    owner = np.full(cap, -1, np.int64)  # never reset
    cur = rng.permutation(np.flatnonzero(valid))
    at = h0[cur]
    pmax, rounds, after_first = 0, 0, None
    while len(cur):
        # claim, against the table at the round's start
        u = used[at]
        match = u & (slot_hi[at] == hi[cur]) & (slot_lo[at] == lo[cur])
        slots[cur[match]] = at[match]
        if match.any():
            pmax = max(pmax, int(((at[match] - h0[cur[match]]) % cap).max()))
        adv = u & ~match
        nxt_at = (at + 1) % cap
        exhausted = adv & (nxt_at == h0[cur])
        if exhausted.any():
            pmax = max(pmax, cap)  # slot stays -1
        move = adv & ~exhausted
        bid = ~u
        np.maximum.at(owner, at[bid], cur[bid])
        nxt, nxt_a = [cur[move]], [nxt_at[move]]
        # resolve: the bid list only; a loser whose winner holds its own
        # key finishes on the slot at once
        b, ba = cur[bid], at[bid]
        w = owner[ba]
        win = w == b
        slot_hi[ba[win]] = hi[b[win]]
        slot_lo[ba[win]] = lo[b[win]]
        used[ba[win]] = True
        done = win | ((hi[w] == hi[b]) & (lo[w] == lo[b]))
        slots[b[done]] = ba[done]
        if done.any():
            pmax = max(pmax, int(((ba[done] - h0[b[done]]) % cap).max()))
        nxt.append(b[~done])
        nxt_a.append(ba[~done])
        order = rng.permutation(sum(len(x) for x in nxt))
        cur = np.concatenate(nxt)[order]
        at = np.concatenate(nxt_a)[order]
        rounds += 1
        if after_first is None:
            after_first = len(cur)
    max_probe = np.int32(max(int(table[3]), pmax))
    return (slot_hi, slot_lo, used, max_probe), slots, rounds, after_first


def _keys(rng, n, dup_frac, key_space=1 << 40):
    vals = rng.integers(0, key_space, size=n, dtype=np.uint64)
    d = rng.random(n) < dup_frac
    vals[d] = vals[rng.integers(0, n, size=int(d.sum()))]
    return ((vals >> np.uint64(32)).astype(np.uint32),
            (vals & M32).astype(np.uint32))


def _empty(cap):
    return tuple(np.asarray(x) for x in jdht.empty_table(cap))


def _check_insert(table, hi, lo, valid, seed):
    jt = jdht.HashTable(*(jnp.asarray(x) for x in table))
    want_t, want_slots = jdht.insert_jnp(
        jt, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    for order_seed in (seed, seed + 1):  # two orders of every list
        got_t, got_slots, rounds, after = model_insert(
            table, hi, lo, valid, np.random.default_rng(order_seed))
        for g, w, what in zip(got_t, want_t, ("slot_hi", "slot_lo", "used",
                                              "max_probe")):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=what)
        np.testing.assert_array_equal(got_slots, np.asarray(want_slots))
    return tuple(np.asarray(x) for x in want_t), rounds, after


@pytest.mark.parametrize("n,cap,dup,valid_frac", [
    (400, 1024, 0.9, 0.95),   # 90% duplicated keys
    (100, 64, 0.0, 1.0),      # more distinct keys than cap: overflow
    (40, 16, 0.2, 1.0),       # cap 16: keys exhaust the table
    (300, 512, 0.3, 0.02),    # a few valid rows among many
])
def test_insert_design_equals_insert_jnp(n, cap, dup, valid_frac):
    rng = np.random.default_rng(n * 31 + cap)
    hi, lo = _keys(rng, n, dup)
    valid = rng.random(n) < valid_frac
    _, rounds, after = _check_insert(_empty(cap), hi, lo, valid, n)
    if valid.any():
        assert rounds >= 1 and after is not None


def test_insert_design_dedupes_against_a_filled_table():
    rng = np.random.default_rng(7)
    cap = 256
    hi, lo = _keys(rng, 150, 0.3)
    filled, _, _ = _check_insert(_empty(cap), hi, lo,
                                 np.ones(150, bool), 7)
    hi2, lo2 = _keys(rng, 150, 0.3)
    hi2[:90], lo2[:90] = hi[:90], lo[:90]  # most keys already in the table
    _check_insert(filled, hi2, lo2, rng.random(150) < 0.9, 8)


def test_insert_design_with_no_valid_key():
    rng = np.random.default_rng(3)
    hi, lo = _keys(rng, 50, 0.5)
    _, rounds, after = _check_insert(_empty(64), hi, lo, np.zeros(50, bool),
                                     3)
    assert rounds == 0 and after is None


# ---------------------------------------------------------- kmer_extract

def model_kmer_extract(bases, lengths, k, V, threads=4):
    """The kmer_extract kernel's per-thread arithmetic, vectorised over
    threads: every lane [R, L] as the kernel writes it."""
    R, L = bases.shape
    total = R * L
    W = L - k + 1
    flat = bases.reshape(-1)
    tile = threads * V
    blocks = -(-total // tile)
    halo, tail = 16, 32
    out = {name: np.zeros(total, dt) for name, dt in (
        ("hi", np.uint32), ("lo", np.uint32), ("hash", np.uint32),
        ("left", np.uint8), ("right", np.uint8), ("flip", np.bool_),
        ("valid", np.bool_))}
    mask = np.uint64((1 << (2 * k)) - 1)
    for blk in range(blocks):
        G0 = blk * tile
        src = np.arange(G0 - halo, G0 + tile + tail)
        staged = np.where((src >= 0) & (src < total),
                          flat[np.clip(src, 0, total - 1)], 4).astype(
                              np.uint64)
        g0 = G0 + V * np.arange(threads)
        live = g0 < total
        g0 = g0[live]
        # staged[t0 + j] = flat[g0 + j]; one division a thread
        t0 = halo + V * np.arange(threads)[live]
        r = g0 // L
        pos = g0 - r * L
        length = lengths[r].astype(np.int64)
        code = np.zeros(len(g0), np.uint64)
        n_count = np.zeros(len(g0), np.int64)
        i = 0
        while i + 4 <= k - 1:  # four bases from one 32-bit word
            b = [staged[t0 + i + q] for q in range(4)]
            code = ((code << np.uint64(8)) | (b[0] << np.uint64(6))
                    | (b[1] << np.uint64(4)) | (b[2] << np.uint64(2)) | b[3])
            n_count += sum((x >= 4).astype(np.int64) for x in b)
            i += 4
        for i in range(i, k - 1):
            b = staged[t0 + i]
            code = (code << np.uint64(2)) | b
            n_count += b >= 4
        for j in range(V):
            enter = staged[t0 + j + k - 1]
            before = staged[t0 + j - 1]
            after = staged[t0 + j + k]
            code = ((code << np.uint64(2)) | enter) & mask
            n_count += enter >= 4
            g = g0 + j
            keep = (g < total) & (pos < W)
            rc = _reverse_complement(code, k)
            flip = rc < code
            c = np.where(flip, rc, code)
            h = (c >> np.uint64(32)).astype(np.uint32)
            lo = (c & M32).astype(np.uint32)
            left_f = np.where(pos > 0, before, 4)
            right_f = np.where((pos + k < L) & (pos + k < length), after, 4)
            comp = lambda b: np.where(b < 4, 3 - b.astype(np.int64), b)
            gk = g[keep]
            out["hi"][gk] = h[keep]
            out["lo"][gk] = lo[keep]
            out["hash"][gk] = _hash(h, lo)[keep]
            out["left"][gk] = np.where(flip, comp(right_f), left_f)[keep]
            out["right"][gk] = np.where(flip, comp(left_f), right_f)[keep]
            out["flip"][gk] = flip[keep]
            out["valid"][gk] = ((n_count == 0) & (pos + k <= length))[keep]
            pad = (g < total) & (pos >= W)
            out["left"][g[pad]] = 4
            out["right"][g[pad]] = 4
            n_count -= staged[t0 + j] >= 4
            pos = pos + 1
            wrap = (pos == L) & (g + 1 < total)
            pos = np.where(wrap, 0, pos)
            r = r + wrap
            length = np.where(wrap, lengths[np.minimum(r, R - 1)], length)
    return {name: a.reshape(R, L) for name, a in out.items()}


def _reverse_complement(code, k):
    x = ~code & np.uint64((1 << (2 * k)) - 1)
    rc = np.zeros_like(code)
    for _ in range(k):
        rc = (rc << np.uint64(2)) | (x & np.uint64(3))
        x >>= np.uint64(2)
    return rc


def _reads(rng, R, L):
    bases = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    bases[rng.random((R, L)) < 0.03] = 4
    for r in range(0, R, 3):  # N runs
        s = rng.integers(0, L)
        bases[r, s:s + rng.integers(1, 8)] = 4
    bases[R // 2] = 4  # an all-N row
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    lengths[0] = 0
    lengths[1 % R] = min(L, 2)  # a read shorter than k
    return bases, lengths


@pytest.mark.parametrize("V", [4, 8])
@pytest.mark.parametrize("k", [3, 16, 17, 31])
@pytest.mark.parametrize("R,L", [(7, 40), (5, 77), (3, None)])
def test_rolling_kmer_extract_equals_plain(k, V, R, L):
    L = k if L is None else L  # L = k: one window a row
    rng = np.random.default_rng(100 * k + 10 * V + R)
    bases, lengths = _reads(rng, R, L)
    got = model_kmer_extract(bases, lengths, k, V)
    want = ref.kmer_extract_ref(torch.from_numpy(bases),
                                torch.from_numpy(lengths), k=k)
    for lane in ("hi", "lo", "hash", "left", "right", "flip", "valid"):
        w = getattr(want, lane).numpy()
        w = w.view(np.uint32) if w.dtype == np.int32 else w
        np.testing.assert_array_equal(got[lane], w, err_msg=lane)
