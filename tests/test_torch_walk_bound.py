"""The counts that the bounds of dht_lookup and mer_walk rest on, on the CPU.

`chip_smoke.py` bounds mer_walk by latency: the steps of the longest walk
(`counts["rounds"]` of `ref.mer_walk_ref`, the loop's iterations) times one
dependent round trip; and dht_lookup by the bytes its queries need
(`ref.dht_lookup_work`: 5 a row, 8 a valid row's key lanes, 9 a slot
examined, 4 for max_probe).  Here both counts are held to numbers known
by construction: a one-read ladder whose walks are known base by base, its
probe chains counted apart in numpy, and a 16-slot table laid out by hand.
The walk's outputs and its 'steps' and 'probes' are the same with and
without `counts`.  Torch and numpy only: no JAX, a few seconds.
"""
import numpy as np
import torch

from repro_torch.core import kmer, local_assembly
from repro_torch.core.types import ReadSet
from repro_torch.kernels import ref

K = local_assembly.BUF_K  # 31
M = 21                     # the one rung
TAG_BITS = 16


def _mix32(x):
    x = x.astype(np.uint64) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def _home(hi, lo, cap):
    """kmer_hash(hi, lo) & (cap - 1), in numpy (uint32 lanes)."""
    return int(_mix32(np.uint64(hi) ^ _mix32(np.uint64(lo) ^ 0x9E3779B9))
               & (cap - 1))


def _lanes(t):
    return int(t) & 0xFFFFFFFF


def _one_read_ladder(seed=3, extra=20, cap=1 << 10):
    """Walk tables of one read S of K + extra bases on contig 0, one rung of
    M-mers, and S.  Every M-mer of S (and of its reverse complement) is
    distinct, so a walker on a K-window of S accepts each next base of S
    and meets a dead end at S's last M-mer."""
    rng = np.random.default_rng(seed)
    while True:
        s = rng.integers(0, 4, size=K + extra).astype(np.uint8)
        mers = {tuple(s[i:i + M]) for i in range(len(s) - M + 1)}
        rc = 3 - s[::-1]
        mers_rc = {tuple(rc[i:i + M]) for i in range(len(rc) - M + 1)}
        if len(mers) == len(s) - M + 1 and not mers & mers_rc:
            break
    reads = ReadSet(torch.from_numpy(s[None, :]),
                    torch.tensor([len(s)], dtype=torch.int32),
                    torch.tensor([-1], dtype=torch.int32), 0)
    wt = local_assembly.build_walk_tables(
        reads, torch.tensor([0], dtype=torch.int32), mer_sizes=(M,),
        tag_bits=TAG_BITS, capacity=cap, backend="torch")
    return wt, s


def _walk(wt, s, starts, active, **kw):
    """mer_walk_ref of walkers on the K-windows of s at `starts`."""
    buf = np.stack([s[p:p + K] for p in starts])
    hi, lo = kmer.pack_window(torch.from_numpy(buf), k=K)
    E = len(starts)
    z = torch.zeros(E, dtype=torch.int32)
    t = wt.tables[0]
    return ref.mer_walk_ref(
        hi, lo, torch.zeros(E, dtype=torch.int32),
        torch.tensor(active), z, z, (t.slot_hi,), (t.slot_lo,), (t.used,),
        (t.max_probe,), tuple(wt.right_hist), tuple(wt.left_hist),
        mer_sizes=(M,), tag_bits=TAG_BITS, max_ext=64, **kw)


def _slots_examined(table, s, start, steps):
    """Slots the probe chains of one walker's `steps` steps examine, from
    the table's arrays: the mer of each step (the last M bases of its
    buffer, canonical, tagged with contig 0), probed linearly from its
    home slot until its key or an unused slot."""
    cap = table.capacity
    hi_t = table.slot_hi.numpy().view(np.uint32)
    lo_t = table.slot_lo.numpy().view(np.uint32)
    used = table.used.numpy()
    total = 0
    for j in range(steps):
        end = start + K + j  # the buffer is s[end - K:end]
        mer = torch.from_numpy(s[end - M:end][None, :])
        chi, clo = kmer.pack_window(mer, k=M)
        chi, clo, _ = kmer.canonical(chi, clo, k=M)
        khi, klo = _lanes(chi[0]), _lanes(clo[0])  # tag 0 adds nothing
        a = _home(khi, klo, cap)
        while True:
            total += 1
            if not used[a] or (hi_t[a] == khi and lo_t[a] == klo):
                break
            a = (a + 1) % cap
    return total


def test_rounds_is_the_longest_walk():
    """Walker 0 starts at S[0:31] and accepts the 20 bases after it, then
    meets the dead end: 21 steps.  Walker 1 starts 10 bases on: 11 steps.
    Walker 2 is inactive.  The loop runs 21 times."""
    wt, s = _one_read_ladder()
    counts = {}
    out = _walk(wt, s, [0, 10, 5], [True, True, False], counts=counts)
    assert out.ext_len.tolist() == [20, 10, 0]
    assert out.status.tolist() == [ref.DEADEND, ref.DEADEND, ref.DONE]
    assert out.ext_bases[0, :20].tolist() == s[K:].tolist()
    assert counts["rounds"] == 21
    assert counts["steps"] == 21 + 11
    assert counts["probes"] == (_slots_examined(wt.tables[0], s, 0, 21)
                                + _slots_examined(wt.tables[0], s, 10, 11))


def test_counts_leave_the_walk_unchanged():
    """With `counts` given, the outputs are those of the call without it,
    and the counts add up over calls ('rounds' too)."""
    wt, s = _one_read_ladder(seed=4, extra=30)
    starts, active = [0, 3, 12, 25], [True, True, True, True]
    plain = _walk(wt, s, starts, active)
    counts = {}
    got = _walk(wt, s, starts, active, counts=counts)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert plain.ext_len.tolist() == [30, 27, 18, 5]
    assert counts == {"steps": 31 + 28 + 19 + 6,
                      "probes": sum(_slots_examined(wt.tables[0], s, p, n)
                                    for p, n in zip(starts, (31, 28, 19, 6))),
                      "rounds": 31}
    _walk(wt, s, starts[2:], active[2:], counts=counts)
    assert counts["rounds"] == 31 + 19
    assert counts["steps"] == 31 + 28 + 19 + 6 + 19 + 6


def _colliding_keys(cap, n):
    """n keys (hi, lo) of one home slot in a table of cap slots."""
    keys, home = [], None
    for lo in range(1, 1 << 20):
        h = _home(7, lo, cap)
        if home is None:
            home = h
        if h == home:
            keys.append((7, lo))
            if len(keys) == n:
                return keys, home
    raise AssertionError("no collision found")


def test_dht_lookup_work_on_a_table_laid_out_by_hand():
    """A 16-slot table: keys A and B share the home slot h (A at h, B at
    h + 1), slot h + 2 is empty.  Queries: A (1 slot examined), B (2),
    C, absent with the same home (3: A, B, the empty slot), D, absent
    with an empty home (1), and two invalid rows (none)."""
    cap = 16
    (a, b, c), h = _colliding_keys(cap, 3)
    d = next((7, lo) for lo in range(1 << 20)
             if _home(7, lo, cap) not in (h, (h + 1) % cap, (h + 2) % cap))
    slot_hi = torch.full((cap,), -1, dtype=torch.int32)
    slot_lo = torch.zeros((cap,), dtype=torch.int32)
    used = torch.zeros((cap,), dtype=torch.bool)
    for key, at in ((a, h), (b, (h + 1) % cap)):
        slot_hi[at], slot_lo[at], used[at] = key[0], key[1], True
    max_probe = torch.tensor(1, dtype=torch.int32)
    q = [a, b, c, d, a, c]
    hi = torch.tensor([k[0] for k in q], dtype=torch.int32)
    lo = torch.tensor([k[1] for k in q], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False, False])
    slots = ref.dht_lookup_ref(slot_hi, slot_lo, used, max_probe, hi, lo,
                               valid)
    assert slots.tolist() == [h, (h + 1) % cap, -1, -1, -1, -1]
    work = ref.dht_lookup_work(slot_hi, slot_lo, used, max_probe, hi, lo,
                               valid)
    n, n_valid, examined = 6, 4, 1 + 2 + 3 + 1
    assert work == {"rows": n, "valid": n_valid, "slots": examined,
                    "bytes": 5 * n + 8 * n_valid + 9 * examined + 4,
                    "bytes_every_row": 13 * n + 9 * n_valid + 4}
    # [rows, 2] queries count the same
    work2 = ref.dht_lookup_work(slot_hi, slot_lo, used, max_probe,
                                hi.reshape(3, 2), lo.reshape(3, 2),
                                valid.reshape(3, 2))
    assert work2 == work
