"""Kernel dispatch: the one entry point for every kernel of the port.

Mirrors `repro.kernels.ops`.  Each op takes tensors and chooses by their
device:

  * a CUDA tensor launches the hand-written kernel built from `csrc/`
    (`build`); a failed build or launch raises;
  * a CPU tensor takes the plain PyTorch version in `ref`.

`backend="torch"` runs the plain version on any device; it exists so a
caller can hold a kernel against its plain version on the card.  Every
other value raises.  `LAUNCHES` counts, per op, the kernel launches made
since the last `reset_launches()`: a plain-version call does not count.
"""
from __future__ import annotations

import torch

from repro_torch.core import kmer as _kmer

from . import build, ref
from .ref import KmerLanes  # re-export  # noqa: F401

KERNELS = ("kmer_extract", "dht_lookup", "dht_insert", "seed_probe")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _use_kernel(backend, t: torch.Tensor) -> bool:
    if backend == "torch":
        return False
    if backend is not None:
        raise ValueError(
            f"kernel backend {backend!r} unknown: None (kernel on CUDA "
            f"tensors, plain version on CPU tensors) or 'torch' (plain)")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: kernel takes a contiguous {dtype} tensor on {dev}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(op: str, lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{op} kernel failed: {lib.repro_error_string(err).decode()}")
    LAUNCHES[op] += 1


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def kmer_extract(bases, lengths, *, k: int, backend=None) -> KmerLanes:
    """Every k-mer lane of a dense [R, L] batch: `KmerLanes`, each [R, L].

    Canonical (hi, lo) codes, owner hash, canonicalized extension bases,
    strand flip and validity in one pass; the last k-1 columns are padding.
    """
    if not _use_kernel(backend, bases):
        return ref.kmer_extract_ref(bases, lengths, k=k)
    R, L = bases.shape
    if not 1 <= k <= 31 or L < k:
        raise ValueError(f"kmer_extract: need 1 <= k <= 31 and L >= k, "
                         f"got k={k}, L={L}")
    dev = bases.device
    _check("bases", bases, torch.uint8, dev)
    _check("lengths", lengths, torch.int32, dev)
    out = KmerLanes(*(torch.empty((R, L), dtype=dt, device=dev) for dt in (
        torch.int32, torch.int32, torch.int32, torch.uint8, torch.uint8,
        torch.bool, torch.bool)))
    lib = build.library("kmer_extract")
    err = lib.kmer_extract_launch(
        _ptr(bases), _ptr(lengths), R, L, k, *map(_ptr, out), _stream(dev))
    _launched("kmer_extract", lib, err)
    return out


def kmer_hash(hi, lo):
    """Owner hash of packed codes: plain torch, as the reference's jnp op."""
    return _kmer.kmer_hash(hi, lo)


def _table_args(slot_hi, slot_lo, used, max_probe, dev):
    cap = slot_hi.shape[0]
    if not _is_pow2(cap):
        raise ValueError(f"table capacity {cap} is not a power of two")
    _check("slot_hi", slot_hi, torch.int32, dev)
    _check("slot_lo", slot_lo, torch.int32, dev)
    _check("used", used, torch.bool, dev)
    mp = torch.as_tensor(max_probe, dtype=torch.int32, device=dev).reshape(1)
    return cap, mp


def dht_lookup(slot_hi, slot_lo, used, max_probe, hi, lo, valid=None, *,
               backend=None):
    """Slot of each query key in an open-addressed table, -1 when absent.

    Queries of any shape; the result has their shape (int32).
    """
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    if not _use_kernel(backend, hi):
        return ref.dht_lookup_ref(slot_hi, slot_lo, used, max_probe,
                                  hi, lo, valid)
    dev = hi.device
    cap, mp = _table_args(slot_hi, slot_lo, used, max_probe, dev)
    fhi, flo, fval = hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)
    for name, t, dt in (("hi", fhi, torch.int32), ("lo", flo, torch.int32),
                        ("valid", fval, torch.bool)):
        _check(name, t, dt, dev)
    out = torch.empty(fhi.shape, dtype=torch.int32, device=dev)
    lib = build.library("dht_probe")
    err = lib.dht_lookup_launch(
        _ptr(slot_hi), _ptr(slot_lo), _ptr(used), _ptr(mp), cap, _ptr(fhi),
        _ptr(flo), _ptr(fval), fhi.shape[0], _ptr(out), _stream(dev))
    _launched("dht_lookup", lib, err)
    return out.reshape(hi.shape)


def dht_insert(slot_hi, slot_lo, used, max_probe, hi, lo, valid, *,
               backend=None):
    """Insert [n] keys with the bulk-synchronous claim rounds.

    Returns (slot_hi, slot_lo, used, max_probe, slots): a new table (the
    inputs are not modified), max_probe as a 0-dim int32 tensor, and the
    slot of each key (-1 if invalid or overflowed).
    """
    if not _use_kernel(backend, hi):
        return ref.dht_insert_ref(slot_hi, slot_lo, used, max_probe,
                                  hi, lo, valid)
    dev = hi.device
    cap, mp = _table_args(slot_hi, slot_lo, used, max_probe, dev)
    n = hi.shape[0]
    if n >= 1 << 31 or cap > 1 << 31:
        raise ValueError(f"dht_insert: n={n}, cap={cap} exceed int32 indices")
    for name, t, dt in (("hi", hi, torch.int32), ("lo", lo, torch.int32),
                        ("valid", valid, torch.bool)):
        _check(name, t, dt, dev)
    slot_hi, slot_lo, used, mp = (slot_hi.clone(), slot_lo.clone(),
                                  used.clone(), mp.clone())
    slots = torch.empty((n,), dtype=torch.int32, device=dev)
    done = torch.empty((n,), dtype=torch.uint8, device=dev)
    flags = torch.empty((n,), dtype=torch.uint8, device=dev)
    attempt = torch.empty((n,), dtype=torch.int32, device=dev)
    probes = torch.empty((n,), dtype=torch.int32, device=dev)
    work = torch.empty((n,), dtype=torch.int32, device=dev)
    owner = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    counters = torch.zeros((2,), dtype=torch.int32, device=dev)
    lib = build.library("dht_probe")
    err = lib.dht_insert_launch(
        _ptr(slot_hi), _ptr(slot_lo), _ptr(used), _ptr(mp), cap, _ptr(hi),
        _ptr(lo), _ptr(valid), n, _ptr(slots), _ptr(done), _ptr(flags),
        _ptr(attempt), _ptr(probes), _ptr(owner), _ptr(work), _ptr(counters),
        _stream(dev))
    _launched("dht_insert", lib, err)
    return slot_hi, slot_lo, used, mp.reshape(()), slots


def seed_probe(bases, lengths, slot_hi, slot_lo, used, max_probe,
               contig, pos, flip, multi, *, seed_len: int, positions,
               backend=None):
    """Alignment front half: seeds -> voted top-2 placements per read.

    Seeds of `seed_len` bases at the start columns `positions`, probed in
    the seed index (table + contig/pos/flip/multi side arrays).  Returns
    (contig, cstart, orient), each [R, 2]; contig -1 = no placement.
    """
    positions = tuple(int(p) for p in positions)
    if not _use_kernel(backend, bases):
        return ref.seed_probe_ref(
            bases, lengths, slot_hi, slot_lo, used, max_probe, contig, pos,
            flip, multi, seed_len=seed_len, positions=positions)
    R, L = bases.shape
    dev = bases.device
    lib = build.library("seed_probe")
    S = len(positions)
    if not 1 <= S <= lib.seed_probe_max_seeds():
        raise ValueError(f"seed_probe: {S} seeds, kernel takes 1.."
                         f"{lib.seed_probe_max_seeds()}")
    if min(positions) < 0 or max(positions) + seed_len > L:
        raise ValueError(f"seed_probe: seeds {positions} of {seed_len} "
                         f"bases leave the {L}-column rows")
    _check("bases", bases, torch.uint8, dev)
    _check("lengths", lengths, torch.int32, dev)
    cap, mp = _table_args(slot_hi, slot_lo, used, max_probe, dev)
    for name, t, dt in (("contig", contig, torch.int32),
                        ("pos", pos, torch.int32), ("flip", flip, torch.bool),
                        ("multi", multi, torch.bool)):
        _check(name, t, dt, dev)
    pcols = torch.tensor(positions, dtype=torch.int32, device=dev)
    out_c = torch.empty((R, 2), dtype=torch.int32, device=dev)
    out_s = torch.empty((R, 2), dtype=torch.int32, device=dev)
    out_o = torch.empty((R, 2), dtype=torch.uint8, device=dev)
    err = lib.seed_probe_launch(
        _ptr(bases), _ptr(lengths), R, L, _ptr(slot_hi), _ptr(slot_lo),
        _ptr(used), _ptr(mp), cap, _ptr(contig), _ptr(pos), _ptr(flip),
        _ptr(multi), _ptr(pcols), S, seed_len, _ptr(out_c), _ptr(out_s),
        _ptr(out_o), _stream(dev))
    _launched("seed_probe", lib, err)
    return out_c, out_s, out_o
