"""Kernel dispatch: the one entry point for every kernel of the port.

Mirrors `repro.kernels.ops`.  Each op takes tensors and chooses by their
device:

  * a CUDA tensor launches the hand-written kernel built from `csrc/`
    (`build`); a failed build or launch raises;
  * a CPU tensor takes the plain PyTorch version in `ref`.

`backend="torch"` runs the plain version on any device; it exists so a
caller can hold a kernel against its plain version on the card.  Every
other value raises.  A kernel launches on the current CUDA device, so an
op refuses a CUDA tensor on any other card.  `LAUNCHES` counts, per op,
the kernel launches made since the last `reset_launches()`: a
plain-version call does not count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import kmer as _kmer

from . import build, ref
from .ref import KmerLanes, MerWalkOut  # re-export  # noqa: F401

KERNELS = ("kmer_extract", "dht_lookup", "dht_insert", "seed_probe",
           "mer_walk", "sw_extend", "flash_attention", "ssd_scan")
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
        _on_current_device(t)
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _on_current_device(t: torch.Tensor) -> None:
    """The kernels launch on the current device (no source sets one):
    refuse a tensor on another card rather than launch there."""
    current = torch.cuda.current_device()
    if t.device.index is not None and t.device.index != current:
        raise ValueError(
            f"kernel input on {t.device}, but the current device is "
            f"cuda:{current}: call torch.cuda.set_device({t.device.index}) "
            f"first (a mesh rank does, for its card)")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dev) -> None:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: kernel takes a contiguous {dtype} tensor on {dev}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(dev) -> int:
    """The current stream's handle (the raw query: a Stream object costs
    microseconds of host time a launch)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _refuse_grad(op: str, *tensors) -> None:
    """The LM kernels have no backward: autograd would stop at their
    output, and the parameters before it would get no gradient.  Refuse
    inputs that require grad under grad mode, on every device and backend
    (the reference's kernel path cannot be differentiated either)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{op}: the kernel has no backward; run the plain path "
            f"(use_kernel=False) to differentiate, or call it under "
            f"torch.no_grad() / torch.inference_mode()")


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
    flat = hi.dim() == 1 and lo.dim() == 1 and valid.dim() == 1
    fhi, flo, fval = (hi, lo, valid) if flat else (
        hi.reshape(-1), lo.reshape(-1), valid.reshape(-1))
    for name, t, dt in (("hi", fhi, torch.int32), ("lo", flo, torch.int32),
                        ("valid", fval, torch.bool)):
        _check(name, t, dt, dev)
    n = fhi.shape[0]
    if flo.shape[0] != n or fval.shape[0] != n:
        raise ValueError(f"dht_lookup: hi, lo and valid hold {n}, "
                         f"{flo.shape[0]} and {fval.shape[0]} queries")
    out = torch.empty(hi.shape, dtype=torch.int32, device=dev)
    lib = build.library("dht_probe")
    err = lib.dht_lookup_launch(
        _ptr(slot_hi), _ptr(slot_lo), _ptr(used), _ptr(mp), cap, _ptr(fhi),
        _ptr(flo), _ptr(fval), n, _ptr(out), _stream(dev))
    _launched("dht_lookup", lib, err)
    return out


# the device counters of the last dht_insert launch, by the names the
# library gives them (csrc/dht_probe.cu, INSERT_COUNTERS): valid keys,
# rounds, keys pending after round 1, ...
LAST_INSERT: dict = {}


def dht_insert(slot_hi, slot_lo, used, max_probe, hi, lo, valid, *,
               backend=None):
    """Insert [n] keys with the bulk-synchronous claim rounds.

    Returns (slot_hi, slot_lo, used, max_probe, slots): a new table (the
    inputs are not modified), max_probe as a 0-dim int32 tensor, and the
    slot of each key (-1 if invalid or overflowed).  On the card a count
    pass sizes the worklist of valid keys (the host reads the count), and
    one cooperative launch runs all rounds; its device counters are read
    back once, after it (`LAST_INSERT`).
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
    out = tuple(torch.empty_like(t) for t in (slot_hi, slot_lo, used, mp))
    slots = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = build.library("dht_probe")
    names = lib.dht_insert_counter_names().decode().split()
    counters = torch.zeros((len(names),), dtype=torch.int32, device=dev)
    stream = _stream(dev)
    err = lib.dht_insert_count_launch(_ptr(valid), n, _ptr(counters), stream)
    if err != 0:
        raise RuntimeError(f"dht_insert count pass failed: "
                           f"{lib.repro_error_string(err).decode()}")
    m = int(counters[0])
    owner = torch.empty((cap,), dtype=torch.int32, device=dev)
    lists = torch.empty((6, max(m, 1)), dtype=torch.int32, device=dev)
    err = lib.dht_insert_launch(
        _ptr(slot_hi), _ptr(slot_lo), _ptr(used), _ptr(mp), *map(_ptr, out),
        cap, _ptr(hi), _ptr(lo), _ptr(valid), n, _ptr(slots), _ptr(owner),
        _ptr(lists), max(m, 1), _ptr(counters), stream)
    _launched("dht_insert", lib, err)
    LAST_INSERT.clear()
    LAST_INSERT.update(zip(names, counters.tolist()))
    if LAST_INSERT["error"]:
        raise RuntimeError(f"dht_insert kernel failed: "
                           f"{lib.repro_error_string(-1).decode()}")
    return (*out[:3], out[3].reshape(()), slots)


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
    cols = (ctypes.c_int32 * S)(*positions)  # host array: copied by value
    out_c = torch.empty((R, 2), dtype=torch.int32, device=dev)
    out_s = torch.empty((R, 2), dtype=torch.int32, device=dev)
    out_o = torch.empty((R, 2), dtype=torch.uint8, device=dev)
    err = lib.seed_probe_launch(
        _ptr(bases), _ptr(lengths), R, L, _ptr(slot_hi), _ptr(slot_lo),
        _ptr(used), _ptr(mp), cap, _ptr(contig), _ptr(pos), _ptr(flip),
        _ptr(multi), ctypes.addressof(cols), S, seed_len, _ptr(out_c),
        _ptr(out_s), _ptr(out_o), _stream(dev))
    _launched("seed_probe", lib, err)
    return out_c, out_s, out_o


def mer_walk(wt, start_hi, start_lo, contig, active, *, mer_sizes: tuple,
             tag_bits: int, max_ext: int, min_votes: int = 1,
             dominance: int = 4, target_hi=None, target_lo=None,
             seed_len: int = 0, backend=None) -> MerWalkOut:
    """Dynamic-mer ladder walk for E walkers (§II-G / §III-D).

    The one walk path of the port: contig extension
    (`local_assembly.extend_with_tables`) and gap closing
    (`gap_closing.close_and_render_with_tables`).  `wt` is a
    `local_assembly.WalkTables` (one `dht.HashTable` and a right and a left
    [cap, 4] int32 histogram per rung, one rung per entry of `mer_sizes`);
    its per-rung arrays go to the kernel as they are, never stacked.

    start_hi/lo: [E] lanes, the 31-base suffix of each walker's contig end
    oriented so the walk appends rightward; contig: [E] int32 (the table
    tag); active: [E] bool.  Pass `target_hi/lo` with seed_len > 0 for the
    gap-closing variant: a walker whose buffer suffix becomes its target
    seed stops with status HIT and records `hit_pos`.
    """
    n = len(mer_sizes)
    if len(wt.tables) != n:
        raise ValueError(f"mer_walk: {len(wt.tables)} tables for the "
                         f"{n}-rung ladder {tuple(mer_sizes)}")
    cap = wt.tables[0].capacity
    if any(t.capacity != cap for t in wt.tables):
        raise ValueError("mer_walk: rung capacities differ")
    if target_hi is None:
        seed_len = 0
    elif seed_len <= 0:
        raise ValueError("mer_walk: a target walk needs seed_len > 0")
    kw = dict(mer_sizes=tuple(mer_sizes), tag_bits=tag_bits, max_ext=max_ext,
              min_votes=min_votes, dominance=dominance, seed_len=seed_len)
    if not _use_kernel(backend, start_hi):
        if target_hi is None:
            target_hi = torch.zeros_like(start_hi)
            target_lo = torch.zeros_like(start_lo)
        return ref.mer_walk_ref(
            start_hi, start_lo, contig, active, target_hi, target_lo,
            tuple(t.slot_hi for t in wt.tables),
            tuple(t.slot_lo for t in wt.tables),
            tuple(t.used for t in wt.tables),
            tuple(t.max_probe for t in wt.tables),
            tuple(wt.right_hist), tuple(wt.left_hist), **kw)
    if not 1 <= n <= 3 or not all(1 <= m <= 31 for m in mer_sizes):
        raise ValueError(f"mer_walk: kernel takes 1..3 rungs of mers "
                         f"1..31, got {tuple(mer_sizes)}")
    if not 0 <= tag_bits <= 16 or 2 * max(mer_sizes) + tag_bits > 62:
        raise ValueError(f"mer_walk: tag_bits={tag_bits} does not fit "
                         f"above {max(mer_sizes)}-mers in 62 bits")
    if max_ext < 1 or seed_len > 31:
        raise ValueError(f"mer_walk: max_ext={max_ext}, seed_len="
                         f"{seed_len} (need max_ext >= 1, seed_len <= 31)")
    if not _is_pow2(cap):
        raise ValueError(f"table capacity {cap} is not a power of two")
    dev = start_hi.device
    E = start_hi.shape[0]
    # one pass over every tensor the kernel reads, (tensor, dtype, shape);
    # the extension walk has no target and passes null pointers.  Names
    # are made only for an error message.
    walkers = [start_hi, start_lo, contig, active]
    if seed_len:
        walkers += [target_hi, target_lo]
    rungs = []  # 6 per rung, in the kernel's order
    for r, t in enumerate(wt.tables):
        mp = torch.as_tensor(t.max_probe, dtype=torch.int32, device=dev)
        rungs += [t.slot_hi, t.slot_lo, t.used, mp, wt.right_hist[r],
                  wt.left_hist[r]]
    rung_specs = ((torch.int32, (cap,)), (torch.int32, (cap,)),
                  (torch.bool, (cap,)), (torch.int32, None),
                  (torch.int32, (cap, 4)), (torch.int32, (cap, 4)))
    specs = [(dt, (E,)) for dt in (torch.int32, torch.int32, torch.int32,
                                   torch.bool, torch.int32, torch.int32)]
    specs = specs[:len(walkers)] + list(rung_specs) * n
    for i, (t, (dt, shape)) in enumerate(zip(walkers + rungs, specs)):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or (t.numel() != 1 if shape is None else t.shape != shape)):
            names = ["start_hi", "start_lo", "contig", "active",
                     "target_hi", "target_lo"][:len(walkers)] + [
                f"rung {r} {a}" for r in range(n) for a in (
                    "slot_hi", "slot_lo", "used", "max_probe", "right_hist",
                    "left_hist")]
            raise ValueError(
                f"mer_walk: {names[i]} must be a contiguous {dt} tensor on "
                f"{dev} of shape {shape or '(1,)'}; got {t.dtype} on "
                f"{t.device}, shape {tuple(t.shape)}, contiguous="
                f"{t.is_contiguous()}")
    ptrs = [_ptr(t) for t in rungs]
    if any(p % 16 for p in ptrs[4::6] + ptrs[5::6]):
        raise ValueError("mer_walk: the kernel loads 16-byte histogram "
                         "rows: histograms must be 16-byte aligned")
    ints = torch.empty((3, E), dtype=torch.int32, device=dev)
    out = MerWalkOut(torch.empty((E, max_ext), dtype=torch.uint8, device=dev),
                     ints[0], ints[1],
                     torch.empty((E,), dtype=torch.bool, device=dev), ints[2])
    lib = build.library("mer_walk")
    err = lib.mer_walk_launch(
        _ptr(start_hi), _ptr(start_lo), _ptr(contig), _ptr(active),
        _ptr(target_hi) if seed_len else None,
        _ptr(target_lo) if seed_len else None, E,
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * n)(*mer_sizes), n, cap, tag_bits, max_ext,
        min_votes, dominance, seed_len, *map(_ptr, out), _stream(dev))
    _launched("mer_walk", lib, err)
    return out


def sw_extend(query, target, qlen, tlen, *, band: int = 15, match: int = 1,
              mismatch: int = -1, gap: int = -1, backend=None):
    """Banded semi-global extension scores (§II-F) of B (query, target)
    pairs: query [B, QL] and target [B, TL] uint8, qlen / tlen [B] int32.

    Returns (best_score, best_qpos, best_tpos), each [B] int32, 1-based DP
    coordinates of the best cell (0 = no positive extension).  Any B; the
    kernel takes one thread per pair and masks a block's ragged end.
    """
    if not _use_kernel(backend, query):
        return ref.sw_extend_ref(query, target, qlen, tlen, band=band,
                                 match=match, mismatch=mismatch, gap=gap)
    dev = query.device
    lib = build.library("sw_extend")
    max_band = lib.sw_extend_max_band()
    if not 0 <= band <= max_band:
        raise ValueError(f"sw_extend: band={band}; the kernel holds a band "
                         f"of 2*band+1 <= 31 cells in one thread's registers "
                         f"(band <= {max_band})")
    B, QL = query.shape
    TL = target.shape[1]
    if target.shape[0] != B or qlen.shape != (B,) or tlen.shape != (B,):
        raise ValueError(f"sw_extend: query {tuple(query.shape)}, target "
                         f"{tuple(target.shape)}, qlen {tuple(qlen.shape)}, "
                         f"tlen {tuple(tlen.shape)} do not share B")
    if QL < 1 or 4 * (QL + TL) > 48 * 1024:
        raise ValueError(f"sw_extend: rows of QL={QL}, TL={TL} do not fit "
                         f"the kernel's shared memory")
    for name, t, dt in (("query", query, torch.uint8),
                        ("target", target, torch.uint8),
                        ("qlen", qlen, torch.int32),
                        ("tlen", tlen, torch.int32)):
        _check(name, t, dt, dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev).unbind(0)
    err = lib.sw_extend_launch(
        _ptr(query), _ptr(target), _ptr(qlen), _ptr(tlen), B, QL, TL, band,
        match, mismatch, gap, *map(_ptr, out), _stream(dev))
    _launched("sw_extend", lib, err)
    return out


# dtype codes of the flash kernel's C interface
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_HEAD_DIMS = (16, 32, 64, 112, 128, 256)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    backend=None):
    """Online-softmax attention for [B, H, S, D] q and [B, KH, S, D] k, v
    (GQA: query head h reads KV head h // (H // KH)); any S >= 1.

    fp32 or bf16 inputs of one dtype, fp32 accumulation, output in q's
    dtype; scale defaults to 1/sqrt(D).  The kernel takes D in (16, 32,
    64, 112, 128, 256) and contiguous tensors.  It has no backward: inputs
    that require grad under grad mode raise ValueError.
    """
    _refuse_grad("flash_attention", q, k, v)
    if not _use_kernel(backend, q):
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, H, S, D], got "
                         f"{tuple(q.shape)}")
    B, H, S, D = q.shape
    KH = k.shape[1] if k.dim() == 4 else 0
    if k.shape != (B, KH, S, D) or v.shape != k.shape or KH < 1 or H % KH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: need k, v "
                         f"[B, KH, S, D] with H % KH == 0")
    if D not in _FLASH_HEAD_DIMS or S < 1:
        raise ValueError(f"flash_attention: the kernel takes head_dim in "
                         f"{_FLASH_HEAD_DIMS} and S >= 1, got D={D}, S={S}")
    if q.dtype not in _FLASH_DTYPES:
        raise ValueError(f"flash_attention: the kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if B * H >= 1 << 31 or -(-S // 64) > 65535:
        raise ValueError(f"flash_attention: grid of B*H={B * H} heads and "
                         f"S={S} rows exceeds the launch limits")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: the kernel takes 16-byte "
                             f"aligned tensors (TMA, cp.async); {name} is "
                             f"at {t.data_ptr():#x}")
    scale = float(scale if scale is not None else 1.0 / (D ** 0.5))
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    err = lib.flash_attention_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, H, KH, S, D, int(causal),
        scale, _FLASH_DTYPES[q.dtype], _stream(dev))
    _launched("flash_attention", lib, err)
    return out


# the ssd_scan kernels' maxima: csrc/ssd_scan.cu (kT, kP, kN) takes heads
# of P, N <= 64, csrc/ssd_scan_wide.cu (kT, kMaxWidth) those up to 256
_SSD_MAX_CHUNK, _SSD_MAX_P, _SSD_MAX_N = 128, 64, 64
_SSD_WIDE_MAX = 256


def ssd_scan(x, a, b, c, *, chunk: int = 128, backend=None):
    """Chunked Mamba-2 SSD scan: x [B, S, H, P], log-decays a [B, S, H],
    b, c [B, S, H, N] -> y [B, S, H, P] (`ref.ssd_scan_ref`).

    The chunk is Q = min(chunk, S) and S must be a multiple of it, on both
    paths.  The kernels take contiguous fp32 tensors with Q <= 128:
    `ssd_scan.cu` heads of P, N <= 64 (zamba2's), `ssd_scan_wide.cu` the
    wider ones up to P, N <= 256 (the mLSTM's 192) with B H <= 65535, in
    whole 64-wide tiles (a head of other widths, or unaligned data, runs
    on a zero-padded copy); a wider head raises.  No backward: inputs
    that require grad under grad mode raise ValueError.
    """
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be [B, S, H, P], got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    Q = ref.ssd_chunk(S, chunk)
    _refuse_grad("ssd_scan", x, a, b, c)
    if not _use_kernel(backend, x):
        return ref.ssd_scan_ref(x, a, b, c, chunk=chunk)
    N = b.shape[-1] if b.dim() == 4 else 0
    if a.shape != (B, S, H) or b.shape != (B, S, H, N) or c.shape != b.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}: need a "
                         f"[B, S, H] and b, c [B, S, H, N]")
    if Q > _SSD_MAX_CHUNK or not 1 <= P <= _SSD_WIDE_MAX or \
            not 1 <= N <= _SSD_WIDE_MAX:
        raise ValueError(f"ssd_scan: the kernels take chunk <= "
                         f"{_SSD_MAX_CHUNK}, P <= {_SSD_WIDE_MAX} and N <= "
                         f"{_SSD_WIDE_MAX}, got chunk {Q}, P={P}, N={N}")
    wide = P > _SSD_MAX_P or N > _SSD_MAX_N
    if B * H >= (1 << 16 if wide else 1 << 31):
        raise ValueError(f"ssd_scan: grid of B*H={B * H} exceeds the "
                         f"launch limit")
    dev = x.device
    for name, t in (("x", x), ("a", a), ("b", b), ("c", c)):
        _check(name, t, torch.float32, dev)
    y = torch.empty_like(x)
    if not wide:
        lib = build.library("ssd_scan")
        err = lib.ssd_scan_launch(_ptr(x), _ptr(a), _ptr(b), _ptr(c),
                                  _ptr(y), B, S, H, P, N, Q, _stream(dev))
    else:
        # the wide kernel takes P and N in whole 64-wide tiles and 16-byte
        # aligned rows: other heads go in zero-padded (zero columns of x,
        # b and c add nothing to y) and y is cut back
        P64, N64 = -(-P // 64) * 64, -(-N // 64) * 64
        xk, bk, ck = _padded(x, P64), _padded(b, N64), _padded(c, N64)
        yk = y if P64 == P else x.new_empty((B, S, H, P64))
        nc = S // Q  # the chunks' carried states, fp32
        states = torch.empty((B, H, nc, P64, N64), dtype=torch.float32,
                             device=dev)
        totals = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
        lib = build.library("ssd_scan_wide")
        err = lib.ssd_scan_wide_launch(
            _ptr(xk), _ptr(a), _ptr(bk), _ptr(ck), _ptr(yk), _ptr(states),
            _ptr(totals), B, S, H, P64, N64, Q, _stream(dev), None)
        if yk is not y:
            y = yk[..., :P].contiguous()
    _launched("ssd_scan", lib, err)
    return y


def _padded(t: torch.Tensor, width: int) -> torch.Tensor:
    """t, or a zero-padded copy of it whose last dim is `width`, where t's
    is narrower or its data is not 16-byte aligned."""
    if t.shape[-1] == width and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(t.shape[:-1] + (width,))
    out[..., :t.shape[-1]] = t
    return out
