"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py [--num-pairs N]

Drives the port's main path, Algorithm 1 (`Assembler.contig_rounds`, no
local assembly), on a virome-like community: 160 genomes of 10-30 kbp (10
of them 1%-divergent strains), 600k reads of 2 x 150 bp at ~30x mean
coverage.  Steps:

  1. card name and power limit (nvidia-smi);
  2. build the four CUDA kernels from src/repro_torch/kernels/csrc;
  3. make the reads (host numpy, timed apart);
  4. run contig_rounds with the kernels, launch counts reset just before
     and read just after: each kernel must have launched; the first
     round's traversal against contig_cap and max_contig_len; then once
     more under torch.profiler (device time by operator, busy share);
  5. hold each kernel against its plain PyTorch version on the card, on
     the inputs of its largest call in a third run, bit for bit, and time
     both (CUDA events, median of 20 after 2 warm-ups);
  6. run contig_rounds with the plain versions (backend "torch") on the
     card: contigs, alive and alignments must equal step 4;
  7. a small community on the card against the same run on the CPU.

Any failure raises (non-zero exit, no result).  The line before the last
is one JSON object with a record per kernel; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# name -> (kernel source, TPU kernel it replaces)
KERNELS = {
    "kmer_extract": ("src/repro_torch/kernels/csrc/kmer_extract.cu",
                     "src/repro/kernels/kmer_extract.py:155"),
    "dht_lookup": ("src/repro_torch/kernels/csrc/dht_probe.cu",
                   "src/repro/kernels/dht_probe.py:88"),
    "dht_insert": ("src/repro_torch/kernels/csrc/dht_probe.cu",
                   "src/repro/kernels/dht_probe.py:183"),
    "seed_probe": ("src/repro_torch/kernels/csrc/seed_probe.cu",
                   "src/repro/kernels/seed_probe.py:198"),
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12    # H100 SXM 32-bit rate outside the tensor cores
# floor on the aligned read share and on the share of long contigs that are
# verbatim genome substrings: a sanity gate against garbage, not a target
MIN_QUALITY = 0.5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def median_ms(fn, reps=20, warmup=2) -> float:
    """Median of `reps` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class Recorder:
    """Wraps the ops wrappers to keep the arguments of each kernel's
    largest call (by elements of its first tensor) in the main path."""

    def __init__(self, ops):
        self.ops = ops
        self.calls = {}
        self.orig = {name: getattr(ops, name) for name in KERNELS}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)

    def _wrap(self, name, fn):
        def call(*args, **kw):
            size = args[4 if name.startswith("dht") else 0].numel()
            if name not in self.calls or size > self.calls[name][0]:
                self.calls[name] = (size, args, {
                    k: v for k, v in kw.items() if k != "backend"})
            return fn(*args, **kw)
        return call


def max_abs_err(got, want) -> float:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return float(err)


def bound(name, args, kw, ops) -> tuple:
    """(bound_ms, bound_by): the larger of bytes / HBM rate and
    operations / scalar rate, for the work these inputs need."""
    if name == "kmer_extract":
        bases, lengths = args
        R, L = bases.shape
        k = kw["k"]
        W = L - k + 1
        nbytes = R * L * (1 + 16) + 4 * R
        nops = R * W * (3 * k + 34)
    elif name == "dht_lookup":
        valid = args[6] if len(args) > 6 else kw.get("valid")
        n = args[4].numel()
        n_valid = n if valid is None else int(valid.sum())
        nbytes = 13 * n + 9 * n_valid + 4
        nops = n_valid * 40
    elif name == "dht_insert":
        cap, n = args[0].numel(), args[4].numel()
        nbytes = 13 * n + 18 * cap + 8
        nops = int(args[6].sum()) * 40
    else:  # seed_probe
        bases, lengths = args[0], args[1]
        t = args[2:6]
        R, L = bases.shape
        seed_len, positions = kw["seed_len"], kw["positions"]
        lanes = ops.kmer_extract(bases, lengths, k=seed_len, backend="torch")
        cols = torch.tensor(positions, device=bases.device)
        valid = lanes.valid[:, cols]
        slots = ops.dht_lookup(*t, lanes.hi[:, cols].contiguous(),
                               lanes.lo[:, cols].contiguous(),
                               valid.contiguous(), backend="torch")
        n_valid, n_hit = int(valid.sum()), int((slots >= 0).sum())
        S = len(positions)
        nbytes = R * L + 4 * R + R * 2 * 9 + 9 * n_valid + 10 * n_hit
        nops = R * S * (3 * seed_len + 40) + R * S * S * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def n50(lengths) -> int:
    ls = np.sort(lengths)[::-1]
    if not len(ls):
        return 0
    c = np.cumsum(ls)
    return int(ls[np.searchsorted(c, c[-1] / 2)])


def run_rounds(Assembler, Local, plan, reads, label):
    """contig_rounds with per-round wall times (synchronized)."""
    asm = Assembler(plan, Local())
    gen = asm.contig_rounds_iter(reads)
    times = []
    t0 = time.perf_counter()
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            out = stop.value
            break
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        t0 = t1
    for s, t in zip(out[3], times):
        log(f"[{label}] round k={s.k}: {t:.3f} s, n_kmers={s.n_kmers}, "
            f"n_contigs={s.n_contigs}, aligned_frac={s.aligned_frac:.4f}, "
            f"bubbles={s.n_bubbles}, hair={s.n_hair}, pruned={s.n_pruned}, "
            f"overflow={s.overflow}")
    return out, times, asm.ctx.overflow()


def profile_rounds(Assembler, Local, plan, reads, top=12):
    """Device time over one contig_rounds: the device's busy share of the
    wall time (one stream, so kernels do not overlap), then the kernels
    and the PyTorch operators that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        Assembler(plan, Local()).contig_rounds(reads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"profiled contig_rounds: wall {wall:.3f} s, device busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%, idle "
        f"{100 * (1 - busy / wall):.1f}%)")
    operators = [e for e in events if e.device_type == DeviceType.CPU
                 and e.self_device_time_total > 0]
    for title, rows in (("kernels", kernels), ("operators", operators)):
        log(f"  top {title} by device time:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"  {e.self_device_time_total / 1e3:10.2f} ms "
                f"{e.count:7d} calls  {e.key[:100]}")


def assert_same(a, b, what):
    la = a if isinstance(a, tuple) else (a,)
    lb = b if isinstance(b, tuple) else (b,)
    for x, y in zip(la, lb):
        if x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what} differ")


def genome_matches(contigs, alive, comm, top=200) -> float:
    """Share of the `top` longest live contigs found verbatim in a genome
    (either strand)."""
    lens = contigs.lengths.cpu().numpy() * alive.cpu().numpy()
    order = np.argsort(lens)[::-1][:top]
    order = order[lens[order] > 0]
    if not len(order):
        return 0.0
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    genomes = [g.tobytes() for g in comm.genomes]
    genomes += [comp[g[::-1]].tobytes() for g in comm.genomes]
    bases = contigs.bases[torch.from_numpy(order.copy()).to(
        contigs.bases.device)].cpu().numpy()
    hits = sum(any(bases[i, :lens[c]].tobytes() in g for g in genomes)
               for i, c in enumerate(order))
    return hits / len(order)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-pairs", type=int, default=300_000,
                    help="read pairs to simulate (default 300000)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; this script measures the "
              "port on the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Assembler, AssemblyPlan, Local
    from repro_torch.core import dbg
    from repro_torch.core.kmer_analysis import ExtensionPolicy
    from repro_torch.data import mgsim
    from repro_torch.kernels import build, ops

    card = card_line()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    build.build_all()
    rep = build.last_build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc, parallel: {rep.get('compiled')})")
    for line in rep.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    t0 = time.perf_counter()
    comm = mgsim.sample_community(0, num_genomes=150,
                                  genome_len=(10_000, 30_000),
                                  strain_pairs=10)
    reads, _ = mgsim.generate_reads(1, comm, num_pairs=args.num_pairs,
                                    read_len=150, insert_mean=400,
                                    insert_sd=30, err_rate=0.002)
    content = sum(len(g) for g in comm.genomes)
    log(f"data: {len(comm.genomes)} genomes, {content} bp, "
        f"{reads.num_reads} reads x {reads.max_len} bp "
        f"({reads.num_reads * reads.max_len / content:.1f}x), "
        f"generated in {time.perf_counter() - t0:.1f} s on the host")
    if args.num_pairs != 300_000:
        log(f"CUT: num_pairs {args.num_pairs} instead of 300000")

    plan = AssemblyPlan.from_dataset(
        reads, (21, 31, 10), unique_rate=0.1, run_local_assembly=False,
        contig_cap=1 << 13, max_contig_len=1 << 15,
    )
    log(f"plan: ks={plan.ks()} kmer_capacity={plan.kmer_capacity} "
        f"seed_cap={plan.seed_cap} contig_cap={plan.contig_cap} "
        f"max_contig_len={plan.max_contig_len} "
        f"plan.bytes()={plan.bytes() / 1e9:.2f} GB")

    # ---- main path with the kernels (clean: no recorder, no profiler) ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (contigs, alive, al, stats), times, ovf = run_rounds(
        Assembler, Local, plan, reads, "kernels")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"launches in contig_rounds: {launches}")
    log(f"peak device memory: {peak / 1e9:.2f} GB; overflow: {ovf}")
    missing = [n for n in KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if ovf.get("kmer_table"):
        raise AssertionError(f"k-mer table overflow: {ovf}")
    live = alive.cpu().numpy()
    clens = contigs.lengths.cpu().numpy()[live]
    if not (live.sum() > 0 and torch.isfinite(contigs.depths).all()
            and contigs.bases.shape == (plan.contig_cap, plan.max_contig_len)
            and al.contig.shape == (reads.num_reads, 2)):
        raise AssertionError("contig_rounds output has the wrong shape or "
                             "non-finite depths")
    frac = genome_matches(contigs, alive, comm)
    log(f"contigs: {int(live.sum())} live, {int(clens.sum())} bp, "
        f"N50 {n50(clens)}, longest {int(clens.max())}; "
        f"aligned_frac {stats[-1].aligned_frac:.4f}; "
        f"{frac:.3f} of the 200 longest are verbatim genome substrings")
    if stats[-1].aligned_frac < MIN_QUALITY or frac < MIN_QUALITY:
        raise AssertionError("assembly quality collapsed")

    # ---- the traversal's overflow flag, first round: more chains than
    # contig_cap, or a chain longer than max_contig_len? ----
    ctx = Local()
    ctx.prepare(reads, plan)
    kset, _ = ctx.kmer_set(plan.k_min, None)
    trav = dbg.traverse(kset, dbg.build_index(kset), k=plan.k_min,
                        contig_cap=plan.contig_cap,
                        max_len=plan.max_contig_len)
    log(f"round k={plan.k_min} traversal: {int(trav.n_contigs)} chains "
        f"(contig_cap {plan.contig_cap}), longest "
        f"{int(trav.node_pos.max()) + plan.k_min} bp (max_contig_len "
        f"{plan.max_contig_len})")
    del ctx, kset, trav

    # ---- where the time goes: one profiled run ----
    profile_rounds(Assembler, Local, plan, reads)

    # ---- the inputs of each kernel's largest call (a warm run) ----
    with Recorder(ops) as rec:
        t0 = time.perf_counter()
        Assembler(plan, Local()).contig_rounds(reads)
        torch.cuda.synchronize()
        log(f"warm contig_rounds (recording inputs): "
            f"{time.perf_counter() - t0:.3f} s")

    # ---- each kernel against its plain version, at the main path's shapes
    records = []
    for name, (source, replaces) in KERNELS.items():
        _, cargs, ckw = rec.calls[name]
        fn = getattr(ops, name)
        got = fn(*cargs, **ckw)
        want = fn(*cargs, **ckw, backend="torch")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {err})")
        ms = median_ms(lambda: fn(*cargs, **ckw))
        plain_ms = median_ms(lambda: fn(*cargs, **ckw, backend="torch"))
        b_ms, b_by = bound(name, cargs, ckw, ops)
        shapes = [tuple(a.shape) for a in cargs if torch.is_tensor(a)]
        log(f"{name}: equal to plain (tolerance 0), inputs {shapes}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
    del rec

    # ---- the same path with the plain versions on the card ----
    plain_plan = dataclasses.replace(plan, kernel_backend="torch")
    ops.reset_launches()
    (p_contigs, p_alive, p_al, p_stats), p_times, _ = run_rounds(
        Assembler, Local, plain_plan, reads, "plain")
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"plain run launched kernels: {ops.LAUNCHES}")
    assert_same(contigs, p_contigs, "contigs (kernels vs plain)")
    assert_same(alive, p_alive, "alive (kernels vs plain)")
    assert_same(al, p_al, "alignments (kernels vs plain)")
    if [dataclasses.asdict(s) for s in stats] != \
            [dataclasses.asdict(s) for s in p_stats]:
        raise AssertionError("iteration stats differ (kernels vs plain)")
    log(f"plain path: identical contigs, alive, alignments, stats; "
        f"{sum(p_times):.3f} s vs kernels {sum(times):.3f} s")

    # ---- small input: card against the CPU run ----
    small_plan = AssemblyPlan(
        k_min=17, k_max=21, k_step=4, kmer_capacity=1 << 14, contig_cap=256,
        max_contig_len=2048, policy=ExtensionPolicy(err_rate=0.05),
        run_local_assembly=False)
    s_comm = mgsim.sample_community(41, num_genomes=2, genome_len=300,
                                    abundance_sigma=0.3)
    s_reads, _ = mgsim.generate_reads(42, s_comm, num_pairs=300,
                                      read_len=60, err_rate=0.003)
    g = Assembler(small_plan, Local()).contig_rounds(s_reads)
    c = Assembler(small_plan, Local("cpu")).contig_rounds(s_reads)
    for x, y, what in zip(g[:3], c[:3], ("contigs", "alive", "alignments")):
        assert_same(x, y, f"small input {what} (card vs CPU)")
    if g[3] != c[3]:
        raise AssertionError("small input stats differ (card vs CPU)")
    log("small input: card run equals the CPU run")

    log(card)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
