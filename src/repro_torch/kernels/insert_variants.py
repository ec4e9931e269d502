"""Time design variants of the dht_insert kernel against the tree's kernel.

    PYTHONPATH=src python -m repro_torch.kernels.insert_variants \
        [--out chiprun_out/insert_variants.json]

On one CUDA card.  Each variant is `csrc/dht_probe.cu` with a few lines
replaced (`VARIANTS`), compiled with the tree's flags into
`_build/variants/` and bound like the tree's library, so `ops.dht_insert`
drives it unchanged:

  * `clock`: the kernel's own clock (`globaltimer`, ns from its start)
    at the end of the streaming pass, of round 1 and of all rounds, in
    extra device counters;
  * `no_solo`: the whole grid runs every round, where the kernel lets
    block 0 run the rounds alone once at most 4096 keys pend;
  * `collapse`: one representative per distinct key runs the rounds.
    Before round 1 every valid key joins its key's group in a scratch
    hash (atomicCAS on the first batch index, key compared through it,
    64 probes, else the key runs alone); the group's highest batch index
    bids for it; after the rounds every other copy takes its
    representative's slot.  Equal keys move in lockstep through the
    rounds, so the table, slots and max_probe are unchanged.

Inputs: the largest dht_insert call at the walk tables and the largest
other call (the seed index) in one `assemble` of `chip_smoke.py`'s path 2
(the same community, reads and plan), and three small cases (90%
duplicated keys, a nearly full table, a table the keys exhaust).  Every
variant's output on every input is held to the plain version bit for
bit; then each variant is timed on each input (median of 20 CUDA-event
timings of the op, 3 passes over the variants in turn).
Prints one line per measurement and, last, one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build, ops

SOURCE = build.CSRC / "dht_probe.cu"

_KERNEL = "__global__ void __launch_bounds__(kInsertThreads, 3)\n"
_NOW_NS = """__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

"""
_LAST_COUNTER = "  X(kAfterFirst, pending_after_round_1)\n"
_STREAM_DONE = "  grid.sync();\n\n  // ---- the rounds ----\n"
_AFTER_ROUND = "      if (r == 0) ctr[kAfterFirst] = left;\n"
_ROUNDS_DONE = ("  // max_probe = max(old, every finished key's probes): one "
                "atomic a block\n")

# variant -> [(text of csrc/dht_probe.cu, its replacement)]; each text
# must occur exactly once
VARIANTS = {
    "clock": [
        (_LAST_COUNTER, _LAST_COUNTER.rstrip("\n")
         + " X(kStreamNs, stream_ns) X(kRound1Ns, round1_ns)"
           " X(kKernelNs, kernel_ns)\n"),
        (_KERNEL, _NOW_NS + _KERNEL),
        ("  const bool stats = blockIdx.x == 0 && tid == 0;  // keeps the "
         "counters\n",
         "  const bool stats = blockIdx.x == 0 && tid == 0;  // keeps the "
         "counters\n  const long long t0 = stats ? now_ns() : 0;\n"),
        (_STREAM_DONE, "  grid.sync();\n  if (stats) ctr[kStreamNs] = "
         "(int32_t)(now_ns() - t0);\n\n  // ---- the rounds ----\n"),
        (_AFTER_ROUND, _AFTER_ROUND
         + "      if (r == 0) ctr[kRound1Ns] = (int32_t)(now_ns() - t0);\n"),
        (_ROUNDS_DONE,
         "  if (stats) ctr[kKernelNs] = (int32_t)(now_ns() - t0);\n"
         + _ROUNDS_DONE),
    ],
    "no_solo": [
        ("constexpr int kSoloKeys = 4 * kTile;",
         "constexpr int kSoloKeys = 0;"),
    ],
    "collapse": [
        (_LAST_COUNTER, _LAST_COUNTER.rstrip("\n") + " X(kCopies, copies)\n"),
        (_KERNEL, """struct Group {   // the scratch hash of distinct keys
  int32_t* first;  // [gcap] batch index of the key that claimed the slot
  int32_t* rep;    // [gcap] highest batch index of the group
  int32_t* gslot;  // [m] each valid key's group slot, -1 = alone
  int32_t* cidx;   // [m] copies: batch index
  int32_t* cg;     // [m] ... and group slot
  uint32_t gmask;
};

// Position of this lane's entry in a list whose count is *ctr: one
// atomic a warp.  Every lane of the warp calls it.
__device__ __forceinline__ int warp_append(bool pred, int32_t* ctr) {
  const unsigned m = __ballot_sync(0xffffffffu, pred);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(ctr, __popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  return base + __popc(m & ((1u << lane) - 1));
}

""" + _KERNEL),
        ("                  Worklist bids, int32_t* ctr) {\n",
         "                  Worklist bids, int32_t* ctr, Group grp) {\n"),
        ("    if (stats) *max_probe = *in.max_probe;\n",
         "    for (long long a = first; a <= grp.gmask; a += stride)\n"
         "      grp.first[a] = -1, grp.rep[a] = -1;\n"
         "    if (stats) *max_probe = *in.max_probe;\n"),
        (_STREAM_DONE, """  grid.sync();

  // ---- collapse: group the valid keys (list 0) by key ----
  const long long gstride = (long long)gridDim.x * kInsertThreads;
  const long long nv = __ldcg(ctr + kList);
  for (long long e = (long long)blockIdx.x * kInsertThreads + tid; e < nv;
       e += gstride) {
    const int32_t i = __ldcg(list0.idx + e);
    const uint32_t h = khi[i], l = klo[i];
    uint32_t g = (repro::kmer_hash(h, l) * 2654435761u) & grp.gmask;
    int32_t gs = -1;
    for (int p = 0; p < 64; ++p, g = (g + 1) & grp.gmask) {
      int32_t c = __ldcg(grp.first + g);
      if (c < 0) c = atomicCAS(grp.first + g, -1, i);
      if (c < 0 || (khi[c] == h && klo[c] == l)) {
        gs = (int32_t)g;
        break;
      }
    }
    grp.gslot[e] = gs;
    if (gs >= 0 && __ldcg(grp.rep + gs) < i) atomicMax(grp.rep + gs, i);
  }
  grid.sync();
  // representatives (and keys alone) to list 1, the rounds' first list;
  // the other copies to the copies list
  for (long long b = (long long)blockIdx.x * kInsertThreads; b < nv;
       b += gstride) {
    const long long e = b + tid;
    const bool live = e < nv;
    const int32_t i = live ? __ldcg(list0.idx + e) : 0;
    const int32_t gs = live ? __ldcg(grp.gslot + e) : -1;
    const bool rep = live && (gs < 0 || __ldcg(grp.rep + gs) == i);
    const int pr = warp_append(rep, ctr + kList + 1);
    const int pc = warp_append(live && !rep, ctr + kCopies);
    if (rep) list1.idx[pr] = i;
    if (live && !rep) grp.cidx[pc] = i, grp.cg[pc] = gs;
  }
  grid.sync();

  // ---- the rounds ----
"""),
        ("  for (long long r = 0;; ++r) {\n", "  for (long long r = 1;; ++r) {\n"),
        ("        if (r == 0) {  // list 0 holds no slots",
         "        if (r == 1) {  // list 0 holds no slots"),
        (_AFTER_ROUND, "      if (r == 1) ctr[kAfterFirst] = left;\n"),
        ("      ctr[kRounds] = (int32_t)(r + 1);\n",
         "      ctr[kRounds] = (int32_t)r;\n"),
        (_ROUNDS_DONE, """  grid.sync();  // every representative's slot is written
  {
    const long long nc = __ldcg(ctr + kCopies);
    for (long long e = (long long)blockIdx.x * kInsertThreads + tid; e < nc;
         e += (long long)gridDim.x * kInsertThreads)
      slots[grp.cidx[e]] = __ldcg(slots + __ldcg(grp.rep + grp.cg[e]));
  }
""" + _ROUNDS_DONE),
        ("  int32_t* ctr = (int32_t*)counters;\n",
         """  int32_t* ctr = (int32_t*)counters;
  // the group scratch, kept from call to call and grown on demand
  static void* scratch = nullptr;
  static size_t scratch_bytes = 0;
  long long gcap = 1024;
  while (gcap < 2 * m && gcap < (1 << 22)) gcap *= 2;
  const size_t need = (size_t)(2 * gcap + 3 * m) * sizeof(int32_t);
  if (need > scratch_bytes) {
    cudaFree(scratch);
    err = cudaMalloc(&scratch, need);
    if (err != cudaSuccess) return (int)err;
    scratch_bytes = need;
  }
  int32_t* gs = (int32_t*)scratch;
  Group grp{gs, gs + gcap, gs + 2 * gcap, gs + 2 * gcap + m,
            gs + 2 * gcap + 2 * m, (uint32_t)(gcap - 1)};
"""),
        ("(void*)&w1, (void*)&wb, (void*)&ctr};",
         "(void*)&w1, (void*)&wb, (void*)&ctr, (void*)&grp};"),
    ],
}


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise AssertionError(f"variant {name}: {old[:60]!r} occurs "
                                 f"{src.count(old)} times in {SOURCE.name}")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """{variant: ctypes library}, one nvcc each, in parallel."""
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = out / f"dht_probe_{name}.cu"
        cu.write_text(variant_source(name))
        so = out / f"dht_probe_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        regs = {fn: r for fn, r in build.ptxas_report(text).items()
                if "insert_kernel" in fn}
        print(f"variant {name}: ptxas {regs}", flush=True)
        libs[name] = build._bind("dht_probe", so)
    return libs


@contextlib.contextmanager
def using(lib):
    """`ops.dht_insert` through library `lib` inside the block."""
    real = build.library
    build.library = lambda name: lib if name == "dht_probe" else real(name)
    try:
        yield
    finally:
        build.library = real


def median_ms(fn, reps=20, warmup=2) -> float:
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


def path_calls() -> dict:
    """{'seed_index', 'walk'}: the largest dht_insert calls of path 2."""
    from repro_torch.api import Assembler, AssemblyPlan, Local
    from repro_torch.data import mgsim

    comm = mgsim.sample_community(0, num_genomes=20,
                                  genome_len=(10_000, 30_000),
                                  strain_pairs=4)
    reads, _ = mgsim.generate_reads(1, comm, num_pairs=75_000,
                                    read_len=150, insert_mean=400,
                                    insert_sd=30, err_rate=0.002)
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.1)
    calls, orig = {}, ops.dht_insert

    def record(*args, **kw):
        row = "walk" if args[0].numel() == plan.walk_capacity \
            else "seed_index"
        if row not in calls or args[4].numel() > calls[row][4].numel():
            calls[row] = args
        return orig(*args, **kw)

    ops.dht_insert = record
    try:
        Assembler(plan, Local()).assemble(reads)
    finally:
        ops.dht_insert = orig
    torch.cuda.synchronize()
    return calls


def small_cases(dev) -> dict:
    from repro_torch.core import dht

    rng = np.random.default_rng(0)
    cases = {}
    for name, n, cap, dup in (("dup90", 200_000, 1 << 18, 0.9),
                              ("nearly_full", 16_000, 1 << 14, 0.0),
                              ("exhaust", 3000, 1 << 10, 0.1)):
        vals = rng.integers(0, 1 << 40, size=n, dtype=np.int64)
        d = rng.random(n) < dup
        vals[d] = vals[rng.integers(0, n, size=int(d.sum()))]
        hi = torch.from_numpy((vals >> 32).astype(np.int32)).to(dev)
        lo = torch.from_numpy((vals & 0xFFFFFFFF).astype(np.uint32).view(
            np.int32)).to(dev)
        valid = torch.from_numpy(rng.random(n) < 0.95).to(dev)
        cases[name] = (*dht.empty_table(cap, dev), hi, lo, valid)
    return cases


def same(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("insert_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = {"tree": build.library("dht_probe"), **build_variants()}
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    inputs = {**path_calls(), **small_cases(dev)}
    result = {"card": card, "inputs": {}, "ms": {}, "counters": {}}
    for row, a in inputs.items():
        result["inputs"][row] = dict(rows=a[4].numel(), cap=a[0].numel(),
                                     valid=int(a[6].sum()))
        want = ops.dht_insert(*a, backend="torch")
        for name, lib in libs.items():
            with using(lib):
                got = ops.dht_insert(*a)
            if not same(got, want):
                raise AssertionError(f"variant {name} != plain on {row}")
            result["counters"][f"{row}/{name}"] = dict(ops.LAST_INSERT)
            print(f"{row} {result['inputs'][row]} {name}: equal to plain; "
                  f"counters {ops.LAST_INSERT}", flush=True)
        del want

    for row, a in inputs.items():
        times = {name: [] for name in libs}
        for _ in range(3):
            for name, lib in libs.items():
                with using(lib):
                    times[name].append(median_ms(lambda: ops.dht_insert(*a)))
        for name, ts in times.items():
            result["ms"][f"{row}/{name}"] = ts
            print(f"{row} {name}: op ms {ts} (median of 20, 3 passes)",
                  flush=True)
    print(card, flush=True)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
