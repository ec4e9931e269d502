"""Time design variants of the dht_lookup and mer_walk kernels against the
tree's kernels, in device time over every call of paths 1-3.

    PYTHONPATH=src python -m repro_torch.kernels.probe_variants \
        [--out chiprun_out/probe_variants.json]

On one CUDA card.  Each variant is the tree's `csrc/common.cuh` and
`csrc/dht_probe.cu` or `csrc/mer_walk.cu` with a few lines replaced
(`VARIANTS`), compiled with the tree's flags into
`_build/variants/probe_<variant>/` and bound like the tree's library, so
`ops.dht_lookup` and `ops.mer_walk` drive it unchanged:

  * `thread` (dht_lookup): one thread a query, each probe step's used,
    slot_hi and slot_lo loaded together, max_probe read a thread; the
    tree's kernel streams a tile of 512 rows a warp, probes only the
    tile's valid rows, 4 in flight a lane, and reads max_probe once a
    block;
  * `ldg` (dht_lookup, mer_walk): a probe step's loads (and the walk's
    histogram row) as `__ldg` loads that the compiler places, where the
    tree issues them as one volatile asm statement of `ld.global.nc`
    loads.

Inputs: every dht_lookup and mer_walk call of paths 1-3 of
`chip_smoke.py` (its community, reads and plans: `contig_rounds`,
`assemble`, and `assemble_stream` with gapped alignment over the reads
in memory).  Every variant's output on every call is held to the plain
version bit for bit.  Then, in 3 passes over the variants (the second in
reverse order), each variant runs every call of a path and op once to
warm up, then each 5 times in turn in one torch.profiler session; a
call's device time is the mean of its 5 kernels' (a session that lost
kernels' records is run again).  A path's total is the sum over its
calls of the median of the 3 passes.
Prints one line per measurement and, last, one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build, ops

_LOAD_ASM = """  unsigned short u;
  uint32_t h, l;
  asm volatile(
      "ld.global.nc.u8 %0, [%3];\\n\\t"
      "ld.global.nc.u32 %1, [%4];\\n\\t"
      "ld.global.nc.u32 %2, [%5];"
      : "=h"(u), "=r"(h), "=r"(l)
      : "l"(used + a), "l"(slot_hi + a), "l"(slot_lo + a));
  return make_uint3(u, h, l);
"""
_ROW_ASM = """  unsigned short u;
  uint32_t h, l;
  int4 v;
  asm volatile(
      "ld.global.nc.u8 %0, [%7];\\n\\t"
      "ld.global.nc.u32 %1, [%8];\\n\\t"
      "ld.global.nc.u32 %2, [%9];\\n\\t"
      "ld.global.nc.v4.s32 {%3, %4, %5, %6}, [%10];"
      : "=h"(u), "=r"(h), "=r"(l), "=r"(v.x), "=r"(v.y), "=r"(v.z),
        "=r"(v.w)
      : "l"(used + a), "l"(slot_hi + a), "l"(slot_lo + a), "l"(rows + a));
  *row = v;
  return slot_match(u, h, l, khi, klo);
"""
_LDG = {
    "common.cuh": [
        (_LOAD_ASM, "  return make_uint3(__ldg(used + a), __ldg(slot_hi + a), "
                    "__ldg(slot_lo + a));\n"),
        (_ROW_ASM, """  const uint3 v = slot_load(slot_hi, slot_lo, used, a);
  *row = __ldg(rows + a);
  return slot_match(v.x, v.y, v.z, khi, klo);
"""),
    ],
}
_COUNT_KERNEL = "// Valid rows of the batch: four 16-byte loads a thread"
_LOOKUP_GRID = """  const long long tiles = (n + kTileRows - 1) / kTileRows;
  const long long blocks = (tiles + kLookupWarps - 1) / kLookupWarps;
  lookup_kernel<<<(unsigned)blocks, kLookupThreads, 0,
"""
_THREAD = {
    "dht_probe.cu": [
        (_COUNT_KERNEL, """__global__ void lookup_thread_kernel(
    const uint32_t* __restrict__ slot_hi, const uint32_t* __restrict__ slot_lo,
    const uint8_t* __restrict__ used, const int32_t* __restrict__ max_probe,
    uint32_t cap_mask, const uint32_t* __restrict__ qhi,
    const uint32_t* __restrict__ qlo, const uint8_t* __restrict__ qvalid,
    long long n, int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t result = -1;
  if (qvalid[i]) {
    const uint32_t khi = qhi[i], klo = qlo[i];
    const int32_t bound = __ldg(max_probe) + 1;
    uint32_t a = repro::kmer_hash(khi, klo) & cap_mask;
    for (int32_t step = 0; step <= bound; ++step) {
      const uint3 v = repro::slot_load(slot_hi, slot_lo, used, a);
      const int s = repro::slot_match(v.x, v.y, v.z, khi, klo);
      if (s == repro::kSlotKey) result = (int32_t)a;
      if (s != repro::kSlotNext) break;
      a = (a + 1) & cap_mask;
    }
  }
  out[i] = result;
}

""" + _COUNT_KERNEL),
        (_LOOKUP_GRID, """  const long long blocks = (n + kThreads - 1) / kThreads;
  lookup_thread_kernel<<<(unsigned)blocks, kThreads, 0,
"""),
    ],
}

# variant -> {library: {file of csrc/: [(text, its replacement)]}}; each
# text must occur exactly once in its file
VARIANTS = {
    "thread": {"dht_probe": _THREAD},
    "ldg": {"dht_probe": _LDG, "mer_walk": _LDG},
}
OPS = {"dht_probe": "dht_lookup", "mer_walk": "mer_walk"}
KERNEL_RE = {"dht_probe": r"lookup\w*_kernel", "mer_walk": r"mer_walk_kernel"}


def variant_sources(name: str, lib: str) -> dict:
    """{file name: text} of library `lib` in variant `name`."""
    patches = VARIANTS[name][lib]
    files = {}
    for fname in ("common.cuh", f"{lib}.cu"):
        src = (build.CSRC / fname).read_text()
        for old, new in patches.get(fname, ()):
            if src.count(old) != 1:
                raise AssertionError(f"variant {name}: {old[:60]!r} occurs "
                                     f"{src.count(old)} times in {fname}")
            src = src.replace(old, new)
        files[fname] = src
    return files


def build_variants() -> dict:
    """{(variant, library): ctypes library}, one nvcc each, in parallel."""
    procs = {}
    for name, libs in VARIANTS.items():
        out = build.BUILD_DIR / "variants" / f"probe_{name}"
        out.mkdir(parents=True, exist_ok=True)
        for lib in libs:
            for fname, text in variant_sources(name, lib).items():
                (out / fname).write_text(text)
            so = out / f"{lib}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                   str(out / f"{lib}.cu")]
            procs[name, lib] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    built = {}
    for (name, lib), (proc, so) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{lib}:\n{text}")
        regs = {fn: r for fn, r in build.ptxas_report(text).items()
                if re.search(KERNEL_RE[lib], fn)}
        print(f"variant {name}/{lib}: ptxas {regs}", flush=True)
        built[name, lib] = build._bind(lib, so)
    return built


@contextlib.contextmanager
def using(lib_name, lib):
    """The ops of library `lib_name` through `lib` inside the block."""
    real = build.library
    build.library = lambda n: lib if n == lib_name else real(n)
    try:
        yield
    finally:
        build.library = real


def load_groups(so, kernel_re, dump=None) -> dict:
    """{kernel: [LDGs a group, in code order]} of the kernels named by
    `kernel_re` in the SASS of library file `so` (`cuobjdump -sass`): a
    group is a run of LDG instructions with no compare (ISETP) and no
    branch (BRA) between them, so loads in one group go out before any
    of them is tested.  `dump`: also write the SASS to this file."""
    sass = subprocess.run([build._tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    if dump:
        Path(dump).write_text(sass)
    groups, fn, run = {}, None, 0
    op_re = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9]+)")
    for line in sass.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if fn is not None and run:
                groups[fn].append(run)
            fn, run = m.group(1), 0
            groups[fn] = []
            continue
        m = op_re.search(line)
        if not m:
            continue
        if m.group(1) == "LDG":
            run += 1
        elif m.group(1) in ("ISETP", "BRA") and run:
            groups[fn].append(run)
            run = 0
    names = build._demangle([f for f in groups if f != "end"])
    return {names[f]: g for f, g in groups.items()
            if f != "end" and re.search(kernel_re, names[f])}


# profiler sessions that lost kernels' records and were run again: the
# number of kernels each recorded
LOST = []


def device_ms(fns, kernel_re, reps=5, tries=3) -> list:
    """Device time a call of each fn() in `fns`, of the kernels named by
    `kernel_re` (one a call): each fn once to warm up, then, in one
    torch.profiler session, each fn `reps` times in turn; the kernels'
    records in launch order give each fn its mean.  A session that
    records another number of those kernels is run again, at most
    `tries` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        ks = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and re.search(kernel_re, e.name)),
                    key=lambda e: e.time_range.start)
        if len(ks) == reps * len(fns):
            us = [e.time_range.elapsed_us() for e in ks]
            return [sum(us[reps * j:reps * (j + 1)]) / 1e3 / reps
                    for j in range(len(fns))]
        LOST.append(len(ks))
    raise AssertionError(f"{kernel_re}: {len(ks)} kernels in "
                         f"{reps * len(fns)} calls, {tries} sessions")


def path_calls() -> dict:
    """{path: [(library, args, kw), ...]}: every dht_lookup and mer_walk
    call of paths 1-3, in order."""
    from repro_torch.api import Assembler, AssemblyPlan, Local
    from repro_torch.data import mgsim
    from repro_torch.stream import batches_from_readset

    comm = mgsim.sample_community(0, num_genomes=20,
                                  genome_len=(10_000, 30_000),
                                  strain_pairs=4)
    reads, _ = mgsim.generate_reads(1, comm, num_pairs=75_000,
                                    read_len=150, insert_mean=400,
                                    insert_sd=30, err_rate=0.002)
    content = sum(len(g) for g in comm.genomes)
    runs = {
        "path1": lambda: Assembler(AssemblyPlan.from_dataset(
            reads, (17, 21, 4), unique_rate=0.1, run_local_assembly=False),
            Local()).contig_rounds(reads),
        "path2": lambda: Assembler(AssemblyPlan.from_dataset(
            reads, (17, 21, 4), unique_rate=0.1), Local()).assemble(reads),
        "path3": lambda: Assembler(AssemblyPlan.from_stream(
            32768, reads.max_len, (17, 21, 4), unique_kmers=content,
            gapped_align=True), Local()).assemble_stream(
                batches_from_readset(reads, 32768)),
    }
    calls = {}
    real = {lib: getattr(ops, op) for lib, op in OPS.items()}
    for path, run in runs.items():
        calls[path] = []

        def recorder(lib):
            def record(*args, **kw):
                calls[path].append((lib, args, {k: v for k, v in kw.items()
                                                if k != "backend"}))
                return real[lib](*args, **kw)
            return record

        for lib, op in OPS.items():
            setattr(ops, op, recorder(lib))
        try:
            run()
        finally:
            for lib, op in OPS.items():
                setattr(ops, op, real[lib])
        torch.cuda.synchronize()
    return calls


def describe(lib, args, kw) -> dict:
    if lib == "dht_probe":
        valid = args[6] if len(args) > 6 and args[6] is not None else None
        return dict(rows=args[4].numel(), cap=args[0].numel(),
                    valid=args[4].numel() if valid is None
                    else int(valid.sum()))
    return dict(walkers=args[1].numel(), active=int(args[4].sum()),
                seed_len=kw.get("seed_len", 0))


def same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--sass", help="also write each build's SASS into "
                    "this directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = {lib: {"tree": build.library(lib)} for lib in OPS}
    for (name, lib), so in build_variants().items():
        libs[lib][name] = so
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    result = {"card": card, "load_groups": {}, "calls": {}, "device_ms": {},
              "totals": {}}
    if args.sass:
        Path(args.sass).mkdir(parents=True, exist_ok=True)
    for lib, builds in libs.items():
        for name, so in builds.items():
            dump = args.sass and str(Path(args.sass) / f"{lib}_{name}.sass")
            for fn, g in load_groups(so._name, KERNEL_RE[lib], dump).items():
                result["load_groups"][f"{lib}/{name}/{fn}"] = g
                print(f"{lib} {name} {fn[:60]}: LDGs a group "
                      f"(no ISETP or BRA between) {g}", flush=True)

    calls = path_calls()
    for path, cs in calls.items():
        for i, (lib, a, kw) in enumerate(cs):
            row = f"{path}/{i}"
            op = getattr(ops, OPS[lib])
            result["calls"][row] = dict(op=OPS[lib], **describe(lib, a, kw))
            want = op(*a, **kw, backend="torch")
            for name, so in libs[lib].items():
                with using(lib, so):
                    if not same(op(*a, **kw), want):
                        raise AssertionError(f"{name} != plain on {row}")
            print(f"{row} {result['calls'][row]}: every variant equal to "
                  f"plain", flush=True)
            del want

    for path, cs in calls.items():
        for lib, op_name in OPS.items():
            rows = [i for i, c in enumerate(cs) if c[0] == lib]
            if not rows:
                continue
            op = getattr(ops, op_name)
            fns = [lambda a=cs[i][1], kw=cs[i][2], op=op: op(*a, **kw)
                   for i in rows]
            names = list(libs[lib])
            times = {name: [] for name in names}
            for order in (names, names[::-1], names):
                for name in order:
                    with using(lib, libs[lib][name]):
                        times[name].append(device_ms(fns, KERNEL_RE[lib]))
            for j, i in enumerate(rows):
                row = f"{path}/{i}"
                for name in names:
                    result["device_ms"][f"{row}/{name}"] = [
                        ts[j] for ts in times[name]]
                print(f"{row} {result['calls'][row]}: device ms a call "
                      + "; ".join(f"{n} " + ", ".join(
                          f"{ts[j]:.4f}" for ts in times[n]) for n in names),
                      flush=True)
    for path, cs in calls.items():
        for lib, op_name in OPS.items():
            rows = [i for i, c in enumerate(cs) if c[0] == lib]
            if not rows:
                continue
            for name in libs[lib]:
                per = [result["device_ms"][f"{path}/{i}/{name}"]
                       for i in rows]
                total = sum(float(np.median(ts)) for ts in per)
                passes = [sum(ts[p] for ts in per) for p in range(3)]
                result["totals"][f"{path}/{op_name}/{name}"] = dict(
                    calls=len(rows), device_ms=total, passes=passes)
                print(f"{path} {op_name} {name}: {len(rows)} calls, device "
                      f"{total:.4f} ms (passes "
                      f"{', '.join(f'{t:.4f}' for t in passes)})",
                      flush=True)
    result["lost_sessions"] = LOST
    print(f"profiler sessions run again: {len(LOST)} (kernels they "
          f"recorded: {LOST})", flush=True)
    print(card, flush=True)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
