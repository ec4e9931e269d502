"""Time a design variant of the seed_probe kernel against the tree's kernel.

    PYTHONPATH=src python -m repro_torch.kernels.align_variants \
        [--out align_variants.json]

On one CUDA card.  The variant `packed` is `csrc/seed_probe.cu` with a few
lines replaced (`VARIANTS`): a kernel packs the seed index into one
16-byte record a slot, {slot_hi, slot_lo, contig, pos << 3 | multi << 2 |
flip << 1 | used}, built once for each index (`seed_record_launch`), and
the probe reads one record a step, a hit's side data with it, where the
tree's kernel reads `used`, `slot_hi` and `slot_lo`, then four side
arrays.  `seed_probe_use_record` points the variant's launcher at a
record, so `ops.seed_probe` drives it unchanged.

Inputs: every seed_probe call of `chip_smoke.py`'s paths 1-3 on its
community (150k reads of 150 bp): path 1 `contig_rounds` without local
assembly, path 2 `assemble`, path 3 `assemble_stream` with gapped
alignment over the reads in batches of 32768 (from memory, not from a
FASTQ file: the same batches).  Each variant call is held to the plain
version bit for bit; then the tree's kernel and the variant take each
call in turns (3 passes, median of 20 CUDA-event timings of the op), and
the record build is timed on each distinct index.  A path's totals: the
tree's times summed over its calls, against the variant's plus one build
for each index the path probes.  Prints one line per measurement and,
last, one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build, ops

SOURCE = build.CSRC / "seed_probe.cu"

_KERNEL = "__global__ void __launch_bounds__(kMaxThreads) seed_probe_kernel(\n"
_PROBE = """    int32_t slot = -1;
    if (!any_n && p + seed_len <= len)
      slot = repro::probe(slot_hi, slot_lo, used, cap_mask, *max_probe + 1,
                          (uint32_t)(canon >> 32), (uint32_t)canon);
    const int32_t sl = slot < 0 ? 0 : slot;
    const bool ok = slot >= 0 && !s_multi[sl];
    const bool same = rflip == (bool)s_flip[sl];
    co = same ? 0 : 1;
    if (ok) {
      const int32_t cpos = s_pos[sl];
      cc = s_contig[sl];
      cs = same ? cpos - p : cpos - (len - p - seed_len);
    }
"""
_MAX_SEEDS = "extern \"C\" int seed_probe_max_seeds() { return kMaxSeeds; }\n"

# variant -> [(text of csrc/seed_probe.cu, its replacement)]; each text
# must occur exactly once
VARIANTS = {
    "packed": [
        (_KERNEL, """const uint4* g_record = nullptr;  // what the launcher probes

// rec[a] = {slot_hi, slot_lo, contig, pos << 3 | multi << 2 | flip << 1 |
// used} of slot a (pos in 29 bits: contig positions < 2^28)
__global__ void seed_record_kernel(
    const uint32_t* __restrict__ slot_hi, const uint32_t* __restrict__ slot_lo,
    const uint8_t* __restrict__ used, const int32_t* __restrict__ contig,
    const int32_t* __restrict__ pos, const uint8_t* __restrict__ flip,
    const uint8_t* __restrict__ multi, long long cap,
    uint4* __restrict__ rec) {
  for (long long a = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       a < cap; a += (long long)gridDim.x * blockDim.x)
    rec[a] = make_uint4(slot_hi[a], slot_lo[a], (uint32_t)contig[a],
                        ((uint32_t)pos[a] << 3) | (multi[a] ? 4u : 0u) |
                            (flip[a] ? 2u : 0u) | (used[a] ? 1u : 0u));
}

""" + _KERNEL),
        ("    const __grid_constant__ Seeds seeds, int S, int G, "
         "int seed_len,\n",
         "    const uint4* __restrict__ rec,\n"
         "    const __grid_constant__ Seeds seeds, int S, int G, "
         "int seed_len,\n"),
        (_PROBE, """    uint4 hit = rec[0];  // a miss takes flip of slot 0
    bool found = false;
    if (!any_n && p + seed_len <= len) {
      const uint32_t khi = (uint32_t)(canon >> 32), klo = (uint32_t)canon;
      uint32_t a = repro::kmer_hash(khi, klo) & cap_mask;
      const int32_t bound = *max_probe + 1;
      for (int32_t step = 0; step <= bound; ++step) {
        const uint4 e = rec[a];
        if (!(e.w & 1u)) break;
        if (e.x == khi && e.y == klo) {
          hit = e;
          found = true;
          break;
        }
        a = (a + 1) & cap_mask;
      }
    }
    const bool ok = found && !(hit.w & 4u);
    const bool same = rflip == (bool)(hit.w & 2u);
    co = same ? 0 : 1;
    if (ok) {
      const int32_t cpos = (int32_t)hit.w >> 3;
      cc = (int32_t)hit.z;
      cs = same ? cpos - p : cpos - (len - p - seed_len);
    }
"""),
        ("      seeds, S, G, seed_len,",
         "      g_record, seeds, S, G, seed_len,"),
        ("  if (R == 0) return 0;\n",
         "  if (g_record == nullptr) return (int)cudaErrorInvalidValue;\n"
         "  if (R == 0) return 0;\n"),
        (_MAX_SEEDS, _MAX_SEEDS + """
extern "C" void seed_probe_use_record(const void* rec) {
  g_record = (const uint4*)rec;
}

extern "C" int seed_record_launch(const void* slot_hi, const void* slot_lo,
                                  const void* used, const void* contig,
                                  const void* pos, const void* flip,
                                  const void* multi, long long cap, void* rec,
                                  void* stream) {
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  const long long need = (cap + 255) / 256;
  const long long blocks = need < 132 * 8 ? need : 132 * 8;
  seed_record_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)slot_hi, (const uint32_t*)slot_lo,
      (const uint8_t*)used, (const int32_t*)contig, (const int32_t*)pos,
      (const uint8_t*)flip, (const uint8_t*)multi, cap, (uint4*)rec);
  return (int)cudaGetLastError();
}
"""),
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
        cu = out / f"seed_probe_{name}.cu"
        cu.write_text(variant_source(name))
        so = out / f"seed_probe_{name}.so"
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
        print(f"variant {name}: ptxas {build.ptxas_report(text)}",
              flush=True)
        lib = build._bind("seed_probe", so)
        lib.seed_probe_use_record.argtypes = [ctypes.c_void_p]
        lib.seed_probe_use_record.restype = None
        lib.seed_record_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        lib.seed_record_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


@contextlib.contextmanager
def using(lib):
    """`ops.seed_probe` through library `lib` inside the block."""
    real = build.library
    build.library = lambda name: lib if name == "seed_probe" else real(name)
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
    """{path: [(args, kw), ...]}: every seed_probe call of paths 1-3."""
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
    calls, orig = {}, ops.seed_probe
    for path, run in runs.items():
        calls[path] = []

        def record(*args, **kw):
            calls[path].append((args, {k: v for k, v in kw.items()
                                       if k != "backend"}))
            return orig(*args, **kw)

        ops.seed_probe = record
        try:
            run()
        finally:
            ops.seed_probe = orig
        torch.cuda.synchronize()
    return calls


def record_of(lib, args):
    """The packed record of the seed index in a call's args, and the
    function that builds it."""
    slot_hi, slot_lo, used, _, contig, pos, flip, multi = args[2:10]
    cap = slot_hi.numel()
    rec = torch.empty((cap, 4), dtype=torch.int32, device=slot_hi.device)
    stream = torch.cuda.current_stream().cuda_stream

    def make():
        err = lib.seed_record_launch(
            *(t.data_ptr() for t in (slot_hi, slot_lo, used, contig, pos,
                                     flip, multi)), cap, rec.data_ptr(),
            stream)
        if err:
            raise RuntimeError(f"seed_record_launch: error {err}")
    make()
    return rec, make


def same(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("align_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = {"tree": build.library("seed_probe"), **build_variants()}
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    calls = path_calls()
    result = {"card": card, "calls": {}, "ms": {}, "build_ms": {},
              "totals": {}}
    records = {}  # (variant, index pointer) -> (record, its build)
    for path, cs in calls.items():
        for i, (a, kw) in enumerate(cs):
            row = f"{path}/{i}"
            key = a[2].data_ptr()
            result["calls"][row] = dict(
                reads=a[0].shape[0], L=a[0].shape[1], seeds=len(
                    kw["positions"]), seed_len=kw["seed_len"],
                cap=a[2].numel(), index=key)
            want = ops.seed_probe(*a, **kw, backend="torch")
            for name, lib in libs.items():
                if name != "tree":
                    if (name, key) not in records:
                        records[name, key] = record_of(lib, a)
                    lib.seed_probe_use_record(records[name, key][0]
                                              .data_ptr())
                with using(lib):
                    got = ops.seed_probe(*a, **kw)
                if not same(got, want):
                    raise AssertionError(f"variant {name} != plain on {row}")
            print(f"{row} {result['calls'][row]}: every variant equal to "
                  f"plain", flush=True)
            del want

    for path, cs in calls.items():
        for i, (a, kw) in enumerate(cs):
            row = f"{path}/{i}"
            key = a[2].data_ptr()
            times = {name: [] for name in libs}
            for _ in range(3):
                for name, lib in libs.items():
                    if name != "tree":
                        lib.seed_probe_use_record(records[name, key][0]
                                                  .data_ptr())
                    with using(lib):
                        times[name].append(median_ms(
                            lambda: ops.seed_probe(*a, **kw)))
            for name, ts in times.items():
                result["ms"][f"{row}/{name}"] = ts
                print(f"{row} {name}: op ms {ts} (median of 20, 3 passes)",
                      flush=True)
    for (name, key), (rec, make) in records.items():
        ms = [median_ms(make) for _ in range(3)]
        result["build_ms"][f"{name}/{key}"] = ms
        print(f"{name} record build, index {key} ({rec.shape[0]} slots): "
              f"ms {ms}", flush=True)
    for path, cs in calls.items():
        keys = {a[2].data_ptr() for a, _ in cs}
        for name in libs:
            probe = sum(float(np.median(result["ms"][f"{path}/{i}/{name}"]))
                        for i in range(len(cs)))
            builds = 0.0 if name == "tree" else sum(
                float(np.median(result["build_ms"][f"{name}/{k}"]))
                for k in keys)
            result["totals"][f"{path}/{name}"] = dict(
                calls=len(cs), indexes=len(keys), probe_ms=probe,
                build_ms=builds, total_ms=probe + builds)
            print(f"{path} {name}: {len(cs)} calls over {len(keys)} indexes:"
                  f" probes {probe:.4f} ms + builds {builds:.4f} ms = "
                  f"{probe + builds:.4f} ms", flush=True)
    print(card, flush=True)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
