"""Build the CUDA kernels in `csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` is compiled by its own `nvcc` process into a shared
library with a plain C interface (`extern "C"` launchers that take raw
pointers, sizes and the CUDA stream, and return a cudaError_t).  All
sources compile in parallel at first use, for `sm_90a` (the H100), into
`kernels/_build/` (git-ignored); a library is reused while the hash of its
sources and flags is unchanged (its nvcc output, with the `-Xptxas -v`
report, is kept beside it).  Processes that build at once (the ranks of
a mesh) take turns under an `fcntl` lock on `_build/`, and each writes
its libraries to tmp names of its own before the atomic rename.  No
torch headers are involved, so a build takes seconds.  A failed build
raises with the compiler's output.

    from repro_torch.kernels import build
    lib = build.library("dht_probe")   # ctypes.CDLL, argtypes set
    build.last_build()                 # seconds and -Xptxas -v report
    build.ptxas_report(build.last_build()["log"])  # registers, spills
    build.sass_counts("flash_attention")  # tensor-core instructions
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)

# Library -> {C function: argtypes}.  Pointers, and the stream, are c_void_p.
SIGNATURES = {
    "kmer_extract": {
        "kmer_extract_launch": [_P, _P, _L, _L, _I] + [_P] * 7 + [_P],
    },
    "dht_probe": {
        "dht_lookup_launch": [_P, _P, _P, _P, _L, _P, _P, _P, _L, _P, _P],
        "dht_insert_counter_names": [],
        "dht_insert_count_launch": [_P, _L, _P, _P],
        "dht_insert_launch": [_P] * 8 + [_L, _P, _P, _P, _L, _P, _P, _P,
                                         _L, _P, _P],
    },
    "seed_probe": {
        "seed_probe_max_seeds": [],
        "seed_probe_launch": [_P, _P, _L, _L, _P, _P, _P, _P, _L,
                              _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    },
    "mer_walk": {
        "mer_walk_launch": [_P] * 6 + [_L, _P, _P, _I, _L] + [_I] * 5
        + [_P] * 5 + [_P],
    },
    "sw_extend": {
        "sw_extend_max_band": [],
        "sw_extend_launch": [_P] * 4 + [_L] + [_I] * 6 + [_P] * 3 + [_P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P] * 4 + [_I] * 6 + [_F, _I, _P],
    },
    "ssd_scan": {
        "ssd_scan_launch": [_P] * 5 + [_I] * 6 + [_P],
    },
    "ssd_scan_wide": {
        "ssd_scan_wide_max_width": [],
        "ssd_scan_wide_run_length": [_I] * 5,
        "ssd_scan_wide_launch": [_P] * 7 + [_I] * 6 + [_P, _P],
    },
    # no kernel of the port: the walk's latency bound (chip_smoke.py)
    "latency_probe": {
        "latency_probe_launch": [_P, ctypes.c_uint, _L, _P, _P, _P],
    },
}

# C functions that return a string (the others return an int)
STRING_RESULTS = {"dht_insert_counter_names"}

_lock = threading.Lock()
_libs: dict = {}
_report: dict = {}


def _tool(name: str):
    """A CUDA toolkit program on PATH or in /usr/local/cuda/bin, or None."""
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    return str(default) if default.exists() else None


def _nvcc() -> str:
    found = _tool("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are built from "
            f"{CSRC} at first use and need the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_char_p if fn in STRING_RESULTS else ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def _log_path(so: Path) -> Path:
    """Where the nvcc output of a built library is kept, beside it."""
    return so.with_suffix(".log")


@contextlib.contextmanager
def _dir_lock():
    """Hold an exclusive `fcntl` lock on the build directory: one process
    at a time compiles into it, and the next finds its libraries."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> dict:
    """Compile every library not yet built (one nvcc each, in parallel)."""
    with _lock, _dir_lock():
        todo = [n for n in SIGNATURES if n not in _libs]
        if not todo:
            return _libs
        t0 = time.perf_counter()
        outs = {n: BUILD_DIR / f"{n}-{_digest(n)}.so" for n in todo}
        procs = {}
        for n in todo:
            if outs[n].exists() and _log_path(outs[n]).exists():
                continue
            tmp = outs[n].with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp)
        logs, failed = {}, []
        for n, (proc, tmp) in procs.items():
            logs[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(n)
            else:
                _log_path(outs[n]).write_text(logs[n])
                tmp.replace(outs[n])
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[n] for n in failed))
        logs = {n: _log_path(outs[n]).read_text() for n in todo}
        for n in todo:
            _libs[n] = _bind(n, outs[n])
        _report.update(seconds=time.perf_counter() - t0, compiled=list(procs),
                       log="\n".join(logs.values()), logs=logs)
        return _libs


def library(name: str) -> ctypes.CDLL:
    libs = _libs if name in _libs else build_all()
    return libs[name]


def last_build() -> dict:
    """{'seconds', 'compiled', 'log', 'logs'} of the last build_all that
    bound libraries: 'compiled' names those it compiled, 'logs' holds each
    library's nvcc output (kept beside its .so, so a library built by an
    earlier process reports too) and 'log' all of them."""
    return dict(_report)


def _demangle(names: list) -> dict:
    tool = _tool("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def ptxas_report(log: str) -> dict:
    """{kernel: {'registers', 'stack_frame', 'spill_stores',
    'spill_loads'}} (bytes for the stack frame and the spills) from the
    `-Xptxas -v` lines of a build log."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[fn].update(stack_frame=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn]["registers"] = int(m.group(1))
    names = _demangle(list(report))
    return {names[k]: v for k, v in report.items()}


def sass_counts(name: str, opcodes=("HGMMA", "HMMA")):
    """{kernel: {opcode: instructions}} in the SASS of library `name`
    (`cuobjdump -sass`), or None where the toolkit has no cuobjdump."""
    tool = _tool("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", library(name)._name],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    pat = re.compile(r"\b(" + "|".join(opcodes) + r")\.")
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(opcodes, 0)
            continue
        m = pat.search(line)
        if m and fn is not None:
            counts[fn][m.group(1)] += 1
    names = _demangle(list(counts))
    return {names[k]: v for k, v in counts.items()}
