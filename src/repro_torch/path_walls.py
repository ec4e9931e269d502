"""Wall times of paths 1 and 2 of `chip_smoke.py` (`contig_rounds` and
`assemble` on its community, reads and plans) with the port found in a
given source tree, so that two trees can be compared on one card.

    python3 src/repro_torch/path_walls.py [--src DIR] [--reps N] [--out F]

`--src` is the directory that holds `repro_torch` (default: the one this
file is in); run it once a tree, in alternation (A, B, B, A), in one
call to the card.  Each path runs once to build and warm up, then `reps`
times, each timed on the host clock with the card synchronised before
and after.  Prints one line per run and, last, one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(HERE.parent))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    # run as a file, this package's directory would shadow top-level names
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.api import Assembler, AssemblyPlan, Local
    from repro_torch.data import mgsim

    if not torch.cuda.is_available():
        print("path_walls: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    import repro_torch
    print(card, "; port from", Path(repro_torch.__file__).parent, flush=True)
    comm = mgsim.sample_community(0, num_genomes=20,
                                  genome_len=(10_000, 30_000),
                                  strain_pairs=4)
    reads, _ = mgsim.generate_reads(1, comm, num_pairs=75_000,
                                    read_len=150, insert_mean=400,
                                    insert_sd=30, err_rate=0.002)
    plan1 = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.1,
                                      run_local_assembly=False)
    plan2 = AssemblyPlan.from_dataset(reads, (17, 21, 4), unique_rate=0.1)
    runs = {
        "path1": lambda: Assembler(plan1, Local()).contig_rounds(reads),
        "path2": lambda: Assembler(plan2, Local()).assemble(reads),
    }
    result = {"card": card, "src": str(Path(args.src).resolve()),
              "wall_s": {}}
    for path, run in runs.items():
        run()
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        result["wall_s"][path] = walls
        print(f"{path}: wall s {', '.join(f'{w:.4f}' for w in walls)}",
              flush=True)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
