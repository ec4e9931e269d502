"""The slice on the assembly-quality fixture: `benchmarks/bench_quality.py`'s
planted community in `metahipmer` mode (`assembly_presets.quality_plan()`,
carried over with `bridge.plan_from_fields`).

The port's `assemble` on the CPU equals the JAX run bit for bit (scaffold
sequences and every other array of the result), and
`benchmarks/metrics.evaluate` on the port's scaffolds passes the gate of
`benchmarks/baselines/BENCH_quality.json` (genome fraction, N50,
misassemblies), with the gate's own ratios.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # `benchmarks` imports as a package

from benchmarks import bench_quality, metrics  # noqa: E402
from repro.api import Assembler as JAssembler, Local as JLocal  # noqa: E402
from repro.data import mgsim as jmgsim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import Assembler, Local  # noqa: E402
from repro_torch.core.types import ReadSet  # noqa: E402

GATE = json.loads((ROOT / "benchmarks/baselines/BENCH_quality.json")
                  .read_text())["gate"]


@pytest.fixture(scope="module")
def runs():
    jplan = bench_quality.MODES["metahipmer"]
    comm, _ = bench_quality.planted_community(40)
    jreads, _ = jmgsim.generate_reads(42, comm, num_pairs=900, read_len=60,
                                      err_rate=0.004)
    want = JAssembler(jplan, JLocal()).assemble(jreads)
    fields = dataclasses.asdict(jplan)
    fields["policy"] = tuple(jplan.policy)
    reads = ReadSet(*(bridge.tensor(np.asarray(getattr(jreads, f)))
                      for f in ("bases", "lengths", "mate")),
                    jreads.insert_size)
    got = Assembler(bridge.plan_from_fields(fields),
                    Local(device="cpu")).assemble(reads)
    return comm, want, got


@pytest.mark.parametrize("key", ["scaffold_seqs", "scaffolds", "links",
                                 "contigs", "alignments", "alive",
                                 "suspended", "components"])
def test_port_equals_reference(runs, key):
    _, want, got = runs
    w = bridge.to_numpy(got[key])
    ref = want[key]
    pairs = ([(w[f], getattr(ref, f), f) for f in ref._fields]
             if hasattr(ref, "_fields") else [(w, ref, key)])
    for g, r, name in pairs:
        r = np.asarray(r)
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=f"{key}.{name}")


def test_stats_equal(runs):
    _, want, got = runs
    assert [dataclasses.asdict(s) for s in got["stats"]] == \
        [dataclasses.asdict(s) for s in want["stats"]]


def _gate(name, value):
    g = GATE[name]
    if "min_ratio" in g:
        assert value >= g["value"] * g["min_ratio"], (name, value, g)
    if "max_ratio" in g:
        assert value <= g["value"] * g["max_ratio"], (name, value, g)


def test_quality_gate(runs):
    comm, _, got = runs
    pieces = bench_quality.pieces_of(
        {"scaffold_seqs": got["scaffold_seqs"]._replace(
            bases=got["scaffold_seqs"].bases.numpy(),
            lengths=got["scaffold_seqs"].lengths.numpy())})
    rep = metrics.evaluate(pieces, comm.genomes)
    _gate("metahipmer_genome_fraction", rep["genome_fraction"])
    _gate("metahipmer_n50", rep["n50"])
    _gate("metahipmer_misassemblies", rep["misassemblies"])

