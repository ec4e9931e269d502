"""The port's `Mesh(S, group=g)` over a process group on the CPU.

W ranks are spawned processes (`launch.mesh.spawn`) joined in one gloo
group through a `FileStore` under `tmp_path`; rank r holds shards
[r*S/W, (r+1)*S/W). At W = 2 / S = 2, W = 2 / S = 4 and W = 4 / S = 4,
`assemble` and `assemble_stream` on a community of 3 genomes of 300
bases (tests/test_torch_mesh.py's, at 200 pairs of 60 in place of 400,
to keep the spawned runs short) equal the single-process port `Mesh(S,
device="cpu")` bit for bit: every tensor of the result dict, every
`IterationStats` field, the overflow dict and the streamed
`StreamStats`; `exchange.route` and `exchange.fetch` over the mesh
equal the one-process exchange's rows of the rank's shards. Every rank
returns the same result (the ranks all_gather a digest of it), and a
rank holds R / W read rows. A checkpointed streamed run resumes under
the same W, also with one rank a batch behind the other (a run stopped
between their saves), and is refused under another W.
The mesh refuses a backend that does not match its device, a rank that
raises fails the spawn, `build_all` in two processes at once compiles
each library once, and a kernel op refuses a tensor off the current
card.

One spawn of 4 ranks serves every case (a spawned process spends seconds
importing torch): ranks 0-1 run W = 2 at S = 2 and S = 4 (with the
checkpointed run) over a group of their own, then all four run W = 4,
first trying to resume the W = 2 checkpoint, and once every rank has
saved its results rank 0 raises. The worker functions live here, in a
module that imports no JAX: each spawned rank imports it by name.
tests/test_torch_mesh.py's W = 2 `contig_rounds` against the reference
runs `contig_rounds_rank`.
"""
import dataclasses
import hashlib
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch
import torch.distributed as dist

from repro_torch.api import Assembler, AssemblyPlan, Mesh
from repro_torch.core import exchange
from repro_torch.core.exchange import DataMesh
from repro_torch.data import mgsim
from repro_torch.kernels import build, ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.stream import batches_from_readset
from repro_torch.stream.analysis import sharded_streaming_kmer_analysis

BATCH = 256
CONFIGS = [(2, 2), (2, 4), (4, 4)]  # (W ranks, S shards)
CKPT_W, CKPT_S = 2, 4               # its streamed run is checkpointed
FAILING_RANK = 0                    # of the W = 4 run, once all have saved


def community(S):
    comm = mgsim.sample_community(5, num_genomes=3, genome_len=300,
                                  abundance_sigma=0.3)
    reads, _ = mgsim.generate_reads(6, comm, num_pairs=200, read_len=60,
                                    err_rate=0.003)
    # contigs of ~300 bases: buffers of 512 (not the derived 2048) and a
    # smaller walk table give the same assembly at a third of the work
    plan = AssemblyPlan.from_dataset(reads, (17, 21, 4), num_shards=S,
                                     unique_rate=0.2, localize_out_factor=8,
                                     max_contig_len=512,
                                     max_scaffold_len=2048,
                                     walk_capacity=8192)
    return reads, plan


def flatten(x, name="", out=None) -> dict:
    """{path: tensor or plain value} of a result (the plan left out)."""
    out = {} if out is None else out
    if isinstance(x, torch.Tensor):
        out[name] = x.detach().cpu()
    elif dataclasses.is_dataclass(x):
        out[name] = dataclasses.asdict(x)
    elif isinstance(x, dict):
        for k, v in x.items():
            if k != "plan":
                flatten(v, f"{name}.{k}", out)
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            flatten(getattr(x, f), f"{name}.{f}", out)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            flatten(v, f"{name}.{i}", out)
    else:
        out[name] = x
    return out


def digest(flat: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        v = flat[k]
        h.update(k.encode())
        if isinstance(v, torch.Tensor):
            h.update(str(v.dtype).encode() + str(tuple(v.shape)).encode())
            h.update(v.contiguous().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == got[k].dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def _digests(flat: dict, group=None) -> list:
    """Every rank's digest of its result, in rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, digest(flat), group=group)
    return out


def exchange_runs(mesh: DataMesh) -> dict:
    """`route` and `fetch` (sharded) of seeded keys over the rank's shards
    of `mesh`, at a capacity that overflows: {path: tensor}."""
    S = mesh.num_shards
    g = torch.Generator().manual_seed(S)
    keys = torch.randint(0, 1 << 40, (S, 24), generator=g)
    valid = torch.rand((S, 24), generator=g) < 0.8
    blk = slice(mesh.shards.start, mesh.shards.stop)
    keys, valid = keys[blk], valid[blk]
    owner = lambda key: (key[0] % S).to(torch.int32)
    kw = dict(num_shards=S, capacity=8, sharded=True, mesh=mesh)
    routed = exchange.route(torch.stack([owner((k,)) for k in keys]),
                            (keys, valid), valid, **kw)
    fetched = exchange.fetch(
        lambda key, v: (key[0] * 3 + 1, (key[0] % 7).to(torch.int16)),
        (keys,), valid, owner_of=owner, **kw)
    return flatten(dict(route=routed, fetch=fetched))


def _threads(ranks: int):
    # the ranks share the CPU with the test workers: 4 threads in all
    torch.set_num_threads(max(1, 4 // ranks))


def _shard_runs(rank, mesh, ckpt, foreign_ckpt) -> dict:
    """On one rank of `mesh`'s group, for its S: `assemble` and
    `assemble_stream` over `Mesh(S)` (after an attempt to resume
    `foreign_ckpt`; with `ckpt` the streamed run checkpoints there, and
    its k = 17 analysis then resumes from there, once as saved and once
    with the last rank's newest step gone), the mesh's route and fetch,
    what the rank holds and every rank's digests; rank 0 keeps its whole
    results."""
    S = mesh.num_shards
    reads, plan = community(S)
    ctx = Mesh(S, group=mesh.group, device="cpu")
    refused = newest = None
    if foreign_ckpt:
        try:
            Assembler(plan, ctx.spawn()).assemble_stream(
                batches_from_readset(reads, BATCH),
                checkpoint_dir=foreign_ckpt)
        except ValueError as e:
            refused = str(e)
    out = Assembler(plan, ctx).assemble(reads)
    rows = (ctx.sharded.num_reads, ctx.sharded.bases.shape[0])
    batches = batches_from_readset(reads, BATCH)
    res = dict(assemble=flatten(out), stream=flatten(
        Assembler(plan, ctx.spawn()).assemble_stream(
            batches, checkpoint_dir=ckpt)))
    if ckpt:
        kw = dict(k=17, capacity=plan.shard_table_cap,
                  bloom_bits=plan.bloom_slots, pre_capacity=plan.pre_cap,
                  route_capacity=plan.route_capacity)
        k17 = os.path.join(ckpt, "k17")
        fresh, _ = sharded_streaming_kmer_analysis(batches, mesh, **kw)
        again, stats = sharded_streaming_kmer_analysis(
            batches, mesh, checkpoint_dir=k17, **kw)
        # a run stopped after rank 0 saved its last batch and before the
        # last rank did: the last rank's newest step goes
        dist.barrier(group=mesh.group)
        mine = os.path.join(k17, f"rank{mesh.rank}-of-{mesh.world_size}")
        steps = sorted(n for n in os.listdir(mine) if n.startswith("step_"))
        if mesh.rank == mesh.world_size - 1:
            shutil.rmtree(os.path.join(mine, steps.pop()))
        dist.barrier(group=mesh.group)
        lagged, _ = sharded_streaming_kmer_analysis(
            batches, mesh, checkpoint_dir=k17, **kw)
        res["resumed"] = flatten(dict(fresh=fresh, again=again,
                                      lagged=lagged, stats=stats))
        newest = steps[-1]
    got = dict(rows=rows, refused=refused, world=mesh.world_size,
               exchange=exchange_runs(mesh), newest_step=newest,
               shards=list(mesh.shards), device=str(ctx.device),
               digests={k: _digests(v, mesh.group) for k, v in res.items()})
    if mesh.rank == 0:
        got.update(res)
    return got


def group_rank(rank, ckpt, out_dir):
    """One of 4 gloo ranks.  Ranks 0-1 run the W = 2 configurations over
    a group of their own (S = CKPT_S checkpointed into `ckpt`), then all
    4 the W = 4 one over the default group (first trying to resume
    `ckpt`).  Each saves its results; then rank FAILING_RANK raises while
    the others hang."""
    pair = dist.new_group([0, 1])
    got = {}
    if rank < 2:
        _threads(2)
        for w, S in CONFIGS:
            if w == 2:
                mesh = launch_mesh.group_mesh(S, pair, device="cpu")
                got[w, S] = _shard_runs(rank, mesh,
                                        ckpt if S == CKPT_S else None, None)
    dist.barrier()
    _threads(4)
    got[4, 4] = _shard_runs(rank, launch_mesh.make_data_mesh(
        4, device="cpu"), None, ckpt)
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()  # every rank has saved
    if rank == FAILING_RANK:
        raise RuntimeError(f"rank {rank} fails")
    time.sleep(600)  # the spawn must stop the ranks left


def contig_rounds_rank(rank, inp, out_dir):
    """One rank of a W = 2 gloo group: `contig_rounds` of a saved plan
    and read set over `Mesh(2)`; rank 0 keeps the result."""
    _threads(2)
    data = torch.load(inp, weights_only=False)
    ctx = Mesh(2, group=dist.group.WORLD, device="cpu")
    contigs, alive, al, stats = Assembler(data["plan"], ctx).contig_rounds(
        data["reads"])
    flat = flatten(dict(contigs=contigs, alive=alive, al=al))
    got = dict(digest=_digests(flat),
               stats=[dataclasses.asdict(s) for s in stats],
               overflow=ctx.overflow())
    if rank == 0:
        got.update(contigs=contigs, alive=alive, al=al)
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))


def run_group(fn, W, tmp, args=()):
    """Spawn W gloo ranks of fn(rank, *args, out_dir); their saved dicts
    in rank order."""
    out_dir = tmp / "out"
    out_dir.mkdir()
    launch_mesh.spawn(fn, W, device="cpu", init_file=tmp / "store",
                      args=tuple(args) + (str(out_dir),))
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(W)]


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single():
    """The single-process `Mesh(S, device="cpu")` results, by S."""
    cache = {}

    def get(S):
        if S not in cache:
            reads, plan = community(S)
            threads = torch.get_num_threads()
            torch.set_num_threads(2)  # as the ranks: the CPU is shared
            try:
                cache[S] = dict(
                    assemble=flatten(Assembler(plan, Mesh(S, device="cpu"))
                                     .assemble(reads)),
                    stream=flatten(Assembler(plan, Mesh(S, device="cpu"))
                                   .assemble_stream(batches_from_readset(
                                       reads, BATCH))),
                    rows=reads.num_reads)
            finally:
                torch.set_num_threads(threads)
        return cache[S]
    return get


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The one spawn of 4 ranks: {"ranks": {(W, S): the W ranks' saved
    dicts}, "ckpt": the W = 2 checkpoint, "error": the spawn's error}."""
    tmp = tmp_path_factory.mktemp("group")
    ckpt = str(tmp / "ckpt")
    with pytest.raises(torch.multiprocessing.ProcessRaisedException) as e:
        run_group(group_rank, 4, tmp, (ckpt,))
    saved = [torch.load(tmp / "out" / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return dict(ranks={(W, S): [r[W, S] for r in saved[:W]]
                       for W, S in CONFIGS},
                ckpt=ckpt, error=str(e.value))


@pytest.mark.parametrize("W,S", CONFIGS)
def test_group_assemble_equals_the_single_process_mesh(group, single, W, S):
    got = group["ranks"][W, S][0]
    same(got["assemble"], single(S)["assemble"])
    ovf = got["assemble"][".overflow.kmer_route"]
    assert ovf == 0 and got["assemble"][".alive"].any()


@pytest.mark.parametrize("W,S", CONFIGS)
def test_group_assemble_stream_equals_the_single_process_mesh(group, single,
                                                              W, S):
    got = group["ranks"][W, S][0]
    same(got["stream"], single(S)["stream"])
    assert any(k.startswith(".stream_stats.") for k in got["stream"])


@pytest.mark.parametrize("W,S", CONFIGS)
def test_every_rank_returns_the_same_result(group, single, W, S):
    for what in ("assemble", "stream"):
        want = digest(single(S)[what])
        for r in group["ranks"][W, S]:
            assert r["digests"][what] == [want] * W, (what, r["digests"])


@pytest.mark.parametrize("W,S", CONFIGS)
def test_a_rank_holds_its_shards_read_rows(group, single, W, S):
    R_pad = -(-single(S)["rows"] // S) * S
    for rank, r in enumerate(group["ranks"][W, S]):
        assert r["world"] == W and r["device"] == "cpu"
        assert r["rows"] == (R_pad // W, R_pad // W)
        assert r["shards"] == list(range(rank * S // W,
                                         (rank + 1) * S // W))


def test_streamed_checkpoint_resumes_under_the_same_ranks(group):
    for r in group["ranks"][CKPT_W, CKPT_S]:
        # every rank resumed the same table (its own shards', gathered)
        assert r["digests"]["resumed"] == r["digests"]["resumed"][:1] * 2
    got = group["ranks"][CKPT_W, CKPT_S][0]
    assert got["stream"][".stream_stats.17"]["resumed"] is False
    resumed = got["resumed"]
    assert resumed[".stats"]["resumed"] is True
    for key in ("hi", "lo", "count", "left_cnt", "right_cnt"):
        assert torch.equal(resumed[f".again.{key}"],
                           resumed[f".fresh.{key}"]), key
    assert resumed[".fresh.count"].gt(0).any()
    names = sorted(os.listdir(os.path.join(group["ckpt"], "k17")))
    assert names == ["rank0-of-2", "rank1-of-2"]


def test_a_rank_a_batch_behind_resumes_with_the_others(group):
    """The last rank lost its newest step (a run stopped between the two
    ranks' saves): every rank resumes at the earlier step, and the table
    equals a fresh run's."""
    ranks = group["ranks"][CKPT_W, CKPT_S]
    first, last = ranks[0]["newest_step"], ranks[-1]["newest_step"]
    assert int(first.split("_")[1]) == int(last.split("_")[1]) + 1
    resumed = ranks[0]["resumed"]
    for key in ("hi", "lo", "count", "left_cnt", "right_cnt"):
        assert torch.equal(resumed[f".lagged.{key}"],
                           resumed[f".fresh.{key}"]), key


@pytest.mark.parametrize("W,S", CONFIGS)
def test_group_route_and_fetch_equal_the_one_process_exchange(group, W, S):
    want = exchange_runs(DataMesh(S, torch.device("cpu")))
    assert any(v.ndim == 0 and v > 0 for v in want.values()
               if isinstance(v, torch.Tensor))  # the capacity overflows
    for rank, r in enumerate(group["ranks"][W, S]):
        got = r["exchange"]
        assert got.keys() == want.keys()
        blk = slice(rank * S // W, (rank + 1) * S // W)
        for k, v in want.items():
            w = v if v.ndim == 0 else v[blk]
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), \
                (rank, k)


def test_streamed_checkpoint_refuses_another_rank_count(group):
    for r in group["ranks"][4, 4]:
        assert r["refused"] and "over [2] rank(s), not 4" in r["refused"]
    reads, plan = community(4)
    with pytest.raises(ValueError, match=r"over \[2\] rank\(s\), not 1"):
        Assembler(plan, Mesh(4, device="cpu")).assemble_stream(
            batches_from_readset(reads, BATCH),
            checkpoint_dir=group["ckpt"])


def test_a_rank_that_raises_fails_the_spawn(group):
    """Rank 0 raises while ranks 1-3 hang: the spawn stops them and
    raises the error."""
    assert f"rank {FAILING_RANK} fails" in group["error"]


class _Group:
    """A stand-in process group of a given backend (no collective)."""

    def __init__(self, backend, world=2):
        self.backend, self.world = backend, world


@pytest.mark.parametrize("backend,device,match", [
    ("nccl", "cpu", "exchanges over gloo"),
    ("gloo", None, "exchanges over nccl"),
    ("gloo", "cuda", "exchanges over nccl"),
])
def test_a_group_mesh_refuses_a_backend_off_its_device(monkeypatch, backend,
                                                       device, match):
    monkeypatch.setattr(dist, "get_backend", lambda g: g.backend)
    monkeypatch.setattr(dist, "get_rank", lambda g: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda g: g.world)
    with pytest.raises(ValueError, match=match):
        Mesh(4, group=_Group(backend), device=device)
    with pytest.raises(ValueError, match="do not split evenly"):
        Mesh(3, group=_Group("gloo"), device="cpu")


def test_make_data_mesh_needs_a_group_or_the_torchrun_environment(
        monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        launch_mesh.make_data_mesh(2, device="cpu")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK is unset"):
        launch_mesh.local_rank()
    m = DataMesh(4, torch.device("cpu"))
    assert (m.world_size, m.shards, m.group) == (1, range(0, 4), None)
    assert launch_mesh.num_chips(m) == 1
    assert launch_mesh.dp_axes(m) == ("data",)


def test_a_kernel_op_refuses_a_tensor_off_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    other = types.SimpleNamespace(device=torch.device("cuda", 1))
    with pytest.raises(ValueError, match="current device is cuda:0"):
        ops._use_kernel(None, other)
    here = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert ops._use_kernel(None, here)


_FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "$out" >> "{log}"
sleep 0.5
echo built > "$out"
"""

# a process that loads kernels/build.py alone (no torch), points it at a
# build directory and a stub nvcc, waits for the go file, and builds
_BUILD_CHILD = """
import importlib.util, pathlib, sys, time
spec = importlib.util.spec_from_file_location("build_under_test", sys.argv[1])
build = importlib.util.module_from_spec(spec)
spec.loader.exec_module(build)
build.BUILD_DIR = pathlib.Path(sys.argv[2])
build._nvcc = lambda: sys.argv[3]
build._bind = lambda name, path: str(path)
go = pathlib.Path(sys.argv[4])
while not go.exists():
    time.sleep(0.01)
build.build_all()
"""


def test_build_all_takes_turns_across_processes(tmp_path):
    log, nvcc, go = tmp_path / "nvcc.log", tmp_path / "nvcc", tmp_path / "go"
    nvcc.write_text(_FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD,
                               build.__file__, str(tmp_path / "_build"),
                               str(nvcc), str(go)]) for _ in range(2)]
    go.touch()  # both call build_all at once
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    built = log.read_text().split()
    # each library compiled once, by one process, to a tmp name of its own
    assert len(built) == len(build.SIGNATURES)
    names = [os.path.basename(b) for b in built]
    assert {b.split("-")[0] for b in names} == set(build.SIGNATURES)
    assert all(b.endswith(".tmp.so") and b.split(".")[-3].isdigit()
               for b in names)
    assert sorted(p.name for p in (tmp_path / "_build").glob("*.so")) == \
        sorted(f"{n}-{build._digest(n)}.so" for n in build.SIGNATURES)
