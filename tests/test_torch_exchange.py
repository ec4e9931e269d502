"""The port's owner exchange (`core.exchange`) and the shard adapters of
`dist.pipeline` against the reference's, at S = 8.

The reference's exchanged `route` runs inside `shard_map` on 8 host
devices, so the JAX side runs once, in a module-scoped subprocess that
sets `XLA_FLAGS` before importing jax (as tests/test_distributed.py
does), and writes its arrays to an `.npz`.  The port runs the same seeded
inputs on a leading shard axis of one process.  Dests are drawn skewed
towards shard 0, so some (sender, destination) lanes overflow their
capacity.  Tolerance: exact everywhere, overflow counts included.

`run_reference` and `Ref` are shared with the other distributed test
files (tests/test_torch_dist_*.py, tests/test_torch_mesh.py).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import exchange
from repro_torch.core.types import ReadSet
from repro_torch.dist import pipeline as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEADER = """
import os, sys, json, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={ndev}"
os.environ["JAX_PLATFORMS"] = "cpu"
warnings.simplefilter("ignore")
import numpy as np
import jax
import jax.numpy as jnp
assert jax.device_count() == {ndev}, jax.device_count()
# the reference's eager shard_map stages compile anew on every call; a
# persistent cache beside the output lets a repeated program load instead
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(os.path.dirname(sys.argv[1]), "jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
OUT = {{}}


def put(name, x):
    if hasattr(x, "_fields"):
        for f in x._fields:
            put(name + "." + f, getattr(x, f))
    elif isinstance(x, dict):
        for k, v in x.items():
            put(name + "." + str(k), v)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            put(name + "." + str(i), v)
    else:
        OUT[name] = np.asarray(x)


def put_json(name, obj):
    OUT[name] = np.asarray(json.dumps(obj))
"""


def run_reference(body: str, out_path, ndev: int, timeout: int = 900):
    """Run `body` (JAX, `ndev` host devices) in a fresh interpreter; it
    fills OUT through put(name, value) and the arrays come back as a
    `Ref`."""
    script = (textwrap.dedent(_HEADER.format(ndev=ndev))
              + textwrap.dedent(body)
              + "\nnp.savez(sys.argv[1], **OUT)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}/src:{REPO}/tests:{REPO}"
    out = subprocess.run([sys.executable, "-c", script, str(out_path)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, (f"STDOUT:\n{out.stdout}\n"
                                 f"STDERR:\n{out.stderr[-6000:]}")
    with np.load(out_path, allow_pickle=False) as z:
        return Ref({k: z[k] for k in z.files})


class Ref(dict):
    """The reference's arrays by dotted name."""

    def json(self, name):
        return json.loads(str(self[name]))

    def tensor(self, name, device="cpu"):
        a = self[name]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def record(self, name, cls):
        return cls(*(self.tensor(f"{name}.{f}") for f in cls._fields))


def eq(got, want, what):
    """Port tensor == reference array, bit for bit (uint32 lanes compared
    as uint32)."""
    want = np.asarray(want)
    got = got.detach().cpu().numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def eq_record(got, ref, name):
    for f in got._fields:
        v = getattr(got, f)
        if isinstance(v, torch.Tensor):
            eq(v, ref[f"{name}.{f}"], f"{name}.{f}")


S, N_PER, CAP = 8, 64, 10
FETCH_CAP = 24


def _inputs():
    """Seeded inputs: skewed dests (half the items to shard 0), values,
    a [n, 2] int32 and a uint8 payload column, a validity mask."""
    rng = np.random.default_rng(7)
    n = S * N_PER
    dest = np.where(rng.random(n) < 0.5, 0,
                    rng.integers(0, S, n)).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    pairs = rng.integers(0, 1 << 20, (n, 2)).astype(np.int32)
    tags = rng.integers(0, 256, n).astype(np.uint8)
    valid = rng.random(n) < 0.9
    keys = rng.integers(0, 1 << 30, n).astype(np.int32)
    hi = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    return dict(dest=dest, vals=vals, pairs=pairs, tags=tags, valid=valid,
                keys=keys, hi=hi, lo=lo)


_BODY = """
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import exchange
from repro.core.types import ReadSet
from repro.dist import pipeline as dist
import test_torch_exchange as T

inp = T._inputs()
S, N, CAP, FCAP = T.S, T.N_PER, T.CAP, T.FETCH_CAP
mesh = Mesh(np.array(jax.devices()), axis_names=("data",))
j = {k: jnp.asarray(v) for k, v in inp.items()}


def body(dest, vals, pairs, tags, valid):
    res = exchange.route(dest, (vals, pairs, tags), valid, num_shards=S,
                         capacity=CAP, axis_name="data")
    return res.payload + (res.valid, res.src_shard, res.src_index,
                          res.overflow)


fn = shard_map(body, mesh=mesh, in_specs=(P("data"),) * 5,
               out_specs=(P("data"),) * 6 + (P(),), check_rep=False)
put("route", fn(j["dest"], j["vals"], j["pairs"], j["tags"], j["valid"]))

for s in (0, 3):
    blk = slice(s * N, (s + 1) * N)
    res = exchange.route(j["dest"][blk], (j["vals"][blk], j["pairs"][blk],
                                          j["tags"][blk]), j["valid"][blk],
                         num_shards=S, capacity=CAP)
    put(f"route_local{s}", res)
    for c in (5, N, 2 * N):
        put(f"compact{s}_{c}", exchange.compact(
            (j["vals"][blk], j["pairs"][blk], j["tags"][blk]),
            j["valid"][blk], capacity=c))
    put(f"fetch_local{s}", exchange.fetch(
        lambda k, v: (k[0] * 3 + 1, k[0] % 7 == 0), (j["keys"][blk],),
        j["valid"][blk], num_shards=S, capacity=FCAP, axis_name=None,
        owner_of=lambda k: (k[0] % S).astype(jnp.int32)))


def fbody(keys, valid):
    return exchange.fetch(
        lambda k, v: (k[0] * 3 + 1, k[0] % 7 == 0), (keys,), valid,
        num_shards=S, capacity=FCAP, axis_name="data",
        owner_of=lambda k: (k[0] % S).astype(jnp.int32))


ffn = shard_map(fbody, mesh=mesh, in_specs=(P("data"),) * 2,
                out_specs=P("data"), check_rep=False)
put("fetch", ffn(j["keys"], j["valid"]))

for nsh in (2, 3, 8):
    put(f"owner{nsh}", dist.kmer_owner(j["hi"], j["lo"], nsh))
rng = np.random.default_rng(3)
reads = ReadSet(bases=jnp.asarray(rng.integers(0, 5, (13, 9)), jnp.uint8),
                lengths=jnp.asarray(rng.integers(0, 10, 13), jnp.int32),
                mate=jnp.asarray(rng.integers(-1, 13, 13), jnp.int32),
                insert_size=77)
for nsh in (1, 2, 8):
    put(f"shard_reads{nsh}", dist.shard_reads(reads, nsh))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(_BODY, tmp_path_factory.mktemp("x") / "ref.npz",
                         ndev=S)


@pytest.fixture(scope="module")
def inp():
    return {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                else v) for k, v in _inputs().items()}


def _payload(inp, blk=slice(None)):
    return (inp["vals"][blk], inp["pairs"][blk], inp["tags"][blk])


def test_route_exchanged_matches_all_to_all(ref, inp):
    """The exchanged form over the leading shard axis equals the
    reference's route + tiled all_to_all inside shard_map."""
    sh = lambda x: x.reshape((S, N_PER) + tuple(x.shape[1:]))
    res = exchange.route(sh(inp["dest"]), tuple(map(sh, _payload(inp))),
                         sh(inp["valid"]), num_shards=S, capacity=CAP,
                         sharded=True)
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    got = tuple(map(flat, res.payload)) + tuple(
        map(flat, (res.valid, res.src_shard, res.src_index)))
    for i, g in enumerate(got):
        eq(g, ref[f"route.{i}"], f"route.{i}")
    eq(res.overflow.to(torch.int32), ref["route.6"], "overflow")
    assert int(res.overflow) > 0


@pytest.mark.parametrize("s", [0, 3])
def test_route_per_shard_form(ref, inp, s):
    blk = slice(s * N_PER, (s + 1) * N_PER)
    res = exchange.route(inp["dest"][blk], _payload(inp, blk),
                         inp["valid"][blk], num_shards=S, capacity=CAP)
    for i, g in enumerate(res.payload):
        eq(g, ref[f"route_local{s}.payload.{i}"], f"payload {i}")
    for f in ("valid", "src_shard", "src_index"):
        eq(getattr(res, f), ref[f"route_local{s}.{f}"], f)
    eq(res.overflow.to(torch.int32), ref[f"route_local{s}.overflow"],
       "overflow")


@pytest.mark.parametrize("s", [0, 3])
@pytest.mark.parametrize("cap", [5, N_PER, 2 * N_PER])
def test_compact(ref, inp, s, cap):
    blk = slice(s * N_PER, (s + 1) * N_PER)
    out, valid, ovf = exchange.compact(_payload(inp, blk),
                                       inp["valid"][blk], capacity=cap)
    name = f"compact{s}_{cap}"
    for i, g in enumerate(out):
        eq(g, ref[f"{name}.0.{i}"], f"{name} payload {i}")
    eq(valid, ref[f"{name}.1"], "valid")
    eq(ovf.to(torch.int32), ref[f"{name}.2"], "overflow")


def _answer(k, v):
    return (k[0] * 3 + 1, k[0] % 7 == 0)


def _owner(k):
    return (k[0] % S).to(torch.int32)


def test_fetch_exchanged(ref, inp):
    sh = lambda x: x.reshape(S, N_PER)
    (a, b), got = exchange.fetch(_answer, (sh(inp["keys"]),),
                                 sh(inp["valid"]), num_shards=S,
                                 capacity=FETCH_CAP, owner_of=_owner,
                                 sharded=True)
    eq(a.reshape(-1), ref["fetch.0.0"], "answer 0")
    eq(b.reshape(-1), ref["fetch.0.1"], "answer 1")
    eq(got.reshape(-1), ref["fetch.1"], "got")
    assert not bool(got.all())  # some queries overflowed the lanes


@pytest.mark.parametrize("s", [0, 3])
def test_fetch_per_shard_form(ref, inp, s):
    blk = slice(s * N_PER, (s + 1) * N_PER)
    (a, b), got = exchange.fetch(_answer, (inp["keys"][blk],),
                                 inp["valid"][blk], num_shards=S,
                                 capacity=FETCH_CAP, owner_of=_owner)
    eq(a, ref[f"fetch_local{s}.0.0"], "answer 0")
    eq(b, ref[f"fetch_local{s}.0.1"], "answer 1")
    eq(got, ref[f"fetch_local{s}.1"], "got")


@pytest.mark.parametrize("nsh", [2, 3, 8])
def test_kmer_owner(ref, inp, nsh):
    """The owner of keys with the top lane bit set too: the hash lane is
    widened before the logical shift."""
    eq(dist.kmer_owner(inp["hi"], inp["lo"], nsh), ref[f"owner{nsh}"],
       "owner")


@pytest.mark.parametrize("nsh", [1, 2, 8])
def test_shard_reads_pads_an_uneven_read_count(ref, nsh):
    rng = np.random.default_rng(3)
    reads = ReadSet(
        bases=torch.from_numpy(rng.integers(0, 5, (13, 9)).astype(np.uint8)),
        lengths=torch.from_numpy(rng.integers(0, 10, 13).astype(np.int32)),
        mate=torch.from_numpy(rng.integers(-1, 13, 13).astype(np.int32)),
        insert_size=77)
    got = dist.shard_reads(reads, nsh)
    eq_record(got, ref, f"shard_reads{nsh}")
    assert got.insert_size == 77 and got.num_reads % nsh == 0
