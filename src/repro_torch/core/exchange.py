"""Aggregated exchange: the paper's batched one-sided messaging (mirrors
`repro.core.exchange`).

Every "Global Update-Only" phase of MetaHipMer (k-mer stores, link
stores, gap projections) batches fine-grained inserts into
per-destination buffers.  Here:

    sort items by destination shard  ->  per-destination contiguous runs
    scatter into a [S * capacity] send buffer (capacity-padded, like MoE)
    exchange                         ->  each shard holds what it owns

The S shards are spread over the W ranks of a `DataMesh` (built from a
process group by `launch.mesh`), S/W shards a rank on a leading shard
axis.  The send buffers of a rank's
senders form [S/W sender, W rank, S/W dest, capacity, ...]; one
`all_to_all_single` a payload leaf moves block [:, r] to rank r, and
receiver d takes, for every sender p in global order, sender p's rows
[p * capacity, (p+1) * capacity).  With one process holding every shard
(no group) the all-to-all is the identity and the exchange a transpose.
`route` has the reference's two forms: one shard's call without
exchange (`sharded=False`: the reference's `axis_name=None`, source
shard 0) and the exchanged form over the leading shard axis
(`sharded=True`).  Overflow is reported, never dropped silently.

`fetch` composes two routes into the paper's remote lookup: route
queries to owners, answer there, route the answers back.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A tensor of rows as the data collectives carry it: its bytes (gloo
    takes neither bool nor int16)."""
    return x.contiguous().view(torch.uint8)


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """S shards over the W ranks of `group`; rank `rank` holds `shards`
    on `device`.  group=None: one process holds all S shards, and the
    collectives are the identity (the reference's `shard_map` stages run
    over one device's shard axis)."""

    num_shards: int
    device: Optional[torch.device] = None
    group: Optional[dist.ProcessGroup] = None
    rank: int = 0
    world_size: int = 1

    @property
    def local_shards(self) -> int:
        return self.num_shards // self.world_size

    @property
    def shards(self) -> range:
        """The global ids of this rank's shards."""
        n = self.local_shards
        return range(self.rank * n, (self.rank + 1) * n)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [W, ...]: row r goes to rank r; returns [W, ...] whose row r
        came from rank r (one `all_to_all_single`, equal splits)."""
        if self.group is None:
            return x
        send = _wire(x)
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        return out.view(x.dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (one shape on every rank) concatenated on dim 0
        in rank order: the reference's sharded array, replicated."""
        if self.group is None:
            return x
        send = _wire(x)
        parts = [torch.empty_like(send) for _ in range(self.world_size)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts).view(x.dtype)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """An integer count summed over the ranks (the reference's
        `psum`)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        """An integer's least value over the ranks."""
        return self._reduce(x, dist.ReduceOp.MIN)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x
        out = x.reshape(1).to(self.device, copy=True)
        dist.all_reduce(out, op=op, group=self.group)
        return out.reshape(x.shape)


class RouteResult(NamedTuple):
    payload: tuple          # received payload tuple, leading dim S*capacity
    valid: torch.Tensor     # [S*capacity] bool
    src_shard: torch.Tensor  # [S*capacity] int32 sender shard
    src_index: torch.Tensor  # [S*capacity] int32 index within sender's input
    overflow: torch.Tensor  # int64 scalar: items dropped for capacity


def _leaves(tree) -> list:
    """The tensors of a payload (a tensor or nested tuples of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in _leaves(x)]


def _rebuild(tree, leaves):
    """A payload of `tree`'s structure from an iterator of tensors."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return tuple(_rebuild(x, leaves) for x in tree)


def _tree_map(fn, tree):
    """Apply fn to every tensor of a payload, keeping its structure."""
    return _rebuild(tree, iter([fn(x) for x in _leaves(tree)]))


def _bucket(dest, valid, num_shards: int, capacity: int):
    """Sorted bucket position of each item: (perm, slot in [S*cap), kept?,
    overflow).  A stable sort on the destination (invalid rows keyed S,
    last) keeps each run in input order, as the reference's sort on
    (dest, index)."""
    n = dest.shape[0]
    dev = dest.device
    d = torch.where(valid, dest.to(torch.int32), num_shards)
    sd, perm = torch.sort(d, stable=True)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sd[1:] != sd[:-1]
    # rank within the destination run: distance to the run's first row
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank = idx - start
    live = sd < num_shards
    keep = live & (rank < capacity)
    slot = sd.to(torch.int64) * capacity + rank
    overflow = (live & (rank >= capacity)).sum()
    return perm, slot, keep, overflow


def send(dest, payload, valid, *, num_shards: int, capacity: int,
          src_shard: int = 0) -> RouteResult:
    """One sender's half of a route: its [S * capacity] send buffer, rows
    [d * capacity, (d+1) * capacity) bound for shard d.  Rows the
    reference's scatter drops are left out before the scatter."""
    perm, slot, keep, overflow = _bucket(dest, valid, num_shards, capacity)
    total = num_shards * capacity
    dev = dest.device
    rows = perm[keep]
    slots = slot[keep]

    def scatter(x):
        buf = torch.zeros((total,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        buf[slots] = x[rows]
        return buf

    bufs = _tree_map(scatter, tuple(payload))
    vbuf = torch.zeros((total,), dtype=torch.bool, device=dev)
    vbuf[slots] = True
    sbuf = torch.full((total,), src_shard, dtype=torch.int32, device=dev)
    ibuf = torch.zeros((total,), dtype=torch.int32, device=dev)
    ibuf[slots] = rows.to(torch.int32)
    return RouteResult(payload=bufs, valid=vbuf, src_shard=sbuf,
                       src_index=ibuf, overflow=overflow)


def exchange(sends: list, mesh: DataMesh | None = None) -> list:
    """The all-to-all of the send buffers of a rank's senders (all S
    without a mesh): receiver d, one of the rank's shards, gets for each
    sender p of the mesh in order sender p's rows bound for d.  The
    overflow of every receiver is the sum over all senders (the
    reference's psum)."""
    n = len(sends)
    mesh = DataMesh(n) if mesh is None else mesh
    W = mesh.world_size

    def a2a(parts):
        stacked = torch.stack(parts)  # [n sender, S * cap, ...]
        tail = tuple(stacked.shape[2:])
        cap = stacked.shape[1] // (W * n)
        t = stacked.reshape((n, W, n, cap) + tail).transpose(0, 1)
        t = mesh.all_to_all(t)  # [W source rank, n sender, n dest, cap]
        t = t.permute((2, 0, 1) + tuple(range(3, t.dim())))
        return list(t.reshape((n, W * n * cap) + tail).unbind(0))

    trees = [tuple(s[:4]) for s in sends]  # payload, valid, src_*
    cols = [a2a(list(leaves)) for leaves in zip(*map(_leaves, trees))]
    overflow = mesh.sum(torch.stack([s.overflow for s in sends]).sum())
    return [RouteResult(*_rebuild(trees[0], iter([c[d] for c in cols])),
                        overflow=overflow) for d in range(n)]


def route(dest, payload, valid, *, num_shards: int, capacity: int,
          sharded: bool = False, mesh: DataMesh | None = None):
    """Send each item to shard dest[i]; receive what a shard owns.

    sharded=False: one shard's call without exchange (the reference's
      `axis_name=None`): dest [n], payload tuple of [n, ...], valid [n];
      returns its RouteResult with leading dimension S*capacity, rows
      [p*capacity, (p+1)*capacity) bound for shard p, src_shard 0.
    sharded=True: the exchanged form over a leading axis of the shards
      that `mesh` puts on this rank (all S without a mesh): dest [S/W, n],
      payload leaves [S/W, n, ...], valid [S/W, n]; returns one
      RouteResult whose leaves are [S/W, S*capacity, ...],
      receiver-major: receiver d's rows [p*capacity, (p+1)*capacity)
      arrived from shard p, src_shard p.  `overflow` sums all senders'.
    """
    if not sharded:
        return send(dest, payload, valid, num_shards=num_shards,
                    capacity=capacity)
    mesh = DataMesh(num_shards) if mesh is None else mesh
    sends = [send(dest[i], _tree_map(lambda x: x[i], tuple(payload)),
                  valid[i], num_shards=num_shards, capacity=capacity,
                  src_shard=s) for i, s in enumerate(mesh.shards)]
    return _stack_results(exchange(sends, mesh))


def _stack_trees(trees: list):
    """Payloads of one structure, stacked on a new leading axis."""
    leaves = [torch.stack(list(p)) for p in zip(*map(_leaves, trees))]
    return _rebuild(trees[0], iter(leaves))


def _stack_results(results: list) -> RouteResult:
    """Per-shard RouteResults on one leading shard axis."""
    stack = lambda f: torch.stack([getattr(r, f) for r in results])
    return RouteResult(payload=_stack_trees([r.payload for r in results]),
                       valid=stack("valid"), src_shard=stack("src_shard"),
                       src_index=stack("src_index"),
                       overflow=results[0].overflow)


def compact(payload, valid, *, capacity: int):
    """Pack the valid rows of a routed buffer into `capacity` front slots.

    The receiver half of a read localization: a route hands each shard a
    [S * route_cap] buffer that is mostly holes; downstream dense stages
    want a compact block.  Stable (arrival order is kept).  Returns
    (payload', valid', overflow): rows past the valid prefix are zero,
    and `overflow` counts valid rows that did not fit.
    """
    n = valid.shape[0]
    dev = valid.device
    if capacity > n:
        pad = capacity - n
        payload = _tree_map(lambda x: torch.cat([x, torch.zeros(
            (pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)]),
            tuple(payload))
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    flag = torch.where(valid, 0, 1).to(torch.int32)
    _, perm = torch.sort(flag, stable=True)
    perm = perm[:capacity]
    out_valid = valid[perm]

    def take(x):
        v = out_valid.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(v, x[perm], torch.zeros((), dtype=x.dtype,
                                                   device=dev))

    out = _tree_map(take, tuple(payload))
    overflow = (valid.sum() - capacity).clamp(min=0)
    return out, out_valid, overflow


def fetch(answer_fn, query_key, query_valid, *, num_shards: int,
          capacity: int, owner_of, sharded: bool = False,
          mesh: DataMesh | None = None):
    """Remote lookup: route queries to owners, answer, route back.

    answer_fn: (key tuple, valid) -> answer tuple of [m, ...] tensors,
      evaluated on an owner shard for the queries it received.
    owner_of: key tuple -> [n] int32 owner shard.
    sharded=False is one shard's call without exchange (the reference's
    `axis_name=None`); sharded=True takes and returns a leading axis of
    the rank's shards (`route`), with answer_fn and owner_of called once
    a shard.  Returns (answers aligned with the queries, got mask).
    """
    query_key = tuple(query_key)
    if not sharded:
        return _fetch_local(answer_fn, query_key, query_valid,
                            num_shards=num_shards, capacity=capacity,
                            owner_of=owner_of)
    mesh = DataMesh(num_shards) if mesh is None else mesh
    local, n = query_valid.shape
    dest = torch.stack([owner_of(tuple(x[s] for x in query_key))
                        for s in range(local)])
    sent = route(dest, query_key, query_valid, num_shards=num_shards,
                 capacity=capacity, sharded=True, mesh=mesh)
    answers = _stack_trees([tuple(answer_fn(
        tuple(x[d] for x in sent.payload), sent.valid[d]))
        for d in range(local)])
    back = route(sent.src_shard, (answers, sent.src_index), sent.valid,
                 num_shards=num_shards, capacity=capacity, sharded=True,
                 mesh=mesh)
    ans_back, idx_back = back.payload
    outs = [_unpermute(tuple(a[s] for a in ans_back), idx_back[s],
                       back.valid[s], n) for s in range(local)]
    return _stack_trees([o[0] for o in outs]), torch.stack(
        [o[1] for o in outs])


def _fetch_local(answer_fn, query_key, query_valid, *, num_shards,
                 capacity, owner_of):
    n = query_valid.shape[0]
    dest = owner_of(query_key)
    sent = route(dest, query_key, query_valid, num_shards=num_shards,
                 capacity=capacity)
    answers = tuple(answer_fn(sent.payload, sent.valid))
    back = route(sent.src_shard, (answers, sent.src_index), sent.valid,
                 num_shards=num_shards, capacity=capacity)
    ans_back, idx_back = back.payload
    return _unpermute(ans_back, idx_back, back.valid, n)


def _unpermute(ans_back, idx_back, valid, n: int):
    """Scatter routed-back answers into the queries' positions (rows
    without a valid answer are left out, where the reference drops
    them)."""
    rows = idx_back[valid].to(torch.int64)
    dev = valid.device

    def put(x):
        out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[rows] = x[valid]
        return out

    got = torch.zeros((n,), dtype=torch.bool, device=dev)
    got[rows] = True
    return _tree_map(put, tuple(ans_back)), got
