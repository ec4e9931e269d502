"""Aggregated exchange: the paper's batched one-sided messaging (mirrors
`repro.core.exchange`).

Every "Global Update-Only" phase of MetaHipMer (k-mer stores, link
stores, gap projections) batches fine-grained inserts into
per-destination buffers.  Here:

    sort items by destination shard  ->  per-destination contiguous runs
    scatter into a [S * capacity] send buffer (capacity-padded, like MoE)
    exchange                         ->  each shard holds what it owns

On one card the S shards live on a leading shard axis of one process, so
the exchange of the reference's tiled `all_to_all` is a transpose: the
send buffers of all senders form [S_sender, S_dest, capacity, ...] and
receiver d takes [:, d], whose rows [p * capacity, (p+1) * capacity) are
sender p's.  `route` has the reference's two forms: one shard's call
without exchange (`sharded=False`: the reference's `axis_name=None`,
source shard 0) and the exchanged form over the leading shard axis
(`sharded=True`).  Overflow is reported, never dropped silently.

`fetch` composes two routes into the paper's remote lookup: route
queries to owners, answer there, route the answers back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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


def exchange(sends: list) -> list:
    """The all-to-all of S senders' send buffers: receiver d gets, for
    each sender p in order, sender p's rows bound for d.  The overflow of
    every receiver is the sum over senders (the reference's psum)."""
    S = len(sends)

    def a2a(parts):
        stacked = torch.stack(parts)  # [S_sender, S * cap, ...]
        tail = tuple(stacked.shape[2:])
        cap = stacked.shape[1] // S
        t = stacked.reshape((S, S, cap) + tail).transpose(0, 1)
        return list(t.reshape((S, S * cap) + tail).unbind(0))

    trees = [tuple(s[:4]) for s in sends]  # payload, valid, src_*
    cols = [a2a(list(leaves)) for leaves in zip(*map(_leaves, trees))]
    overflow = torch.stack([s.overflow for s in sends]).sum()
    return [RouteResult(*_rebuild(trees[0], iter([c[d] for c in cols])),
                        overflow=overflow) for d in range(S)]


def route(dest, payload, valid, *, num_shards: int, capacity: int,
          sharded: bool = False):
    """Send each item to shard dest[i]; receive what a shard owns.

    sharded=False: one shard's call without exchange (the reference's
      `axis_name=None`): dest [n], payload tuple of [n, ...], valid [n];
      returns its RouteResult with leading dimension S*capacity, rows
      [p*capacity, (p+1)*capacity) bound for shard p, src_shard 0.
    sharded=True: the exchanged form over a leading shard axis: dest
      [S, n], payload leaves [S, n, ...], valid [S, n]; returns one
      RouteResult whose leaves are [S, S*capacity, ...], receiver-major:
      receiver d's rows [p*capacity, (p+1)*capacity) arrived from shard
      p, src_shard p.  `overflow` sums the senders'.
    """
    if not sharded:
        return send(dest, payload, valid, num_shards=num_shards,
                    capacity=capacity)
    S = dest.shape[0]
    sends = [send(dest[s], _tree_map(lambda x: x[s], tuple(payload)),
                  valid[s], num_shards=num_shards, capacity=capacity,
                  src_shard=s) for s in range(S)]
    return _stack_results(exchange(sends))


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
          capacity: int, owner_of, sharded: bool = False):
    """Remote lookup: route queries to owners, answer, route back.

    answer_fn: (key tuple, valid) -> answer tuple of [m, ...] tensors,
      evaluated on an owner shard for the queries it received.
    owner_of: key tuple -> [n] int32 owner shard.
    sharded=False is one shard's call without exchange (the reference's
    `axis_name=None`); sharded=True takes and returns a leading shard
    axis, with answer_fn and owner_of called once a shard.
    Returns (answers aligned with the queries, got mask).
    """
    query_key = tuple(query_key)
    if not sharded:
        return _fetch_local(answer_fn, query_key, query_valid,
                            num_shards=num_shards, capacity=capacity,
                            owner_of=owner_of)
    S, n = query_valid.shape
    dest = torch.stack([owner_of(tuple(x[s] for x in query_key))
                        for s in range(S)])
    sent = route(dest, query_key, query_valid, num_shards=num_shards,
                 capacity=capacity, sharded=True)
    answers = _stack_trees([tuple(answer_fn(
        tuple(x[d] for x in sent.payload), sent.valid[d]))
        for d in range(S)])
    back = route(sent.src_shard, (answers, sent.src_index), sent.valid,
                 num_shards=num_shards, capacity=capacity, sharded=True)
    ans_back, idx_back = back.payload
    outs = [_unpermute(tuple(a[s] for a in ans_back), idx_back[s],
                       back.valid[s], n) for s in range(S)]
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
