"""Port hash table (insert, lookup, build) against the JAX reference rounds.

`repro_torch.core.dht` on CPU tensors runs the plain versions in
`repro_torch.kernels.ref`, held here to `repro.core.dht.insert_jnp` /
`lookup_jnp`: duplicates inside one batch, incremental dedupe against a
filled table, the saturated table that mixes overflow with dedupe, n > cap
overflow labels, and 2-D queries.  Tolerance: exact — table lanes, used,
max_probe and slots are bit-identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import dht as jdht
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.core import dht


def _keys(rng, n, key_space=1 << 40, dup_frac=0.0):
    vals = rng.integers(0, key_space, size=n, dtype=np.uint64)
    if dup_frac:
        d = rng.random(n) < dup_frac
        vals[d] = vals[rng.integers(0, n, size=int(d.sum()))]
    return ((vals >> np.uint64(32)).astype(np.uint32),
            (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _both_insert(table_np, hi, lo, valid):
    """Insert into a (reference, port) pair of tables built from the same
    numpy state; returns ((jtable, jslots), (ttable, tslots))."""
    jt = jdht.HashTable(*(jnp.asarray(x) for x in table_np))
    tt = bridge.to_torch(jt, dht.HashTable)
    jres = jdht.insert_jnp(jt, jnp.asarray(hi), jnp.asarray(lo),
                           jnp.asarray(valid))
    tres = dht.insert(tt, bridge.tensor(hi), bridge.tensor(lo),
                      torch.from_numpy(valid))
    return jres, tres


def _assert_table(got, want):
    g = bridge.to_numpy(got)
    for f in ("slot_hi", "slot_lo", "used", "max_probe"):
        np.testing.assert_array_equal(g[f], np.asarray(getattr(want, f)),
                                      err_msg=f)


def _empty_np(cap):
    t = jdht.empty_table(cap)
    return tuple(np.asarray(x) for x in t)


@pytest.mark.parametrize("n,cap,dup", [(5, 16, 0.0), (60, 64, 0.3),
                                       (80, 64, 0.0), (500, 1024, 0.5),
                                       (300, 256, 0.2)])
def test_insert_build_lookup_match_reference(n, cap, dup):
    rng = np.random.default_rng(n * 7 + cap)
    hi, lo = _keys(rng, n, dup_frac=dup)
    valid = rng.random(n) < 0.9
    (jt, js), (tt, ts) = _both_insert(_empty_np(cap), hi, lo, valid)
    _assert_table(tt, jt)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # lookups: the inserted keys, absent keys, invalid queries; 2-D shape
    ahi, alo = _keys(rng, n)
    qhi = np.concatenate([hi, ahi]).reshape(2, n)
    qlo = np.concatenate([lo, alo]).reshape(2, n)
    qv = rng.random((2, n)) < 0.8
    want = jdht.lookup_jnp(jt, jnp.asarray(qhi), jnp.asarray(qlo),
                           jnp.asarray(qv))
    got = dht.lookup(tt, bridge.tensor(qhi), bridge.tensor(qlo),
                     torch.from_numpy(qv))
    assert got.shape == (2, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        dht.contains(tt, bridge.tensor(qhi), bridge.tensor(qlo)).numpy(),
        np.asarray(jdht.contains(jt, jnp.asarray(qhi), jnp.asarray(qlo),
                                 backend="ref")))


def test_incremental_insert_dedupes_against_table():
    rng = np.random.default_rng(11)
    hi, lo = _keys(rng, 100)
    v = np.ones(100, bool)
    (jt, js), (tt, ts) = _both_insert(_empty_np(256), hi[:60], lo[:60],
                                      v[:60])
    # second batch: half repeats of the first, half new, some repeated
    bhi = np.concatenate([hi[30:60], hi[60:100], hi[60:70]])
    blo = np.concatenate([lo[30:60], lo[60:100], lo[60:70]])
    bv = np.ones(bhi.shape[0], bool)
    (jt2, js2), (tt2, ts2) = _both_insert(
        tuple(np.asarray(x) for x in jt), bhi, blo, bv)
    _assert_table(tt2, jt2)
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    np.testing.assert_array_equal(ts2.numpy()[:30], ts.numpy()[30:60])


def test_full_table_batch_mixes_overflow_and_dedupe():
    """A key that exhausts a full table overflows alone; duplicates in the
    same batch still dedupe to their slots (mirrors tests/test_dht.py)."""
    rng = np.random.default_rng(3)
    cap = 8
    hi, lo = _keys(rng, cap, key_space=1 << 16)
    (jt, js), (tt, ts) = _both_insert(_empty_np(cap), hi, lo,
                                      np.ones(cap, bool))
    assert (np.asarray(js) >= 0).all() and int(jt.used.sum()) == cap
    bhi = np.array([0, hi[2], hi[5]], np.uint32)
    blo = np.array([1 << 18, lo[2], lo[5]], np.uint32)
    (jt2, js2), (tt2, ts2) = _both_insert(
        tuple(np.asarray(x) for x in jt), bhi, blo, np.ones(3, bool))
    _assert_table(tt2, jt2)
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    assert ts2[0] == -1 and ts2[1] == ts[2] and ts2[2] == ts[5]


def test_plain_insert_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode) on one small batch."""
    rng = np.random.default_rng(5)
    hi, lo = _keys(rng, 40, key_space=1 << 16, dup_frac=0.3)
    valid = rng.random(40) < 0.9
    e = _empty_np(32)
    want = jops.dht_insert(*(jnp.asarray(x) for x in e), jnp.asarray(hi),
                           jnp.asarray(lo), jnp.asarray(valid),
                           backend="pallas")
    tt, ts = dht.build(bridge.tensor(hi), bridge.tensor(lo),
                       torch.from_numpy(valid), capacity=32)
    _assert_table(tt, jdht.HashTable(*want[:4]))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(want[4]))
