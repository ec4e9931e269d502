"""Graph pieces of Algorithm 3 on synthetic inputs made with numpy: the
port's connected components, per-end link ranking and greedy matching
against the reference, and the JAX scatter index rule the port mirrors.

  * `cc.connected_components` on random graphs (chains, stars, isolated
    vertices, invalid edges);
  * `types.drop_rows` against JAX `.at[idx].set(..., mode="drop")` with
    negative and out-of-range indices (JAX wraps -1 to the last row);
  * `scaffolding._per_end_links` and `greedy_matching` on links with
    tied gaps, supports and lengths, where only stable sorts in the
    reference's order of float32 operations give the same ranks.
Tolerance: exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import cc as jcc, scaffolding as jscaf
from repro_torch import bridge
from repro_torch.core import cc, scaffolding
from repro_torch.core.scaffolding import Links
from repro_torch.core.types import drop_rows


@pytest.mark.parametrize("n,E,seed", [(1, 0, 0), (10, 5, 1), (64, 40, 2),
                                      (300, 120, 3), (300, 600, 4)])
def test_connected_components(n, E, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=E).astype(np.int32)
    v = rng.integers(0, n, size=E).astype(np.int32)
    if E > 10:  # a long chain: the pointer jumping needs several rounds
        m = min(E // 2, n - 1)
        u[:m], v[:m] = np.arange(m)[::-1], np.arange(1, m + 1)[::-1]
    valid = rng.random(E) < 0.8
    want = jcc.connected_components(jnp.asarray(u), jnp.asarray(v),
                                    jnp.asarray(valid), n)
    got = cc.connected_components(torch.from_numpy(u), torch.from_numpy(v),
                                  torch.from_numpy(valid), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_drop_rows_is_the_jax_scatter_rule():
    n = 8
    idx = np.array([0, 3, -1, -8, -9, 8, 12, 5, -3], np.int32)
    vals = np.arange(1, len(idx) + 1, dtype=np.int32)
    want = jnp.zeros(n, jnp.int32).at[jnp.asarray(idx)].set(
        jnp.asarray(vals), mode="drop")
    keep, row = drop_rows(torch.from_numpy(idx), n)
    got = torch.zeros(n, dtype=torch.int32)
    got[row[keep]] = torch.from_numpy(vals)[keep]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tied_links(rng, E, n_ends, fill=0.7):
    a = rng.integers(0, n_ends, size=E)
    b = rng.integers(0, n_ends, size=E)
    a, b = np.minimum(a, b), np.maximum(a, b)
    b = np.where(a == b, (b + 2) % n_ends, b)
    a, b = np.minimum(a, b), np.maximum(a, b)
    gap = rng.choice([-5.0, 0.0, 0.0, 12.0, 40.0, 40.0, 1e5, 3e5],
                     size=E).astype(np.float32)
    support = rng.choice([2, 2, 3, 5], size=E).astype(np.int32)
    valid = rng.random(E) < fill
    return dict(end_a=np.where(valid, a, -1).astype(np.int32),
                end_b=np.where(valid, b, -1).astype(np.int32), gap=gap,
                support=np.where(valid, support, 0).astype(np.int32),
                splints=np.zeros(E, np.int32), valid=valid)


@pytest.mark.parametrize("E,C,seed", [(16, 8, 0), (64, 16, 1),
                                      (256, 64, 2)])
def test_per_end_links_and_matching_with_ties(E, C, seed):
    rng = np.random.default_rng(seed)
    n_ends = 2 * C
    fields = _tied_links(rng, E, n_ends)
    jlinks = jscaf.Links(**{k: jnp.asarray(v) for k, v in fields.items()})
    links = Links(**{k: bridge.tensor(v) for k, v in fields.items()})
    jends, jcnt = jscaf._per_end_links(jlinks, n_ends)
    ends, cnt = scaffolding._per_end_links(links, n_ends)
    np.testing.assert_array_equal(ends.numpy(), np.asarray(jends))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    # contig lengths with ties; long enough that length * 1e6 rounds
    lengths = rng.choice([500, 500, 1500, 20000, 20001],
                         size=C).astype(np.int32)
    hmm = rng.random(C) < 0.3
    jm, jg = jscaf.greedy_matching(jlinks, jnp.asarray(lengths),
                                   jnp.asarray(hmm), n_ends=n_ends)
    m, g = scaffolding.greedy_matching(links, bridge.tensor(lengths),
                                       bridge.tensor(hmm), n_ends=n_ends)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert int((m >= 0).sum()) >= 2, "fixture must match some ends"
