"""The port's `_chunked_attention` (ATTN_IMPL="chunked") against the JAX
package's (CPU).

The same seeded q, k, v go through both packages' `_chunked_attention`
(512 x 512 blocks, online softmax, the causal and window masks per block
pair) at S 1024 and 2048, windows 0 and 256, causal and non-causal, GQA
2:1 and 4:1; `full_attention` under the flag takes it from S = 1024 and
the naive path below, in both; and a length of S >= 1024 that is not a
multiple of 512 is refused by both (the reference asserts).  Whisper's
1500-frame encoder is such a length, so the reference cannot run it
under "chunked" (ROADMAP.md Queue 3).

Tolerance: 2e-4 abs/rel, the reference's own for its chunked path
(`tests/test_attention_impls.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import attention as jattention
from repro.models import flags as jflags
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, flags

TOL = 2e-4
H, HD = 8, 16


def _cfgs(kv_heads, window):
    kw = dict(name="mini", family="dense", n_layers=1, d_model=H * HD,
              n_heads=H, n_kv_heads=kv_heads, d_ff=128, vocab=128,
              window=window, max_seq=4096)
    return JArchConfig(**kw), ArchConfig(**kw)


def _qkv(S, kv_heads, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, S, H, HD)).astype(np.float32)
    k = rng.standard_normal((1, S, kv_heads, HD)).astype(np.float32)
    v = rng.standard_normal((1, S, kv_heads, HD)).astype(np.float32)
    return q, k, v


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("gqa", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("S", [1024, 2048])
def test_chunked_equals_reference(S, window, causal, gqa):
    jcfg, cfg = _cfgs(H // gqa, window)
    q, k, v = _qkv(S, H // gqa, seed=S + window + gqa + causal)
    want = jattention._chunked_attention(*map(jnp.asarray, (q, k, v)), jcfg,
                                         causal)
    got = attention._chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                       cfg, causal)
    assert got.shape == (1, S, H, HD)
    _close(got, want)


@pytest.mark.parametrize("S", [512, 1024])
def test_full_attention_switches_at_1024(S, monkeypatch):
    """Under ATTN_IMPL="chunked", S < 1024 takes the naive path (the same
    bits as ATTN_IMPL="naive") and S >= 1024 the chunked one, in both."""
    jcfg, cfg = _cfgs(4, 256)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((1, S, H * HD)).astype(np.float32)
    ws = {n: rng.standard_normal((H * HD, w)).astype(np.float32) * 0.1
          for n, w in (("wq", H * HD), ("wk", 4 * HD), ("wv", 4 * HD),
                       ("wo", H * HD))}
    p = attention.Attention(*(torch.from_numpy(ws[n])
                              for n in ("wq", "wk", "wv", "wo")))
    jp = {n: jnp.asarray(w) for n, w in ws.items()}
    seen = []
    orig = attention._chunked_attention
    monkeypatch.setattr(attention, "_chunked_attention",
                        lambda *a: seen.append(1) or orig(*a))
    with torch.no_grad():
        naive = attention.full_attention(p, torch.from_numpy(x), cfg, None)
        monkeypatch.setattr(flags, "ATTN_IMPL", "chunked")
        monkeypatch.setattr(jflags, "ATTN_IMPL", "chunked")
        got = attention.full_attention(p, torch.from_numpy(x), cfg, None)
    want = jattention.full_attention(jp, jnp.asarray(x), jcfg, None)
    assert len(seen) == (S >= 1024)
    if S < 1024:
        assert torch.equal(got, naive)
    _close(got, want)


def test_length_not_a_multiple_of_the_block_is_refused():
    jcfg, cfg = _cfgs(4, 0)
    q, k, v = _qkv(1500, 4, seed=7)
    with pytest.raises(AssertionError):
        jattention._chunked_attention(*map(jnp.asarray, (q, k, v)), jcfg,
                                      False)
    with pytest.raises(ValueError, match="multiple"):
        attention._chunked_attention(*map(torch.from_numpy, (q, k, v)), cfg,
                                     False)


def test_fully_masked_leading_blocks_match_the_reference():
    """With a window of 256 at S 2048, a row of the last query block sees
    block pairs that are all masked before its live ones; both packages
    still run them (their sums scaled away by the first live maximum)."""
    jcfg, cfg = _cfgs(2, 256)
    q, k, v = _qkv(2048, 2, seed=9)
    want = jattention._chunked_attention(*map(jnp.asarray, (q, k, v)), jcfg,
                                         True)
    got = attention._chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                       cfg, True)
    naive = attention._naive_attention(*map(torch.from_numpy, (q, k, v)),
                                       cfg, True)
    _close(got, want)
    _close(got, naive)
