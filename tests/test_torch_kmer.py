"""Port codec and plain kmer_extract against the JAX reference.

`repro_torch.core.kmer` against `repro.core.kmer`, and
`repro_torch.kernels.ref.kmer_extract_ref` against
`repro.kernels.ref.kmer_extract_ref`, over odd k in {3, 15, 17, 21, 31}
plus k = 16, ragged lengths (including len < k) and reads with N bases.
Tolerance: exact.  Every lane of every window is compared, invalid and
padding windows included, as uint32 bit patterns.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import kmer as jkmer
from repro.kernels import kmer_extract as jke
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core import kmer
from repro_torch.kernels import ref

KS = [3, 15, 16, 17, 21, 31]
LANES = ("hi", "lo", "hash", "left", "right", "flip", "valid")


def _reads(rng, R, L, n_frac=0.05):
    bases = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    bases[rng.random((R, L)) < n_frac] = 4
    lengths = rng.integers(0, L + 1, size=(R,)).astype(np.int32)
    return bases, lengths


def _codes(rng, n, k):
    """Random packed 2k-bit codes as (hi, lo) uint32 arrays."""
    bits = 2 * k
    lo = rng.integers(0, 1 << min(bits, 32), size=n, dtype=np.uint64)
    hi = (rng.integers(0, 1 << (bits - 32), size=n, dtype=np.uint64)
          if bits > 32 else np.zeros(n, np.uint64))
    return hi.astype(np.uint32), lo.astype(np.uint32)


def _np(x):
    """Port tensor or JAX array -> numpy; int32 lanes as uint32 bits."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _assert_equal(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("k", KS)
def test_kmer_extract_ref_all_lanes_all_windows(k):
    rng = np.random.default_rng(1000 + k)
    bases, lengths = _reads(rng, 9, k + 14)
    got = ref.kmer_extract_ref(torch.from_numpy(bases),
                               torch.from_numpy(lengths), k=k)
    want = jref.kmer_extract_ref(jnp.asarray(bases), jnp.asarray(lengths),
                                 k=k)
    assert not np.asarray(want.valid)[lengths < k].any()
    for lane in LANES:
        _assert_equal(getattr(got, lane), getattr(want, lane), lane)


@pytest.mark.parametrize("k", [3, 16, 31])
def test_kmer_extract_ref_valid_windows_match_pallas_interpret(k):
    """The Pallas kernel itself (interpret mode) agrees with the port's
    plain version on every valid window and on the validity mask; the
    kernel masks N bases to 2 bits, so invalid windows differ there."""
    rng = np.random.default_rng(2000 + k)
    bases, lengths = _reads(rng, 8, k + 6)
    got = ref.kmer_extract_ref(torch.from_numpy(bases),
                               torch.from_numpy(lengths), k=k)
    want = jke.kmer_extract(jnp.asarray(bases), jnp.asarray(lengths), k=k,
                            interpret=True)
    wv = np.asarray(want.valid)
    _assert_equal(got.valid, want.valid, "valid")
    for lane in LANES[:-1]:
        np.testing.assert_array_equal(_np(getattr(got, lane))[wv],
                                      np.asarray(getattr(want, lane))[wv],
                                      err_msg=lane)


@pytest.mark.parametrize("k", KS)
def test_codec_matches_reference(k):
    rng = np.random.default_rng(3000 + k)
    n = 257
    hi, lo = _codes(rng, n, k)
    base = rng.integers(0, 5, size=n).astype(np.uint8)  # includes N
    th, tl, tb = (bridge.tensor(x) for x in (hi, lo, base))
    jh, jl, jb = (jnp.asarray(x) for x in (hi, lo, base))
    pairs = {
        "append_base": (kmer.append_base(th, tl, tb, k=k),
                        jkmer.append_base(jh, jl, jb, k=k)),
        "prepend_base": (kmer.prepend_base(th, tl, tb & 3, k=k),
                         jkmer.prepend_base(jh, jl, jb & 3, k=k)),
        "reverse_complement": (kmer.reverse_complement(th, tl, k=k),
                               jkmer.reverse_complement(jh, jl, k=k)),
        "canonical": (kmer.canonical(th, tl, k=k),
                      jkmer.canonical(jh, jl, k=k)),
        "kmer_hash": ((kmer.kmer_hash(th, tl),), (jkmer.kmer_hash(jh, jl),)),
        "last_base": ((kmer.last_base(th, tl, k=k),),
                      (jkmer.last_base(jh, jl, k=k),)),
        "decode": ((kmer.decode(th, tl, k=k),), (jkmer.decode(jh, jl, k=k),)),
    }
    for name, (got, want) in pairs.items():
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{name}[{i}]")


def test_kmer_hash_on_full_32_bit_lanes():
    """The hash wraps products mod 2**32 on any lane value, top bits set."""
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    _assert_equal(kmer.kmer_hash(bridge.tensor(hi), bridge.tensor(lo)),
                  jkmer.kmer_hash(jnp.asarray(hi), jnp.asarray(lo)), "hash")


@pytest.mark.parametrize("k", [3, 17, 31])
def test_extract_and_canonicalize_occurrences_match_reference(k):
    rng = np.random.default_rng(4000 + k)
    bases, lengths = _reads(rng, 6, k + 9)
    got = kmer.extract_kmers(torch.from_numpy(bases),
                             torch.from_numpy(lengths), k=k)
    want = jkmer.extract_kmers(jnp.asarray(bases), jnp.asarray(lengths), k=k)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_equal(g, w, f"extract_kmers[{i}]")
    hi, lo, _, left, right = got
    jhi, jlo, _, jleft, jright = want
    got_c = kmer.canonicalize_occurrences(hi, lo, left, right, k=k)
    want_c = jkmer.canonicalize_occurrences(jhi, jlo, jleft, jright, k=k)
    for i, (g, w) in enumerate(zip(got_c, want_c)):
        _assert_equal(g, w, f"canonicalize_occurrences[{i}]")


def test_complement_base_matches_reference():
    b = np.arange(6, dtype=np.uint8)
    _assert_equal(kmer.complement_base(torch.from_numpy(b)),
                  jkmer.complement_base(jnp.asarray(b)), "complement_base")
