"""The 3xTF32 split that the fp32 flash_attention and ssd_scan kernels run
on the tensor cores (`repro_torch/kernels/csrc/tf32.cuh`), held on the CPU.

A TF32 operand keeps 10 of fp32's 23 mantissa bits.  Each fp32 operand x
is split as hi = tf32(x), lo = tf32(x - hi), and a product a b is taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi, each 8-deep k-step's small terms first,
in an fp32 accumulator (a tf32 x tf32 product is exact in fp32).  Here
that arithmetic is emulated in torch (float32 matmuls of the rounded
operands, one k-step at a time) on seeded inputs at small flash and SSD
shapes, against a float64 result of the same formula: one TF32 product
misses the kernels' tolerances (1e-5 for flash, 2e-4 for the scan, abs +
rel), the split meets them, and the split is as close to float64 as the
plain fp32 product, within 2x.  Two roundings: hi and lo to nearest even,
and the kernels' own, hi half away from zero (cvt.rna) and lo truncated
(the tensor core ignores an operand's low 13 bits, and the kernels hand
lo over unrounded).  The emulation adds in IEEE fp32; the tensor core's
accumulator rounds toward zero, which it does not model: the kernels add
a few k-steps at a time into a fresh accumulator (tf32.cuh), and are held
to their plain versions on the card (`test_torch_kernels_cuda.py`, and
`chip_smoke.py` at the main paths' calls).

The wide scan's kernel (`csrc/ssd_scan_wide.cu`, wgmma) has its own order:
each product's k axis in 32-deep atoms, a fresh accumulator each (4
k-steps), summed by fp32 adds; the state walked over runs of chunks and
carried across them.  `ssd_wide` emulates that order at the mLSTM's heads
(P = N = 192, T = 128) with the tensor core's accumulator modelled as
rounding toward zero, and is held to float64 and to the plain fp32 scan.

Torch and numpy only: no JAX, a few seconds.
"""
import numpy as np
import pytest
import torch

FLASH_TOL = 1e-5
SSD_TOL = 2e-4
K_STEP = 8  # the k depth of mma.sync.m16n8k8


def tf32_round(x: torch.Tensor, ties: str = "even") -> torch.Tensor:
    """float32 -> a value with 10 mantissa bits (the low 13 bits of the
    fp32 word zero): the nearest, ties to even ("even") or away from zero
    ("away", cvt.rna); or x truncated ("trunc", the tensor core's read)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if ties == "even":
        bits = bits + 0xFFF + ((bits >> 13) & 1)
    elif ties == "away":
        bits = bits + 0x1000
    elif ties != "trunc":
        raise ValueError(ties)
    bits = bits & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


# (hi rounding, lo rounding) of a split: round-to-nearest-even for both,
# and the kernels' (tf32.cuh)
SPLITS = {"even": ("even", "even"), "kernel": ("away", "trunc")}


def split(x, ties):
    hi_mode, lo_mode = SPLITS[ties]
    hi = tf32_round(x, hi_mode)
    return hi, tf32_round(x - hi, lo_mode)


def mm_1x(a, b, ties):
    """One TF32 product in an fp32 accumulator."""
    return split(a, ties)[0] @ split(b, ties)[0]


def mm_3x(a, b, ties):
    """3xTF32: per k-step, a_lo b_hi + a_hi b_lo + a_hi b_hi into one fp32
    accumulator, in the kernels' order."""
    ahi, alo = split(a, ties)
    bhi, blo = split(b, ties)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        ks = slice(k0, k0 + K_STEP)
        acc = acc + alo[..., ks] @ bhi[..., ks, :]
        acc = acc + ahi[..., ks] @ blo[..., ks, :]
        acc = acc + ahi[..., ks] @ bhi[..., ks, :]
    return acc


def mm_fp32(a, b, ties):
    return a @ b


def mm_f64(a, b, ties):
    return a @ b


PRODUCTS = {"1xTF32": mm_1x, "3xTF32": mm_3x, "fp32": mm_fp32}


def attention(q, k, v, mm, ties):
    """Causal softmax attention as the fp32 flash kernel forms it: q
    pre-scaled, S = q K^T, mask -1e30, softmax, P V, each product by mm."""
    S, D = q.shape[-2:]
    s = mm(q * (1.0 / D ** 0.5), k.transpose(-1, -2), ties)
    tri = torch.ones((S, S), dtype=torch.bool).tril()
    s = torch.where(tri, s, torch.tensor(-1e30, dtype=s.dtype))
    p = torch.softmax(s, dim=-1)
    return mm(p, v, ties)


def ssd(x, a, b, c, mm, ties, T):
    """The chunked scan's four products per chunk, as the kernel forms
    them: G = mask(C B^T) exp(cum[t] - cum[s]) (fp64 cum, masked before
    exp), y = exp(cum[t]) (C state^T) + G x, state = exp(cum[T-1]) state +
    (x tail)^T B.  x [S, P], a [S], b, c [S, N] of one (b, h)."""
    S, P = x.shape
    N = b.shape[-1]
    dt = x.dtype
    state = torch.zeros((P, N), dtype=dt)
    tri = torch.ones((T, T), dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, S, T):
        xs, bs, cs = x[c0:c0 + T], b[c0:c0 + T], c[c0:c0 + T]
        cum = torch.cumsum(a[c0:c0 + T].double(), 0)
        expo = torch.where(tri, (cum[:, None] - cum[None, :]).to(dt),
                           torch.tensor(float("-inf"), dtype=dt))
        g = mm(cs, bs.T.contiguous(), ties) * torch.exp(expo)
        y = torch.exp(cum.to(dt))[:, None] * mm(cs, state.T.contiguous(),
                                                ties)
        ys.append(y + mm(g, xs, ties))
        tail = torch.exp((cum[-1] - cum).to(dt))
        state = torch.exp(cum[-1].to(dt)) * state + mm(
            (xs * tail[:, None]).T.contiguous(), bs, ties)
    return torch.cat(ys)


def _check(got: dict, want: torch.Tensor, tol: float):
    used = {name: float(((g.double() - want).abs()
                         / (tol + tol * want.abs())).max())
            for name, g in got.items()}
    err = {name: float((g.double() - want).abs().max())
           for name, g in got.items()}
    assert used["1xTF32"] > 1, f"1xTF32 meets the tolerance: {used}"
    assert used["3xTF32"] <= 1, f"3xTF32 misses the tolerance: {used}"
    assert err["3xTF32"] <= 2 * err["fp32"], f"max abs errors {err}"


def test_tf32_round_keeps_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(10000) * 10.0 ** rng.integers(
        -6, 6, 10000)).astype(np.float32))
    for ties in ("even", "away", "trunc"):
        r = tf32_round(x, ties)
        assert not bool((r.view(torch.int32) & 0x1FFF).any())
        bound = 2.0 ** (-10 if ties == "trunc" else -11)
        assert bool(((r - x).abs() <= x.abs() * bound).all())
    # ties: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    half = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11],
                        dtype=torch.float32)
    assert tf32_round(half, "even").tolist() == [1.0, -1.0, 1 + 2 ** -9]
    assert tf32_round(half, "away").tolist() == [
        1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9]
    assert tf32_round(half, "trunc").tolist() == [1.0, -1.0, 1 + 2 ** -10]


@pytest.mark.parametrize("ties", sorted(SPLITS))
def test_split_keeps_21_bits(ties):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    hi, lo = split(x, ties)
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= x.double().abs() * 2.0 ** -20).all())


@pytest.mark.parametrize("ties", sorted(SPLITS))
@pytest.mark.parametrize("S,D", [(128, 128), (96, 112), (64, 64)])
def test_flash_products_need_the_split(ties, S, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, D)).astype(
        np.float32)) for _ in range(3))
    want = attention(q.double(), k.double(), v.double(), mm_f64, ties)
    got = {name: attention(q, k, v, mm, ties)
           for name, mm in PRODUCTS.items()}
    _check(got, want, FLASH_TOL)


@pytest.mark.parametrize("ties", sorted(SPLITS))
@pytest.mark.parametrize("S,T,P,N", [(256, 128, 64, 64), (128, 64, 33, 17)])
def test_ssd_products_need_the_split(ties, S, T, P, N):
    """x, b, c standard normal, a = -softplus(z): the model's decays (a
    chunk's sum near -100 at T = 128), as the card tests draw them."""
    rng = np.random.default_rng(S + P)
    x = torch.from_numpy(rng.standard_normal((S, P)).astype(np.float32))
    a = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal(S).astype(np.float32)))
    b, c = (torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32))
            for _ in range(2))
    want = ssd(x.double(), a.double(), b.double(), c.double(), mm_f64, ties,
               T)
    got = {name: ssd(x, a, b, c, mm, ties, T)
           for name, mm in PRODUCTS.items()}
    _check(got, want, SSD_TOL)


# ---------------------------------------------------------------- wide

ATOM = 32  # the k depth of one fresh wgmma chain in ssd_scan_wide.cu


def rtz(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def chain(a, b, into=None):
    """into + a @ b as ssd_scan_wide.cu forms it: the k axis in 32-deep
    atoms, each a fresh accumulator of 4 k-steps of a_lo b_hi, a_hi b_lo,
    a_hi b_hi (tf32.cuh's split on both operands), each step's 8 products
    exact and added to the fp32 accumulator rounded toward zero (the
    tensor core's accumulator); the atoms added to `into` one by one in
    IEEE fp32."""
    ahi, alo = split(a, "kernel")
    bhi, blo = split(b, "kernel")
    out = into
    for a0 in range(0, a.shape[-1], ATOM):
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
        for k0 in range(a0, min(a0 + ATOM, a.shape[-1]), K_STEP):
            ks = slice(k0, k0 + K_STEP)
            for u, v in ((alo, bhi), (ahi, blo), (ahi, bhi)):
                acc = rtz(acc + u[..., ks].double() @ v[..., ks, :].double()
                          ).double()
        out = acc.float() if out is None else out + acc.float()
    return out


def fmaf(u, v, w):
    """u v + w rounded once to fp32."""
    return (u.double() * v.double() + w.double()).float()


def ssd_wide(x, a, b, c, T, R):
    """ssd_scan_wide.cu's arithmetic for one (b, h): x [S, P], a [S], b, c
    [S, N].  The state launch walks runs of R chunks from zero, the state
    [N][P] scaled by exp(cum[T-1]) then each 32-row atom's (B tail)^T x
    added, writing the partial state entering each chunk and the decay
    since the run's start; the carry turns each run's first slot into the
    true state; the output forms G = mask(C B^T) exp(cum[t] - cum[s]) over
    the N atoms, then y = exp(cum[t]) (C state^T over the N atoms) + G x
    over the s atoms, the state being the partial one plus the decay times
    its run's first slot."""
    S, P = x.shape
    N = b.shape[-1]
    nc = S // T
    tri = torch.ones((T, T), dtype=torch.bool).tril()
    cums = [torch.cumsum(a[ch * T:(ch + 1) * T].double(), 0)
            for ch in range(nc)]
    states, decs = [None] * nc, [None] * nc
    for r0 in range(0, nc - 1, R):  # the state launch, one run at a time
        st = torch.zeros((N, P), dtype=torch.float32)
        dec = torch.ones((), dtype=torch.float32)
        for ch in range(r0, min(r0 + R, nc - 1)):
            cum = cums[ch]
            tot = torch.exp(cum[-1].float())
            tail = torch.exp((cum[-1] - cum).float())
            st, dec = st * tot, dec * tot
            bt = (b[ch * T:(ch + 1) * T] * tail[:, None]).T.contiguous()
            st = chain(bt, x[ch * T:(ch + 1) * T], into=st)
            states[ch + 1], decs[ch + 1] = st.T.contiguous(), dec
    E = torch.zeros((P, N), dtype=torch.float32)
    for c0 in range(R, nc, R):  # the carry over the runs
        E = fmaf(decs[c0], E, states[c0])
        states[c0] = E
    ys = []
    for ch in range(nc):  # the output launch
        cum = cums[ch]
        cs, xs = c[ch * T:(ch + 1) * T], x[ch * T:(ch + 1) * T]
        expo = torch.where(tri, (cum[:, None] - cum[None, :]).float(),
                           torch.tensor(float("-inf")))
        g = chain(cs, b[ch * T:(ch + 1) * T].T.contiguous())
        g = torch.where(tri, g * torch.exp(expo), torch.zeros(()))
        y = torch.zeros((T, P), dtype=torch.float32)
        if ch > 0:
            st = states[ch]
            if ch > R and ch % R:
                st = fmaf(decs[ch], states[ch // R * R], st)
            y = chain(cs, st.T.contiguous())
        y = y * torch.exp(cum.float())[:, None]
        ys.append(chain(g, xs, into=y))
    return torch.cat(ys)


def test_wide_kernel_order_holds_the_tolerance():
    """The mLSTM's heads (P = N = 192, T = 128) over 4 chunks in runs of
    2 (a partial state, a carried one and a corrected one), inputs drawn
    as chip_smoke.py draws long_500k's call: x = v sigmoid(i), a = log
    sigmoid(f), b = k, c = q / sqrt(P).  The kernel's order is within 2e-4
    of float64 and within 2x of the plain fp32 scan's distance to it."""
    rng = np.random.default_rng(192)
    S, T, P, N, R = 512, 128, 192, 192, 2

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    x = randn(S, P) * torch.sigmoid(randn(S))[:, None]
    a = torch.nn.functional.logsigmoid(randn(S))
    b = randn(S, N)
    c = randn(S, N) / N ** 0.5
    want = ssd(x.double(), a.double(), b.double(), c.double(), mm_f64,
               "kernel", T)
    got = ssd_wide(x, a, b, c, T, R)
    plain = ssd(x, a, b, c, mm_fp32, "kernel", T)
    err = float((got.double() - want).abs().max())
    err32 = float((plain.double() - want).abs().max())
    used = float(((got.double() - want).abs()
                  / (SSD_TOL + SSD_TOL * want.abs())).max())
    assert used <= 1, f"the wide kernel's order misses 2e-4: {used}"
    assert err <= 2 * err32, f"max abs errors: kernel order {err}, " \
        f"fp32 {err32}"
