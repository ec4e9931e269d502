"""The port's ssd_scan and Mamba-2 mixer against the JAX package (CPU).

`repro_torch.kernels.ops.ssd_scan` on CPU tensors takes its plain version
(`ref.ssd_scan_ref`, which is also `models.ssm.ssd_chunked`); here it is
held, on inputs made by numpy from a seed, to

  * the JAX `models.ssm.ssd_chunked` (the jnp mirror the model runs),
  * the JAX Pallas `kernels.ssd_scan` in interpret mode (as
    `tests/test_kernels.py` runs it),
  * the JAX sequential oracle `kernels.ref.ssd_scan_ref`,
  * and a sequential oracle of this file (`_sequential`, the same
    recurrence as the JAX oracle, one token at a time in float64),

at decays where the reference stays finite, and pinned where it does not:
the reference forms exp(cum[t] - cum[s]) above the diagonal before the
mask, so a chunk whose decays sum below about -88.7 gives NaN there
(ROADMAP.md Queue 3), while the port masks before exp and stays equal to
the sequential oracle.  The same holds at the mLSTM's head width (P = N =
192, xlstm-125m) and with P != N, where the card runs the wide kernel; a
float64 model of that kernel's three launches (chunk states, carry,
output; 64-wide tiles of P and N) is held to the sequential oracle.  The
Mamba-2 block and its one-token step are held to the JAX ones with the
same weights.  Tolerance: 2e-4 abs/rel, the
reference's own Pallas-against-oracle tolerance (`tests/test_kernels.py`):
the chunked and sequential forms sum in other orders.  The CUDA kernel is
held to the plain version on the card (`tests/test_torch_kernels_cuda.py`,
`chip_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import ssm as jssm
from repro.models import registry as jregistry
from repro_torch.kernels import ops
from repro_torch.models import registry, ssm

TOL = 2e-4


def _inputs(B, S, H, P, N, seed, a=None):
    """x, b, c standard normal; a the reference test's decays
    -|N(0, 1)| * 0.1 unless given."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    if a is None:
        a = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    b = rng.standard_normal((B, S, H, N)).astype(np.float32)
    c = rng.standard_normal((B, S, H, N)).astype(np.float32)
    return x, np.broadcast_to(a, (B, S, H)).astype(np.float32), b, c


def _sequential(x, a, b, c):
    """state[t] = exp(a[t]) state[t-1] + x[t] b[t]^T, y[t] = state[t] c[t]:
    the recurrence of the JAX `ref.ssd_scan_ref`, in float64."""
    x, a, b, c = (torch.from_numpy(np.asarray(v, np.float64))
                  for v in (x, a, b, c))
    B, S, H, P = x.shape
    state = torch.zeros((B, H, P, b.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(S):
        state = state * torch.exp(a[:, t])[:, :, None, None] + (
            x[:, t, :, :, None] * b[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _port(x, a, b, c, **kw):
    return ops.ssd_scan(*(torch.from_numpy(np.ascontiguousarray(v))
                          for v in (x, a, b, c)), **kw)


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("S", [32, 128, 256])
def test_port_equals_chunked_pallas_and_oracles(S, chunk):
    x, a, b, c = _inputs(2, S, 3, 8, 4, seed=S + chunk)
    ops.reset_launches()
    got = _port(x, a, b, c, chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == 0  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(got, ssm.ssd_chunked(
        *map(torch.from_numpy, (x, a, b, c)), chunk=chunk))
    jx = [jnp.asarray(v) for v in (x, a, b, c)]
    _close(got, jssm.ssd_chunked(*jx, chunk=chunk))
    _close(got, pallas_ssd(*jx, chunk=min(chunk, S), interpret=True))
    _close(got, jref.ssd_scan_ref(*jx))
    _close(got, _sequential(x, a, b, c))


@pytest.mark.parametrize("P,N", [(192, 192), (192, 64)])
@pytest.mark.parametrize("S,chunk", [(128, 128), (256, 128), (256, 32)])
def test_wide_heads_equal_chunked_pallas_and_oracles(S, chunk, P, N):
    """The mLSTM's 192-wide heads (and P != N): one chunk and many."""
    x, a, b, c = _inputs(1, S, 2, P, N, seed=P + N + S + chunk)
    got = _port(x, a, b, c, chunk=chunk)
    assert got.shape == x.shape
    jx = [jnp.asarray(v) for v in (x, a, b, c)]
    _close(got, jssm.ssd_chunked(*jx, chunk=chunk))
    _close(got, pallas_ssd(*jx, chunk=min(chunk, S), interpret=True))
    _close(got, _sequential(x, a, b, c))


def _wide_kernel_model(x, a, b, c, chunk, W=64):
    """csrc/ssd_scan_wide.cu's three launches in float64, tile by tile:
    1. each chunk but the last: its hand-on sum_s exp(cum[T-1] - cum[s])
       x[s] B[s]^T into states[ch], a (P tile, N tile) at a time, and its
       total decay exp(cum[T-1]);
    2. in chunk order, states[ch] <- s, s = total[ch] s + states[ch];
    3. per (chunk, P tile): G = C B^T summed over the N tiles, masked
       before exp, and y = exp(cum[t]) C states[ch]^T (over the N tiles)
       + G x."""
    x, a, b, c = (torch.as_tensor(np.asarray(v), dtype=torch.float64)
                  for v in (x, a, b, c))
    B, S, H, P = x.shape
    N = b.shape[-1]
    T = min(chunk, S)
    nc = S // T
    xq, bq, cq = (v.reshape(B, nc, T, H, -1) for v in (x, b, c))
    cum = torch.cumsum(a.reshape(B, nc, T, H), dim=2)
    states = torch.zeros((B, H, nc, P, N), dtype=torch.float64)
    totals = torch.exp(cum[:, :, -1]).transpose(1, 2)  # [B, H, nc]
    xt = xq * torch.exp(cum[:, :, -1:] - cum)[..., None]
    for p0 in range(0, P, W):
        for n0 in range(0, N, W):
            states[:, :, :nc - 1, p0:p0 + W, n0:n0 + W] = torch.einsum(
                "bgshp,bgshn->bhgpn", xt[:, :nc - 1, ..., p0:p0 + W],
                bq[:, :nc - 1, ..., n0:n0 + W])
    s = torch.zeros((B, H, P, N), dtype=torch.float64)
    for ch in range(nc):
        upd = states[:, :, ch].clone()
        states[:, :, ch] = s
        s = totals[:, :, ch, None, None] * s + upd
    tri = torch.ones((T, T), dtype=torch.bool).tril()
    y = torch.empty_like(x)
    for ch in range(nc):
        expo = cum[:, ch, :, None, :] - cum[:, ch, None, :, :]  # [B,T,T,H]
        decay = torch.exp(torch.where(tri[:, :, None], expo,
                                      float("-inf"))).permute(0, 3, 1, 2)
        for p0 in range(0, P, W):
            G = torch.zeros((B, H, T, T), dtype=torch.float64)
            ys = torch.zeros((B, H, T, min(W, P - p0)), dtype=torch.float64)
            for n0 in range(0, N, W):
                ct = cq[:, ch, ..., n0:n0 + W]
                G += torch.einsum("bthn,bshn->bhts", ct,
                                  bq[:, ch, ..., n0:n0 + W])
                ys += torch.einsum("bthn,bhpn->bhtp", ct,
                                   states[:, :, ch, p0:p0 + W, n0:n0 + W])
            out = ys * torch.exp(cum[:, ch]).transpose(1, 2)[..., None] + \
                torch.einsum("bhts,bshp->bhtp", G * decay,
                             xq[:, ch, ..., p0:p0 + W])
            y[:, ch * T:(ch + 1) * T, :, p0:p0 + W] = out.transpose(1, 2)
    return y


@pytest.mark.parametrize("S,chunk,P,N", [(96, 32, 130, 70), (32, 32, 192, 192),
                                         (120, 40, 65, 200)])
def test_wide_kernel_design_equals_the_recurrence(S, chunk, P, N):
    """The wide kernel's split (chunk states, an ordered carry, then every
    chunk's output in 64-wide P tiles with C B^T summed over 64-wide N
    tiles) is the scan: equal to the float64 sequential oracle, one chunk
    and several, ragged tiles and a chunk that is not a power of two."""
    x, a, b, c = _inputs(2, S, 2, P, N, seed=S + P + N)
    model = _wide_kernel_model(x, a, b, c, chunk)
    torch.testing.assert_close(model, _sequential(x, a, b, c), rtol=1e-9,
                               atol=1e-9)
    _close(_port(x, a, b, c, chunk=chunk), model)


def test_overflow_of_the_reference_is_pinned():
    """Constant decay -0.75 over a 128-row chunk: 127 x 0.75 > 88.7, so
    exp(cum[t] - cum[s]) above the diagonal overflows in the reference's
    chunked forms (NaN from inf * 0), not in the port."""
    x, a, b, c = _inputs(1, 128, 2, 4, 4, seed=0, a=np.float32(-0.75))
    jx = [jnp.asarray(v) for v in (x, a, b, c)]
    assert np.isnan(np.asarray(jssm.ssd_chunked(*jx, chunk=128))).any()
    assert np.isnan(np.asarray(pallas_ssd(*jx, chunk=128,
                                          interpret=True))).any()
    got = _port(x, a, b, c, chunk=128)
    assert bool(torch.isfinite(got).all())
    _close(got, _sequential(x, a, b, c))
    _close(got, jref.ssd_scan_ref(*jx))  # the sequential oracle is finite


def test_chunk_rule_is_refused_on_both_paths():
    """Q = min(chunk, S) and S % Q != 0 raises, as the reference asserts."""
    x, a, b, c = _inputs(1, 96, 2, 4, 4, seed=1)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, (x, a, b, c)), chunk=64)
    tx = [torch.from_numpy(v) for v in (x, a, b, c)]
    for call in (lambda: ops.ssd_scan(*tx, chunk=64),
                 lambda: ops.ssd_scan(*tx, chunk=64, backend="torch"),
                 lambda: ssm.ssd_chunked(*tx, chunk=64)):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            call()
    assert _port(x, a, b, c, chunk=32).shape == x.shape  # 96 = 3 x 32
    assert _port(x, a, b, c, chunk=128).shape == x.shape  # Q = S = 96
    with pytest.raises(ValueError, match="unknown"):
        ops.ssd_scan(*tx, chunk=32, backend="pallas")


@pytest.fixture(scope="module")
def mixer():
    """One Mamba-2 layer of the SMOKE zamba2 from the reference's init,
    with a_bias set so that the reference's chunks stay finite."""
    jcfg = jregistry.get("zamba2-7b", smoke=True)
    p, _ = jssm.mamba2_init(jax.random.PRNGKey(3), jcfg)
    p = {k: np.asarray(v) for k, v in p.items()}
    p["a_bias"] = np.full_like(p["a_bias"], -3.0)
    cfg = registry.get("zamba2-7b", smoke=True)
    port = ssm.Mamba2(*(torch.tensor(p[n]) for n in ssm.MAMBA2_PARAMS))
    port.requires_grad_(False)
    return jcfg, {k: jnp.asarray(v) for k, v in p.items()}, cfg, port


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_block_equals_reference(mixer, use_kernel):
    jcfg, jp, cfg, port = mixer
    x = np.random.default_rng(4).standard_normal((2, 256, cfg.d_model))
    x = x.astype(np.float32)
    want = jssm.mamba2_block(jp, jnp.asarray(x), jcfg)
    got = ssm.mamba2_block(port, torch.from_numpy(x), cfg,
                           use_kernel=use_kernel)
    _close(got, want)


def test_mamba2_step_equals_reference_and_block(mixer):
    """Token by token, the decode step equals the JAX step and the
    chunked block at every position."""
    jcfg, jp, cfg, port = mixer
    x = np.random.default_rng(5).standard_normal((2, 12, cfg.d_model))
    x = x.astype(np.float32)
    full = ssm.mamba2_block(port, torch.from_numpy(x), cfg, chunk=4)
    st = ssm.mamba2_init_state(cfg, 2, device="cpu")
    jst = jssm.mamba2_init_state(jcfg, 2)
    assert st.state.shape == jst.state.shape and st.state.dtype == \
        torch.float32
    for t in range(12):
        got, st = ssm.mamba2_step(port, torch.from_numpy(x[:, t:t + 1]),
                                  cfg, st)
        want, jst = jssm.mamba2_step(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                     jst)
        _close(got, want)
        _close(got[:, 0], full[:, t])
    _close(st.state, jst.state)


def test_xlstm_half_raises():
    """The xLSTM half runs (tests/test_torch_xlstm.py) and, like the
    Mamba-2 half, raises where the reference asserts: a sequence that is
    not a multiple of min(chunk, S)."""
    jcfg = jregistry.get("xlstm-125m", smoke=True)
    p, _ = jssm.mlstm_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(6).standard_normal((1, 96, jcfg.d_model))
    x = x.astype(np.float32)
    with pytest.raises(AssertionError):
        jssm.mlstm_block(p, jnp.asarray(x), jcfg, chunk=64)
    cfg = registry.get("xlstm-125m", smoke=True)
    port = ssm.MLSTM(*(torch.tensor(np.asarray(p[n]))
                       for n in ssm.MLSTM_PARAMS))
    for use_kernel in (False, True):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            ssm.mlstm_block(port, torch.from_numpy(x), cfg, chunk=64,
                            use_kernel=use_kernel)
