"""The port's xLSTM family (xlstm-125m) against the JAX package (CPU).

The reference's `init_params(cfg, PRNGKey(0))` for the SMOKE xLSTM (one
pair of an mLSTM block, 2 heads of 32, and an sLSTM block; d_model 64) is
carried into the port through `bridge.lm_from_numpy`; the same seeded
inputs then go through both packages:

  * configs field for field, the full-width leaf count on `meta`, the
    bridge's round trip;
  * `mlstm_block` at the mLSTM's full head width (d 384 over 2 heads of
    192, the reference's `mlstm_init(PRNGKey(1))`) with `chunk=16` over
    S = 64, so the state crosses three chunk borders, on the plain and
    the kernel path (the port's CPU tensors take the plain version);
    `slstm_block`, `mlstm_step` and `slstm_step`, the steps also against
    the blocks position by position;
  * the SMOKE `forward` on both paths at S = 64, `decode_step` step by
    step, prefill against decode, and the `Engine`'s greedy outputs;
  * two faults of the reference, pinned (ROADMAP.md Queue 3): its xLSTM
    is NaN from S = 128 (the chunked SSD's unmasked exp), while the port
    stays finite and equal to a float64 sequential recurrence; and a
    recycled `Engine` slot starts from the previous request's mLSTM and
    sLSTM state, in both packages.

The full model is compared at S <= 64 only: a chunk of 128 decays
log sigmoid(z), z about N(0, 1), sums to about -100, past the -88.7 where
the reference's exp overflows.  Tolerance: 1e-4 abs/rel on fp32 logits
and mixer outputs (sums in another order); token ids exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.decode_engine import Engine as JEngine
from repro.models.decode_engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.models import registry, ssm, transformer
from repro_torch.models.decode_engine import Engine, ServeConfig

TOL = 1e-4
ARCH = "xlstm-125m"
FULL_WIDTH_PARAMS = 123_320_064   # leaves of the reference's init_params
PARAM_COUNT = 133_890_048         # the reference's param_count()


@pytest.fixture(scope="module")
def lm():
    jcfg = jregistry.get(ARCH, smoke=True)
    params, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.array, params)
    cfg = registry.get(ARCH, smoke=True)
    model = bridge.lm_from_numpy(cfg, params, device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def wide():
    """One mLSTM and one sLSTM block at the mLSTM's full head width: the
    SMOKE config with d_model 384 over its 2 heads (192 each)."""
    jcfg = dataclasses.replace(jregistry.get(ARCH, smoke=True), d_model=384)
    mp, _ = jssm.mlstm_init(jax.random.PRNGKey(1), jcfg)
    sp, _ = jssm.slstm_init(jax.random.PRNGKey(2), jcfg)
    mp = {k: np.asarray(v) for k, v in mp.items()}
    sp = {k: np.asarray(v) for k, v in sp.items()}
    cfg = dataclasses.replace(registry.get(ARCH, smoke=True), d_model=384)
    m = ssm.MLSTM(*(torch.tensor(mp[n]) for n in ssm.MLSTM_PARAMS))
    s = ssm.SLSTM(*(torch.tensor(sp[n]) for n in ssm.SLSTM_PARAMS))
    m.requires_grad_(False)
    s.requires_grad_(False)
    return jcfg, mp, sp, cfg, m, s


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference_field_for_field(smoke):
    assert dataclasses.asdict(registry.get(ARCH, smoke)) == \
        dataclasses.asdict(jregistry.get(ARCH, smoke))


def test_full_width_param_count_on_meta():
    """The meta build has every leaf of the reference's init_params; the
    reference's analytic param_count() overcounts it: it prices a block
    as 8 d^2, while a pair holds 5 d^2 + 2 H d (mLSTM) and 8 d^2 (sLSTM)
    for two blocks (ROADMAP.md Queue 3)."""
    cfg = registry.get(ARCH)
    model = transformer.init_params(cfg, device="meta")
    assert isinstance(model, transformer.XLSTMLM) and len(model.pairs) == 6
    n = sum(p.numel() for p in model.parameters())
    jcfg = jregistry.get(ARCH)
    shapes = jax.eval_shape(
        lambda k: jtransformer.init_params(jcfg, k)[0],
        jax.random.PRNGKey(0))
    leaves = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n == leaves == FULL_WIDTH_PARAMS
    assert cfg.param_count() == jcfg.param_count() == PARAM_COUNT > n
    assert model.pairs[0].m.wq.shape == (768, 768)
    assert cfg.d_model // cfg.n_heads == 192  # the wide scan's heads


def test_bridge_round_trip(lm):
    _, params, _, model = lm
    back = bridge.lm_to_numpy(model)
    flat, tree = jax.tree.flatten(params)
    flat2, tree2 = jax.tree.flatten(back)
    assert tree == tree2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mlstm_block_at_head_dim_192_over_chunks(wide, use_kernel):
    jcfg, mp, _, cfg, m, _ = wide
    x = _x(2, 64, cfg.d_model, seed=3)
    want = jssm.mlstm_block({k: jnp.asarray(v) for k, v in mp.items()},
                            jnp.asarray(x), jcfg, chunk=16)
    assert np.isfinite(np.asarray(want)).all()
    ops.reset_launches()
    got = ssm.mlstm_block(m, torch.from_numpy(x), cfg, chunk=16,
                          use_kernel=use_kernel)
    assert ops.LAUNCHES["ssd_scan"] == 0  # CPU: the plain version
    _close(got, want)


def test_slstm_block_equals_reference(wide):
    jcfg, _, sp, cfg, _, s = wide
    x = _x(2, 24, cfg.d_model, seed=4)
    want = jssm.slstm_block({k: jnp.asarray(v) for k, v in sp.items()},
                            jnp.asarray(x), jcfg)
    _close(ssm.slstm_block(s, torch.from_numpy(x), cfg), want)


def test_steps_equal_reference_and_blocks(wide):
    """Token by token, mlstm_step and slstm_step equal the JAX steps and
    the port's blocks at every position, and end in the JAX states."""
    jcfg, mp, sp, cfg, m, s = wide
    jm = {k: jnp.asarray(v) for k, v in mp.items()}
    js = {k: jnp.asarray(v) for k, v in sp.items()}
    x = _x(2, 12, cfg.d_model, seed=5)
    full_m = ssm.mlstm_block(m, torch.from_numpy(x), cfg, chunk=4)
    full_s = ssm.slstm_block(s, torch.from_numpy(x), cfg)
    mst, sst = (ssm.mlstm_init_state(cfg, 2, device="cpu"),
                ssm.slstm_init_state(cfg, 2, device="cpu"))
    jmst, jsst = jssm.mlstm_init_state(jcfg, 2), jssm.slstm_init_state(jcfg, 2)
    assert mst.state.shape == jmst.state.shape == (2, 2, 192, 192)
    assert mst.state.dtype == sst.h.dtype == sst.c.dtype == torch.float32
    for t in range(12):
        xt = x[:, t:t + 1]
        got_m, mst = ssm.mlstm_step(m, torch.from_numpy(xt), cfg, mst)
        want_m, jmst = jssm.mlstm_step(jm, jnp.asarray(xt), jcfg, jmst)
        got_s, sst = ssm.slstm_step(s, torch.from_numpy(xt), cfg, sst)
        want_s, jsst = jssm.slstm_step(js, jnp.asarray(xt), jcfg, jsst)
        _close(got_m, want_m)
        _close(got_s, want_s)
        _close(got_m[:, 0], full_m[:, t])
        _close(got_s[:, 0], full_s[:, t])
    _close(mst.state, jmst.state)
    _close(sst.c, jsst.c)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_equals_reference(lm, use_kernel):
    jcfg, params, cfg, model = lm
    tok = _tokens(cfg, 2, 64, seed=1)
    want, _ = jtransformer.forward(jcfg, params, {"tokens": jnp.asarray(tok)},
                                   use_kernel=use_kernel)
    assert np.isfinite(np.asarray(want)).all()
    ops.reset_launches()
    got, aux = transformer.forward(cfg, model,
                                   {"tokens": torch.from_numpy(tok)},
                                   use_kernel=use_kernel)
    assert ops.LAUNCHES == dict.fromkeys(ops.KERNELS, 0)  # CPU: plain
    assert got.shape == (2, 64, cfg.vocab) and float(aux) == 0.0
    _close(got, want)


def test_decode_step_equals_reference(lm):
    jcfg, params, cfg, model = lm
    B, steps = 2, 10
    tok = _tokens(cfg, B, steps, seed=2)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(jcfg, p, s, t))
    jstate = jtransformer.init_decode_state(jcfg, B, 16, dtype=jnp.bfloat16)
    state = transformer.init_decode_state(cfg, B, 16, dtype=torch.bfloat16,
                                          device="cpu")
    assert len(state["m"]) == len(state["s"]) == 1
    assert state["m"][0].state.dtype == state["s"][0].h.dtype == \
        torch.float32  # the requested dtype is ignored, as in the reference
    for i in range(steps):
        want, jstate = step(params, jstate, jnp.asarray(tok[:, i:i + 1]))
        got, state = transformer.decode_step(
            cfg, model, state, torch.from_numpy(tok[:, i:i + 1]))
        assert got.shape == (B, 1, cfg.vocab)
        _close(got, want)
    assert state["pos"] == int(jstate["pos"]) == steps
    _close(state["m"][0].state, jstate["m"].state[0])
    _close(state["s"][0].h, jstate["s"].h[0])


def test_prefill_last_logits_equal_decode(lm):
    """Causal: forward's logits at position i are the decode step's that
    fed token i (the check chip_smoke runs at full width on the card)."""
    _, _, cfg, model = lm
    tok = torch.from_numpy(_tokens(cfg, 2, 16, seed=3))
    full, _ = transformer.forward(cfg, model, {"tokens": tok},
                                  use_kernel=True)
    state = transformer.init_decode_state(cfg, 2, 16, device="cpu")
    for i in range(16):
        got, state = transformer.decode_step(cfg, model, state,
                                             tok[:, i:i + 1])
        _close(got[:, 0], full[:, i])


def _sequential(x, a, b, c):
    """state[t] = exp(a[t]) state[t-1] + x[t] b[t]^T, y[t] = state[t] c[t],
    one position at a time in float64."""
    x, a, b, c = (torch.as_tensor(np.asarray(v), dtype=torch.float64)
                  for v in (x, a, b, c))
    B, S, H, P = x.shape
    state = torch.zeros((B, H, P, b.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(S):
        state = state * torch.exp(a[:, t])[:, :, None, None] + (
            x[:, t, :, :, None] * b[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1)


def test_reference_is_nan_from_s128_and_the_port_is_not(lm, monkeypatch):
    """The SMOKE xLSTM at S = 128 (tokens from default_rng(0)): every
    logit row of the reference is NaN, since its chunked SSD forms
    exp(cum[t] - cum[s]) above the diagonal before the mask and a chunk
    of 128 forget-gate log-decays sums past -88.7 (ROADMAP.md Queue 3).
    The port masks before exp: its logits are finite, and its mLSTM scan
    equals a float64 sequential recurrence of the same inputs (2e-4, the
    scan's tolerance), where the reference's scan of them is NaN."""
    jcfg, params, cfg, model = lm
    tok = _tokens(cfg, 2, 128, seed=0)
    want, _ = jtransformer.forward(jcfg, params, {"tokens": jnp.asarray(tok)})
    assert int(np.isnan(np.asarray(want)).any(-1).sum()) == 2 * 128
    scans = []
    plain = ssm.ssd_chunked

    def recording(*args, **kwargs):
        y = plain(*args, **kwargs)
        scans.append((args, y))
        return y

    monkeypatch.setattr(ssm, "ssd_chunked", recording)
    got, _ = transformer.forward(cfg, model, {"tokens": torch.from_numpy(tok)})
    assert bool(torch.isfinite(got).all())
    (args, y), = scans
    assert float(args[1].sum(1).max()) < -88.7  # a chunk's decays, summed
    assert np.isnan(np.asarray(jssm.ssd_chunked(
        *(jnp.asarray(v.numpy()) for v in args), chunk=128))).any()
    _close(y, _sequential(*args), tol=2e-4)


def test_decode_builds_no_rope_tables(lm, monkeypatch):
    """The xLSTM family attends nowhere: decode and prefill build no
    rotary tables (at xlstm-125m's max_seq of 2^20 a step would build
    0.8 GB of them)."""
    _, _, cfg, model = lm

    def refuse(*args, **kwargs):
        raise AssertionError("rope tables built")

    monkeypatch.setattr(transformer.layers, "rope_freqs", refuse)
    tok = torch.from_numpy(_tokens(cfg, 1, 4, seed=4))
    state = transformer.init_decode_state(cfg, 1, 8, device="cpu")
    transformer.decode_step(cfg, model, state, tok[:, :1])
    transformer.forward(cfg, model, {"tokens": tok})


@pytest.fixture(scope="module")
def engine_runs(lm):
    jcfg, params, cfg, model = lm
    jmodel = jax.tree.map(jnp.asarray, params)

    def both(slots, prompts, steps, eos=0):
        out = []
        for engine_cls, serve_cls, c, m, kw in (
                (JEngine, JServeConfig, jcfg, jmodel, {}),
                (Engine, ServeConfig, cfg, model, {"device": "cpu"})):
            eng = engine_cls(c, m, serve_cls(max_len=64, temperature=0.0,
                                             eos_token=eos),
                             batch_slots=slots, **kw)
            for p in prompts:
                eng.submit(p)
            out.append([list(o) for o in eng.run(max_new_tokens=steps)])
        return out

    return both


@pytest.mark.parametrize("scenario", ["solo", "two_slots"])
def test_engine_greedy_equals_reference(engine_runs, scenario):
    slots, prompts = {"solo": (1, [[5, 6, 7]]),
                      "two_slots": (2, [[5, 6, 7], [11, 12]])}[scenario]
    want, got = engine_runs(slots, prompts, 12)
    assert got == want
    assert all(len(o) > 0 for o in got)


def test_recycled_slot_keeps_the_previous_requests_state(lm):
    """One slot, two queued requests; the EOS is the first request's
    second token, so it ends after 3 prompt steps and 2 tokens and the
    slot takes the second.  `_admit` resets no state, so the second
    request's first step reads the first's mLSTM and sLSTM state, and its
    logits differ from those of the same request alone, in both packages
    (a fault of the reference, ROADMAP.md Queue 3, that the port
    mirrors)."""
    jcfg, params, cfg, model = lm
    jmodel = jax.tree.map(jnp.asarray, params)
    first, second = [5, 6, 7], [11, 12]
    per_package = []
    for engine_cls, serve_cls, c, m, kw in (
            (JEngine, JServeConfig, jcfg, jmodel, {}),
            (Engine, ServeConfig, cfg, model, {"device": "cpu"})):
        probe = engine_cls(c, m, serve_cls(max_len=64), batch_slots=1, **kw)
        probe.submit(first)
        eos = probe.run(max_new_tokens=len(first) + 1)[0][1]
        runs = {}
        for name, prompts in (("recycled", [first, second]),
                              ("alone", [second])):
            eng = engine_cls(c, m, serve_cls(max_len=64, eos_token=eos),
                             batch_slots=1, **kw)
            for p in prompts:
                eng.submit(p)
            seen = []  # (the state fed in, the logits) of every step
            step = eng._step

            def recording(*args, step=step, seen=seen):
                logits, state = step(*args)
                seen.append((args[-2], np.asarray(logits[0, -1],
                                                  np.float32)))
                return logits, state

            eng._step = recording
            eng.run(max_new_tokens=12)
            runs[name] = seen
        # the recycled run's step that feeds the second request's first
        # token, against the alone run's first step
        at = len(first) - 1 + 2
        state_in, logits = runs["recycled"][at]
        m_state = np.asarray(state_in["m"][0].state if isinstance(
            state_in["m"], list) else state_in["m"].state[0], np.float32)
        s_c = np.asarray(state_in["s"][0].c if isinstance(
            state_in["s"], list) else state_in["s"].c[0], np.float32)
        assert np.abs(m_state).max() > 0 and np.abs(s_c).max() > 0
        alone = runs["alone"][0][1]
        assert np.abs(logits - alone).max() > 1e-3
        per_package.append(logits)
    _close(per_package[1], per_package[0])
