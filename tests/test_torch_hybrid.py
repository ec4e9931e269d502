"""The port's hybrid family (zamba2) against the JAX package (CPU, SMOKE).

The reference's `init_params(cfg, PRNGKey(0))` for the SMOKE zamba2 (7
Mamba-2 layers in 2 groups of 3 and a tail of 1, one shared attention +
GLU block after each group) is carried into the port through
`bridge.lm_from_numpy`; the same seeded tokens then go through both
packages:

  * `forward` logits at S = 256 (two chunks of 128), with the plain path
    (`use_kernel=False`) and the kernel path (`use_kernel=True`: the JAX
    side runs the Pallas flash kernel in interpret mode through
    REPRO_KERNELS=pallas, its Mamba-2 layers the jnp `ssd_chunked`; the
    port's CPU tensors take the kernels' plain versions);
  * `decode_step` logits step by step, and prefill against decode;
  * the `Engine`'s greedy outputs on `tests/test_decode_engine.py`'s
    scenarios (solo, admission mid-decode, the late request alone);
  * configs field for field, the full-width parameter count, the bridge.

The bridged `a_bias` is set to -3 in every Mamba-2 layer (decays
-softplus(z - 3) with z about N(0, 1), -0.08 a token on average): with
the reference's init of 0 a chunk of 128 decays sums to about -100, where
the reference's chunked scan overflows (every logit of this fixture is
NaN then; ROADMAP.md Queue 3, pinned in `tests/test_torch_ssd_scan.py`);
at -3 the reference stays finite at S = 256 and both packages can be
compared.
Tolerance: 1e-4 abs/rel on fp32 logits (sums in another order); token ids
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.models.decode_engine import Engine as JEngine
from repro.models.decode_engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.models import registry, transformer
from repro_torch.models.decode_engine import Engine, ServeConfig

TOL = 1e-4
ARCH = "zamba2-7b"
A_BIAS = -3.0
FULL_WIDTH_PARAMS = 10_872_216_432   # leaves of the reference's init_params
PARAM_COUNT = 6_770_491_392          # the reference's param_count()


@pytest.fixture(scope="module")
def lm():
    jcfg = jregistry.get(ARCH, smoke=True)
    params, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.array, params)
    for stack in (params["mamba"], params["mamba_tail"]):
        stack["mixer"]["a_bias"][...] = A_BIAS
    cfg = registry.get(ARCH, smoke=True)
    model = bridge.lm_from_numpy(cfg, params, device="cpu")
    return jcfg, params, cfg, model


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


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
    reference's analytic param_count() undercounts it, since it prices
    the B/C projections as d_in (2 N + 32) and not d x H N each
    (ROADMAP.md Queue 3)."""
    cfg = registry.get(ARCH)
    model = transformer.init_params(cfg, device="meta")
    assert isinstance(model, transformer.HybridLM)
    n = sum(p.numel() for p in model.parameters())
    jcfg = jregistry.get(ARCH)
    shapes = jax.eval_shape(
        lambda k: jtransformer.init_params(jcfg, k)[0],
        jax.random.PRNGKey(0))
    leaves = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n == leaves == FULL_WIDTH_PARAMS
    assert cfg.param_count() == jcfg.param_count() == PARAM_COUNT < n
    assert len(model.mamba) == 13 and len(model.mamba[0]) == 6
    assert len(model.mamba_tail) == 3


def test_bridge_round_trip(lm):
    _, params, _, model = lm
    back = bridge.lm_to_numpy(model)
    flat, tree = jax.tree.flatten(params)
    flat2, tree2 = jax.tree.flatten(back)
    assert tree == tree2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_equals_reference(lm, monkeypatch, use_kernel):
    jcfg, params, cfg, model = lm
    tok = _tokens(cfg, 2, 256, seed=1)
    if use_kernel:  # the reference's flash branch: Pallas, interpret mode
        monkeypatch.setenv("REPRO_KERNELS", "pallas")
    want, _ = jtransformer.forward(jcfg, params, {"tokens": jnp.asarray(tok)},
                                   use_kernel=use_kernel)
    assert np.isfinite(np.asarray(want)).all()
    ops.reset_launches()
    got, aux = transformer.forward(cfg, model,
                                   {"tokens": torch.from_numpy(tok)},
                                   use_kernel=use_kernel)
    assert ops.LAUNCHES == dict.fromkeys(ops.KERNELS, 0)  # CPU: plain
    assert got.shape == (2, 256, cfg.vocab) and float(aux) == 0.0
    _close(got, want)


def test_forward_refuses_a_ragged_chunk(lm):
    """S = 200 is not a multiple of min(128, S): both packages refuse."""
    jcfg, params, cfg, model = lm
    tok = _tokens(cfg, 1, 200, seed=2)
    with pytest.raises(AssertionError):
        jtransformer.forward(jcfg, params, {"tokens": jnp.asarray(tok)})
    for use_kernel in (False, True):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            transformer.forward(cfg, model, {"tokens": torch.from_numpy(tok)},
                                use_kernel=use_kernel)


def test_decode_step_equals_reference(lm):
    jcfg, params, cfg, model = lm
    B, steps = 2, 10
    tok = _tokens(cfg, B, steps, seed=3)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(jcfg, p, s, t))
    jstate = jtransformer.init_decode_state(jcfg, B, 16, dtype=jnp.float32)
    state = transformer.init_decode_state(cfg, B, 16, dtype=torch.float32,
                                          device="cpu")
    assert len(state["mamba"]) == 2 and len(state["mamba_tail"]) == 1
    assert state["mamba"][0][0].state.dtype == torch.float32
    for i in range(steps):
        want, jstate = step(params, jstate, jnp.asarray(tok[:, i:i + 1]))
        got, state = transformer.decode_step(
            cfg, model, state, torch.from_numpy(tok[:, i:i + 1]))
        assert got.shape == (B, 1, cfg.vocab)
        _close(got, want)
    assert state["pos"] == int(jstate["pos"]) == steps
    _close(state["mamba"][1][2].state, jstate["mamba"].state[1, 2])
    _close(state["mamba_tail"][0].state, jstate["mamba_tail"].state[0])
    _close(state["shared_cache"][1].k, jstate["shared_cache"].k[1])


def test_prefill_last_logits_equal_decode(lm):
    """Causal: forward's logits at position i are the decode step's that
    fed token i (the check chip_smoke runs at full width on the card);
    decode runs `mamba2_step` token by token against the chunked scan."""
    _, _, cfg, model = lm
    tok = torch.from_numpy(_tokens(cfg, 2, 16, seed=4))
    full, _ = transformer.forward(cfg, model, {"tokens": tok},
                                  use_kernel=True)
    state = transformer.init_decode_state(cfg, 2, 16, dtype=torch.float32,
                                          device="cpu")
    for i in range(16):
        got, state = transformer.decode_step(cfg, model, state,
                                             tok[:, i:i + 1])
        _close(got[:, 0], full[:, i])


def _run(engine_cls, serve_cls, cfg, model, scenario, **kw):
    eng = engine_cls(cfg, model, serve_cls(max_len=64, temperature=0.0),
                     batch_slots=2, **kw)
    if scenario == "late_alone":  # the late request of "mid", on its own
        eng.submit([11, 12])
        return [list(o) for o in eng.run(max_new_tokens=7)]
    eng.submit([5, 6, 7])
    if scenario == "solo":
        return [list(o) for o in eng.run(max_new_tokens=12)]
    eng.run(max_new_tokens=5)
    eng.submit([11, 12])
    return [list(o) for o in eng.run(max_new_tokens=7)]


@pytest.fixture(scope="module")
def engine_runs(lm):
    jcfg, params, cfg, model = lm
    jmodel = jax.tree.map(jnp.asarray, params)
    return {s: (_run(JEngine, JServeConfig, jcfg, jmodel, s),
                _run(Engine, ServeConfig, cfg, model, s, device="cpu"))
            for s in ("solo", "mid", "late_alone")}


@pytest.mark.parametrize("scenario", ["solo", "mid", "late_alone"])
def test_engine_greedy_equals_reference(engine_runs, scenario):
    want, got = engine_runs[scenario]
    assert got == want
    assert any(len(o) > 0 for o in got)


def test_admission_leaves_the_live_slot_undisturbed(engine_runs):
    solo, mid = engine_runs["solo"][1], engine_runs["mid"][1]
    assert solo[0] == mid[0]
    assert len(mid[1]) > 0


def test_entry_points_raise_without_card(lm, monkeypatch):
    _, _, cfg, model = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model, ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_decode_state(cfg, 1, 8)
