"""The port's MoE family (qwen2-moe, arctic) against the JAX package (CPU,
SMOKE).

The reference's `init_params(cfg, PRNGKey(0))` for each SMOKE config is
carried into the port through `bridge.lm_from_numpy`; the same seeded
inputs then go through both packages:

  * `ffn.moe` alone, `(out, aux)`: at the default capacity, with the
    capacity cut until `_bucket` drops (token, expert) pairs, and with
    tied router probabilities (a zero router, where every token picks the
    lowest experts, and two equal router columns), where the order of
    the top-k feeds the dispatch ranks and so decides what is dropped;
  * `forward` logits and aux loss, with the plain path and the kernel
    path (the JAX side's Pallas flash kernel in interpret mode through
    REPRO_KERNELS=pallas, S = 128; the port's CPU tensors take the
    kernel's plain version);
  * `decode_step` logits step by step, prefill against decode, and the
    greedy `Engine` (solo, and an admission mid-decode);
  * configs field for field, the bridge both ways, and the full-width
    parameter count on `meta` against the reference's leaves.

The reference has no MoE test of its own, so this file is the first
check of `ffn.moe` against anything.
Tolerance: 1e-4 abs/rel on fp32 outputs, logits and aux (sums in another
order: the combine's adds, the aux mean); token ids exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as jffn
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.models.decode_engine import Engine as JEngine
from repro.models.decode_engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.core.exchange import _bucket
from repro_torch.kernels import ops
from repro_torch.models import ffn, registry, transformer
from repro_torch.models.decode_engine import Engine, ServeConfig

TOL = 1e-4
ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
# leaves of the reference's init_params at full width (jax.eval_shape),
# and its analytic param_count(), which leaves out the padded experts,
# the routers and the norms
FULL_WIDTH = {"qwen2-moe-a2.7b": (15_146_256_384, 14_312_538_112),
              "arctic-480b": (476_850_275_328, 476_817_653_760)}


@pytest.fixture(scope="module")
def lms():
    out = {}
    for arch in ARCHS:
        jcfg = jregistry.get(arch, smoke=True)
        params, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, params)
        cfg = registry.get(arch, smoke=True)
        out[arch] = (jcfg, params, cfg,
                     bridge.lm_from_numpy(cfg, params, device="cpu"))
    return out


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch, smoke):
    assert dataclasses.asdict(registry.get(arch, smoke)) == \
        dataclasses.asdict(jregistry.get(arch, smoke))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_count_on_meta(arch):
    """The meta build has every leaf of the reference's init_params; its
    param_count() is below that in both packages: it leaves out the
    padded experts, the routers and the norms."""
    cfg = registry.get(arch)
    model = transformer.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    jcfg = jregistry.get(arch)
    shapes = jax.eval_shape(
        lambda k: jtransformer.init_params(jcfg, k)[0],
        jax.random.PRNGKey(0))
    leaves = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    want_leaves, want_count = FULL_WIDTH[arch]
    assert n == leaves == want_leaves
    assert cfg.param_count() == jcfg.param_count() == want_count < n
    E, d, L = cfg.n_experts + cfg.expert_pad, cfg.d_model, cfg.n_layers
    pad = L * cfg.expert_pad * 3 * d * cfg.moe_d_ff
    assert n - want_count == pad + L * d * E + (2 * L + 1) * d
    lp = model.layers[0]
    assert lp.moe.wi.shape == (E, d, cfg.moe_d_ff)
    assert (lp.mlp is not None) == cfg.parallel_dense_ffn
    assert (lp.moe.shared is not None) == bool(cfg.n_shared_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(lms, arch):
    _, params, _, model = lms[arch]
    back = bridge.lm_to_numpy(model)
    flat, tree = jax.tree.flatten(params)
    flat2, tree2 = jax.tree.flatten(back)
    assert tree == tree2
    for a, b in zip(flat, flat2):
        assert a.shape == b.shape and np.array_equal(a, b)


def _moe_inputs(lms, arch, case):
    """Layer 0's MoE weights (numpy, as the reference holds them) and a
    seeded input; `case` edits the router.  The default case routes 128
    tokens (at most 32 pairs an expert on average, under the capacity
    floor of 128), the others 1024 (256 an expert on average), so they
    overflow."""
    _, params, cfg, _ = lms[arch]
    p = jax.tree.map(lambda a: np.array(a[0]), params["layers"]["moe"])
    if case == "zero_router":      # every probability tied
        p["router"][...] = 0
    elif case == "equal_columns":  # experts 1 and 3 tied for every token
        p["router"][:, 3] = p["router"][:, 1]
    rng = np.random.default_rng(len(case))
    S = 64 if case == "default" else 512
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def _port_moe(p):
    t = bridge.tensor
    shared = (ffn.GLU(*(t(p["shared"][n]) for n in ("wi", "wg", "wo")))
              if "shared" in p else None)
    return ffn.MoE(*(t(p[n]) for n in ("router", "wi", "wg", "wo")), shared)


@pytest.mark.parametrize("case,capacity_factor", [
    ("default", 1.25), ("overflow", 0.25), ("zero_router", 1.25),
    ("equal_columns", 1.25)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_equals_reference(lms, monkeypatch, arch, case,
                              capacity_factor):
    cfg, p, x = _moe_inputs(lms, arch, case)
    want, want_aux = jffn.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              cfg, capacity_factor=capacity_factor)
    drops = []

    def bucket(*args):
        out = _bucket(*args)
        drops.append(int(out[3]))
        return out

    monkeypatch.setattr(ffn, "_bucket", bucket)
    with torch.inference_mode():
        got, aux = ffn.moe(_port_moe(p), torch.from_numpy(x), cfg,
                           capacity_factor=capacity_factor)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)
    T, E = x.shape[0] * x.shape[1], cfg.n_experts + cfg.expert_pad
    C = ffn.capacity(T, cfg, capacity_factor)
    assert C == max(128, int(capacity_factor * T * cfg.top_k / E)
                    // 128 * 128)
    (dropped,) = drops
    if case == "default":
        assert dropped == 0
    else:  # the cut capacity, or every token on the same top experts
        assert dropped > 0


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.0, 0.3],
                          [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, idx = ffn.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [0, 1, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(lms, monkeypatch, arch, use_kernel):
    jcfg, params, cfg, model = lms[arch]
    tok = _tokens(cfg, 2, 128, seed=1)
    if use_kernel:  # the reference's flash branch: Pallas, interpret mode
        monkeypatch.setenv("REPRO_KERNELS", "pallas")
    want, want_aux = jtransformer.forward(
        jcfg, params, {"tokens": jnp.asarray(tok)}, use_kernel=use_kernel)
    ops.reset_launches()
    got, aux = transformer.forward(cfg, model,
                                   {"tokens": torch.from_numpy(tok)},
                                   use_kernel=use_kernel)
    assert ops.LAUNCHES == dict.fromkeys(ops.KERNELS, 0)  # CPU: plain
    assert got.shape == (2, 128, cfg.vocab)
    assert aux.dtype == torch.float32 and float(aux) > 0
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_equals_reference(lms, arch):
    jcfg, params, cfg, model = lms[arch]
    B, steps = 2, 8
    tok = _tokens(cfg, B, steps, seed=3)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(jcfg, p, s, t))
    jstate = jtransformer.init_decode_state(jcfg, B, 16, dtype=jnp.float32)
    state = transformer.init_decode_state(cfg, B, 16, dtype=torch.float32,
                                          device="cpu")
    for i in range(steps):
        want, jstate = step(params, jstate, jnp.asarray(tok[:, i:i + 1]))
        got, state = transformer.decode_step(
            cfg, model, state, torch.from_numpy(tok[:, i:i + 1]))
        assert got.shape == (B, 1, cfg.vocab)
        _close(got, want)
    assert state["pos"] == int(jstate["pos"]) == steps
    _close(state["caches"][-1].k, jstate["caches"].k[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_last_logits_equal_decode(lms, arch):
    """Causal: forward's logits at position i are the decode step's that
    fed token i (the check chip_smoke runs at full width on the card).
    Both dispatch without overflow here: 2 x 12 tokens, and one token a
    row in decode, under the capacity floor of 128."""
    _, _, cfg, model = lms[arch]
    tok = torch.from_numpy(_tokens(cfg, 2, 12, seed=4))
    full, _ = transformer.forward(cfg, model, {"tokens": tok},
                                  use_kernel=True)
    state = transformer.init_decode_state(cfg, 2, 16, dtype=torch.float32,
                                          device="cpu")
    for i in range(12):
        got, state = transformer.decode_step(cfg, model, state,
                                             tok[:, i:i + 1])
        _close(got[:, 0], full[:, i])


def _run(engine_cls, serve_cls, cfg, model, scenario, **kw):
    eng = engine_cls(cfg, model, serve_cls(max_len=64, temperature=0.0),
                     batch_slots=2, **kw)
    eng.submit([5, 6, 7])
    if scenario == "solo":
        return [list(o) for o in eng.run(max_new_tokens=12)]
    eng.run(max_new_tokens=5)
    eng.submit([11, 12])
    return [list(o) for o in eng.run(max_new_tokens=7)]


@pytest.fixture(scope="module")
def engine_runs(lms):
    out = {}
    for arch in ARCHS:
        jcfg, params, cfg, model = lms[arch]
        jmodel = jax.tree.map(jnp.asarray, params)
        for s in ("solo", "mid"):
            out[arch, s] = (_run(JEngine, JServeConfig, jcfg, jmodel, s),
                            _run(Engine, ServeConfig, cfg, model, s,
                                 device="cpu"))
    return out


@pytest.mark.parametrize("scenario", ["solo", "mid"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_equals_reference(engine_runs, arch, scenario):
    want, got = engine_runs[arch, scenario]
    assert got == want
    assert any(len(o) > 0 for o in got)


def test_unported_families_still_raise():
    """The families this test once found unported now resolve, each to
    the module that runs it: internvl2 (vlm) to `transformer`, whisper
    (enc-dec) to `encdec`."""
    from repro_torch.models import encdec
    for arch, mod in (("internvl2-2b", transformer),
                      ("whisper-large-v3", encdec)):
        cfg = registry.get(arch)
        assert cfg.name == jregistry.get(arch).name
        assert registry.model_fns(cfg)["forward"] is mod.forward
