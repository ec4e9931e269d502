"""The port's LM serving path against the JAX package (CPU, SMOKE llama).

The reference's `init_params(cfg, PRNGKey(0))` is carried into the port
through `bridge.lm_from_numpy`; the same seeded tokens then go through
both packages:

  * `forward` logits, with the XLA path (`use_kernel=False`) and with the
    kernel path (`use_kernel=True`: the JAX side runs the Pallas kernel in
    interpret mode through REPRO_KERNELS=pallas, S = 128; the port's
    CPU tensors take the kernel's plain version);
  * `decode_step` logits step by step over a 16-token prompt, and past
    `max_len`, where both clamp the cache write to the last slot;
  * the `Engine`'s greedy outputs on `tests/test_decode_engine.py`'s
    scenarios (solo, and an admission mid-decode, which must leave the
    live slot undisturbed), and one slot serving two queued requests,
    whose `run` returns only the second's tokens in both packages;
  * configs field for field, and the full-width parameter count.

Tolerance: 1e-4 abs/rel on fp32 logits (matmul and softmax sums in
another order, rope tables through another pow/cos); token ids exact.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flags as jflags
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.models.decode_engine import Engine as JEngine
from repro.models.decode_engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.models import flags, layers, registry, transformer
from repro_torch.models.decode_engine import Engine, ServeConfig

TOL = 1e-4
ARCH = "llama3.2-3b"


@pytest.fixture(scope="module")
def lm():
    jcfg = jregistry.get(ARCH, smoke=True)
    params, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
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
    cfg = registry.get(ARCH)
    model = transformer.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert n == cfg.param_count() + norms == 3_212_749_824


def test_bridge_round_trip(lm):
    _, params, _, model = lm
    back = bridge.lm_to_numpy(model)
    flat, tree = jax.tree.flatten(params)
    flat2, tree2 = jax.tree.flatten(back)
    assert tree == tree2
    for a, b in zip(flat, flat2):
        assert np.array_equal(a, b)


def test_forward_equals_reference(lm):
    jcfg, params, cfg, model = lm
    tok = _tokens(cfg, 2, 32, seed=1)
    want, _ = jtransformer.forward(jcfg, params, {"tokens": jnp.asarray(tok)})
    got, aux = transformer.forward(cfg, model,
                                   {"tokens": torch.from_numpy(tok)})
    assert got.shape == (2, 32, layers.pad_to_multiple(cfg.vocab, 16))
    assert float(aux) == 0.0
    _close(got, want)


def test_forward_kernel_path_equals_pallas_interpret(lm, monkeypatch):
    """The reference's use_kernel branch runs the Pallas kernel (interpret
    mode off the TPU) under REPRO_KERNELS=pallas; its blocks of 128 need
    S % 128 == 0."""
    jcfg, params, cfg, model = lm
    tok = _tokens(cfg, 2, 128, seed=2)
    monkeypatch.setenv("REPRO_KERNELS", "pallas")
    want, _ = jtransformer.forward(jcfg, params, {"tokens": jnp.asarray(tok)},
                                   use_kernel=True)
    got, _ = transformer.forward(cfg, model, {"tokens": torch.from_numpy(tok)},
                                 use_kernel=True)
    _close(got, want)
    monkeypatch.setattr(flags, "ATTN_IMPL", "flash")
    _close(transformer.forward(cfg, model,
                               {"tokens": torch.from_numpy(tok)})[0], want)


def _jax_decode(jcfg, params, B, max_len):
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(jcfg, p, s, t))
    state = jtransformer.init_decode_state(jcfg, B, max_len,
                                           dtype=jnp.float32)
    return step, state


@pytest.mark.parametrize("max_len,steps", [(32, 16), (4, 7)])
def test_decode_step_equals_reference(lm, max_len, steps):
    """Step by step over a prompt; with max_len 4 the last 3 steps write
    past the cache, and both clamp the write to slot max_len - 1."""
    jcfg, params, cfg, model = lm
    B = 2
    tok = _tokens(cfg, B, steps, seed=3)
    step, jstate = _jax_decode(jcfg, params, B, max_len)
    state = transformer.init_decode_state(cfg, B, max_len,
                                          dtype=torch.float32, device="cpu")
    for i in range(steps):
        want, jstate = step(params, jstate, jnp.asarray(tok[:, i:i + 1]))
        got, state = transformer.decode_step(
            cfg, model, state, torch.from_numpy(tok[:, i:i + 1]))
        assert got.shape == (B, 1, cfg.vocab)
        _close(got, want)
    assert state["pos"] == int(jstate["pos"]) == steps
    _close(state["caches"][-1].k, jstate["caches"].k[-1])


def test_prefill_last_logits_equal_decode(lm):
    """Causal: forward's logits at position i are the decode step's that
    fed token i (the check chip_smoke runs at full width on the card)."""
    _, _, cfg, model = lm
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


def test_admission_leaves_the_live_slot_undisturbed(engine_runs):
    solo, mid = engine_runs["solo"][1], engine_runs["mid"][1]
    assert solo[0] == mid[0]
    assert len(mid[1]) > 0


def test_late_admission_sees_its_slot_history_in_both_packages(engine_runs):
    """A request admitted mid-run starts at the shared write position, and
    the live mask `tpos <= pos` lets it attend to its row's earlier cache
    entries (zeros here, a finished request's keys after recycling), so it
    decodes otherwise than alone.  A fault of the reference (ROADMAP.md
    Queue 3) that the port mirrors."""
    (j_mid, t_mid), (j_alone, t_alone) = (engine_runs["mid"],
                                          engine_runs["late_alone"])
    assert t_mid[1] == j_mid[1] and t_alone[0] == j_alone[0]
    assert t_mid[1] != t_alone[0]


def test_engine_discards_the_output_of_a_recycled_slot(lm):
    """One slot, two queued requests, EOS 11.  The first request, [5, 6,
    7], emits [11, 11] and stops after its 2 prompt steps and 2 tokens;
    the slot then takes the second, [11, 12].  `run` returns one list, and
    the step count shows that all of it was emitted after the first request
    ended: the first request's tokens are lost, in both packages.  A fault
    of the reference (ROADMAP.md Queue 3) that the port mirrors."""
    jcfg, params, cfg, model = lm
    jmodel = jax.tree.map(jnp.asarray, params)
    runs = []
    for engine_cls, serve_cls, c, m, kw in (
            (JEngine, JServeConfig, jcfg, jmodel, {}),
            (Engine, ServeConfig, cfg, model, {"device": "cpu"})):
        out = []
        for prompts in ([[5, 6, 7]], [[5, 6, 7], [11, 12]]):
            eng = engine_cls(c, m, serve_cls(max_len=64, eos_token=11),
                             batch_slots=1, **kw)
            for p in prompts:
                eng.submit(p)
            out.append(([list(o) for o in eng.run(max_new_tokens=12)],
                        int(eng.state["pos"])))
        (first, n_first), (both, n_both) = out
        assert first == [[11, 11]] and n_first == 2 + 2
        assert len(both) == 1 and both[0][-1] == 11
        assert n_both == n_first + 1 + len(both[0])  # second's steps only
        runs.append(both)
    assert runs[0] == runs[1]


def test_engine_is_freed_without_the_cyclic_collector(lm):
    """Dropping an Engine frees its state (and its hold on the model) at
    once: no reference cycle waits for `gc` with the weights on the card."""
    _, _, cfg, model = lm
    gc.disable()
    try:
        eng = Engine(cfg, model, ServeConfig(max_len=8), batch_slots=1,
                     device="cpu")
        eng.submit([1, 2])
        eng.run(max_new_tokens=3)
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_engine_samples_from_a_seeded_generator(lm):
    _, _, cfg, model = lm
    outs = [Engine(cfg, model, ServeConfig(max_len=32, temperature=1.0),
                   batch_slots=1, device="cpu") for _ in range(2)]
    for e in outs:
        e.submit([1, 2])
    a, b = (e.run(max_new_tokens=10) for e in outs)
    assert a == b and len(a[0]) > 0
    assert all(0 <= t < layers.pad_to_multiple(cfg.vocab, 16) for t in a[0])


def test_entry_points_raise_without_card(lm, monkeypatch):
    _, _, cfg, model = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model, ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_decode_state(cfg, 1, 8)


def test_unported_families_and_impls_raise(lm, monkeypatch):
    """Nothing of the reference's registry or attention is left unported:
    every reference id resolves, an unknown id is a KeyError, the enc-dec
    family is refused by `transformer` (it runs in `encdec`), and
    ATTN_IMPL="chunked" runs and equals the reference's chunked path."""
    jcfg, params, cfg, model = lm
    for arch in jregistry.ARCHS:
        for smoke in (False, True):
            assert registry.get(arch, smoke).name == \
                jregistry.get(arch, smoke).name
    with pytest.raises(KeyError):
        registry.get("no-such-arch")
    with pytest.raises(ValueError, match="encdec"):
        transformer.init_params(dataclasses.replace(cfg, family="encdec"),
                                device="cpu")
    tok = _tokens(cfg, 1, 1024, seed=12)
    monkeypatch.setattr(flags, "ATTN_IMPL", "chunked")
    monkeypatch.setattr(jflags, "ATTN_IMPL", "chunked")
    want, _ = jtransformer.forward(jcfg, params, {"tokens": jnp.asarray(tok)})
    got, _ = transformer.forward(cfg, model, {"tokens": torch.from_numpy(tok)})
    _close(got, want, 2e-4)


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_rope_equals_reference(frac):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.array([[0, 3, 7, 300, 9], [1, 1, 2, 5, 8]], np.int32)
    jc, js, rot = jlayers.rope_freqs(16, 64, 5e5, frac)
    c, s, rot2 = layers.rope_freqs(16, 64, 5e5, frac)
    assert rot == rot2
    _close(c, jc, 1e-6)
    # positions past the table clamp, as JAX's gather does
    want = jlayers.apply_rope(jnp.asarray(x), jc, js, rot, jnp.asarray(pos))
    got = layers.apply_rope(torch.from_numpy(x), c, s, rot,
                            torch.from_numpy(pos).long())
    _close(got, want, 1e-5)
    _close(layers.apply_rope(torch.from_numpy(x), c, s, rot),
           jlayers.apply_rope(jnp.asarray(x), jc, js, rot), 1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_act_fn_equals_reference(act):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(layers.act_fn(act)(torch.from_numpy(x)),
           jlayers.act_fn(act)(jnp.asarray(x)), 1e-6)


def test_rmsnorm_and_cross_entropy_equal_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32) * 3
    w = rng.standard_normal(8).astype(np.float32)
    _close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    logits = rng.standard_normal((2, 6, 10)).astype(np.float32)
    tgt = rng.integers(0, 10, size=(2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.7).astype(np.float32)
    _close(layers.cross_entropy(*map(torch.from_numpy, (logits, tgt, mask))),
           jlayers.cross_entropy(*map(jnp.asarray, (logits, tgt, mask))),
           1e-5)
