"""The port's enc-dec family (whisper) against the JAX package (CPU, SMOKE).

The reference's `encdec.init_params(cfg, PRNGKey(0))` is carried into the
port through `bridge.lm_from_numpy`; the same seeded frames and tokens
then go through both packages:

  * `encode`, with the naive attention and under ATTN_IMPL="flash" (the
    reference's op takes its plain version off the TPU: the Pallas
    kernel's blocks of 128 do not divide the 32 SMOKE frames);
  * `forward` logits on the plain path and with `use_kernel=True` (the
    JAX side's Pallas flash kernel in interpret mode through
    REPRO_KERNELS=pallas, S = 128; the port's CPU tensors take the
    kernel's plain version);
  * `decode_step` step by step with `enc_out` set from `encode`, and the
    greedy `Engine` with `enc_out` written into its state;
  * `layernorm`, configs field for field, the bridge both ways and the
    full-width parameter count on `meta` against the reference's leaves.

Two faults of the reference are pinned here (ROADMAP.md Queue 3): its
`param_count()` leaves out whisper's cross-attention and learned
positions, and its `Engine` serves an enc-dec model against a zero
`enc_out`, which the port mirrors.
Tolerance: 1e-4 abs/rel on fp32 logits and states; token ids exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro.models import flags as jflags
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models.decode_engine import Engine as JEngine
from repro.models.decode_engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.models import encdec, flags, layers, registry, transformer
from repro_torch.models.decode_engine import Engine, ServeConfig

TOL = 1e-4
ARCH = "whisper-large-v3"
# the reference's init_params leaves at full width (jax.eval_shape), and
# its analytic param_count()
FULL_LEAVES, FULL_COUNT = 2_106_242_560, 1_810_498_560


@pytest.fixture(scope="module")
def lm():
    jcfg = jregistry.get(ARCH, smoke=True)
    params, _ = jencdec.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    cfg = registry.get(ARCH, smoke=True)
    model = bridge.lm_from_numpy(cfg, params, device="cpu")
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((2, cfg.enc_max_seq, cfg.d_model)).astype(
        np.float32)
    jenc = np.array(jencdec.encode(jcfg, params, jnp.asarray(frames)))
    return jcfg, params, cfg, model, frames, jenc


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _batch(frames, tok, lib):
    if lib is torch:
        return {"frontend": torch.from_numpy(frames),
                "tokens": torch.from_numpy(tok)}
    return {"frontend": jnp.asarray(frames), "tokens": jnp.asarray(tok)}


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference_field_for_field(smoke):
    assert dataclasses.asdict(registry.get(ARCH, smoke)) == \
        dataclasses.asdict(jregistry.get(ARCH, smoke))


def test_full_width_param_count_on_meta():
    """The port's full-width model holds the reference's leaves; the
    reference's `param_count()` leaves out the decoder's cross-attentions,
    both learned position tables, the norms and the vocabulary pad of the
    embedding and the head (a reference fault, ROADMAP.md Queue 3)."""
    cfg = registry.get(ARCH)
    model = encdec.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(
        lambda k: jencdec.init_params(jregistry.get(ARCH), k)[0],
        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree.leaves(shapes)) == FULL_LEAVES
    d = cfg.d_model
    vpad = layers.pad_to_multiple(cfg.vocab, 16)
    missing = (cfg.n_layers * 4 * d * d + cfg.max_seq * d
               + cfg.enc_max_seq * d
               + (2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2) * d
               + 2 * (vpad - cfg.vocab) * d)
    assert int(jregistry.get(ARCH).param_count()) == FULL_COUNT
    assert FULL_LEAVES - FULL_COUNT == missing == 295_744_000


def test_bridge_round_trip(lm):
    _, params, _, model, _, _ = lm
    back = bridge.lm_to_numpy(model)
    flat, tree = jax.tree.flatten(params)
    flat2, tree2 = jax.tree.flatten(back)
    assert tree == tree2
    for a, b in zip(flat, flat2):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("bias", [False, True])
def test_layernorm_equals_reference(bias):
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 6, 16)) * 3 + 1.5).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32) if bias else None
    got = layers.layernorm(torch.from_numpy(x), torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b),
                           eps=1e-5)
    want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b), eps=1e-5)
    _close(got, want, 1e-5)


def test_encode_equals_reference(lm):
    _, _, cfg, model, frames, jenc = lm
    got = encdec.encode(cfg, model, torch.from_numpy(frames))
    assert got.shape == (2, cfg.enc_max_seq, cfg.d_model)
    _close(got, jenc)


def test_encode_under_flash_equals_reference(lm, monkeypatch):
    """`encode` takes no use_kernel: the flag alone sends its non-causal
    attention through the flash op, in both packages."""
    jcfg, params, cfg, model, frames, jenc = lm
    calls = []
    from repro_torch.kernels import ops
    orig = ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(kw.get("causal"))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    monkeypatch.setattr(flags, "ATTN_IMPL", "flash")
    monkeypatch.setattr(jflags, "ATTN_IMPL", "flash")
    want = jencdec.encode(jcfg, params, jnp.asarray(frames))
    got = encdec.encode(cfg, model, torch.from_numpy(frames))
    assert calls == [False] * cfg.n_enc_layers
    _close(got, want)
    _close(got, jenc)


def test_forward_equals_reference(lm):
    jcfg, params, cfg, model, frames, _ = lm
    tok = _tokens(cfg, 2, 32, seed=2)
    want, _ = jencdec.forward(jcfg, params, _batch(frames, tok, jnp))
    got, aux = encdec.forward(cfg, model, _batch(frames, tok, torch))
    assert got.shape == (2, 32, layers.pad_to_multiple(cfg.vocab, 16))
    assert float(aux) == 0.0
    _close(got, want)


def test_forward_kernel_path_equals_pallas_interpret(lm, monkeypatch):
    """The decoder's self-attention through the flash op (the reference's
    Pallas kernel in interpret mode: S % 128 == 0); the encoder stays
    naive in both, as it takes no use_kernel."""
    jcfg, params, cfg, model, frames, _ = lm
    tok = _tokens(cfg, 2, 128, seed=3)
    monkeypatch.setenv("REPRO_KERNELS", "pallas")
    want, _ = jencdec.forward(jcfg, params, _batch(frames, tok, jnp),
                              use_kernel=True)
    got, _ = encdec.forward(cfg, model, _batch(frames, tok, torch),
                            use_kernel=True)
    _close(got, want)


def test_decode_step_equals_reference(lm):
    """Step by step with enc_out set from `encode` in both packages; the
    decode logits are also the teacher-forced forward's (the check
    chip_smoke runs at full width on the card)."""
    jcfg, params, cfg, model, frames, jenc = lm
    B, steps = 2, 6
    tok = _tokens(cfg, B, steps, seed=4)
    step = jax.jit(lambda p, s, t: jencdec.decode_step(jcfg, p, s, t))
    jstate = jencdec.init_decode_state(jcfg, B, 16, dtype=jnp.float32)
    jstate["enc_out"] = jnp.asarray(jenc)
    state = encdec.init_decode_state(cfg, B, 16, dtype=torch.float32,
                                     device="cpu")
    state["enc_out"] = encdec.encode(cfg, model, torch.from_numpy(frames))
    full, _ = encdec.forward(cfg, model, _batch(frames, tok, torch))
    for i in range(steps):
        want, jstate = step(params, jstate, jnp.asarray(tok[:, i:i + 1]))
        got, state = encdec.decode_step(cfg, model, state,
                                        torch.from_numpy(tok[:, i:i + 1]))
        assert got.shape == (B, 1, cfg.vocab)
        _close(got, want)
        _close(got[:, 0], full[:, i])
    assert state["pos"] == int(jstate["pos"]) == steps
    _close(state["caches"][-1].k, jstate["caches"].k[-1])


def _first_logits(eng, prompt):
    """The logits of the engine's first decode step (run for one step)."""
    out = []
    step = eng._step

    def recording(*args):
        logits, state = step(*args)
        out.append(np.asarray(logits))
        return logits, state

    eng._step = recording
    eng.submit(prompt)
    eng.run(max_new_tokens=1)
    return out[0]


def test_engine_serves_against_a_zero_encoder_output(lm):
    """Nothing in the reference writes `enc_out`: `init_decode_state`
    zeroes it and the `Engine` takes no audio, so a served request attends
    to a zero encoder output.  The Engine's first logits equal a
    `decode_step` on zeros, in both packages, and differ from one on
    `encode(frames)` by more than 1e-3.  A reference fault (ROADMAP.md
    Queue 3) that the port mirrors."""
    jcfg, params, cfg, model, frames, jenc = lm
    prompt = [5, 6]
    tok = np.array([[5]], np.int32)
    jgot = _first_logits(JEngine(jcfg, jax.tree.map(jnp.asarray, params),
                                 JServeConfig(max_len=16), batch_slots=1),
                         prompt)
    got = _first_logits(Engine(cfg, model, ServeConfig(max_len=16),
                               batch_slots=1, device="cpu"), prompt)
    _close(got, jgot)
    state = encdec.init_decode_state(cfg, 1, 16, dtype=torch.float32,
                                     device="cpu")
    zero, _ = encdec.decode_step(cfg, model, state, torch.from_numpy(tok))
    _close(got, zero)
    state = encdec.init_decode_state(cfg, 1, 16, dtype=torch.float32,
                                     device="cpu")
    state["enc_out"] = torch.from_numpy(jenc[:1])
    heard, _ = encdec.decode_step(cfg, model, state, torch.from_numpy(tok))
    assert float((zero - heard).abs().max()) > 1e-3


def test_engine_with_written_encoder_output_equals_reference(lm):
    """The caller writes `encode`'s output into the engine's state; both
    packages then serve the same greedy tokens."""
    jcfg, params, cfg, model, _, jenc = lm
    outs = []
    for engine_cls, serve_cls, c, m, kw, enc in (
            (JEngine, JServeConfig, jcfg, jax.tree.map(jnp.asarray, params),
             {}, jnp.asarray(jenc)),
            (Engine, ServeConfig, cfg, model, {"device": "cpu"},
             torch.from_numpy(jenc))):
        eng = engine_cls(c, m, serve_cls(max_len=32), batch_slots=2, **kw)
        eng.state["enc_out"] = enc
        eng.submit([5, 6, 7])
        eng.submit([9])
        outs.append([list(o) for o in eng.run(max_new_tokens=10)])
    assert outs[0] == outs[1]
    assert all(len(o) > 0 for o in outs[1])


def test_model_fns_dispatch_encdec_and_transformer_refuses_it(lm):
    _, _, cfg, _, _, _ = lm
    fns = registry.model_fns(cfg)
    assert fns["init_params"] is encdec.init_params
    assert fns["decode_step"] is encdec.decode_step
    with pytest.raises(ValueError, match="encdec"):
        transformer.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        encdec.init_params(registry.get("llama3.2-3b", smoke=True),
                           device="cpu")
