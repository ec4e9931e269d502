"""The registry's last dense and vlm architectures against the JAX package
(CPU, SMOKE): gemma-7b (GeGLU, heads of 256 over a narrower d_model, tied
embeddings), starcoder2-3b (GQA 2 KV heads), chatglm3-6b (GQA, partial
rotary 0.5) and internvl2-2b (the stub vision frontend prepended to the
tokens), and the registry itself.

The reference's `init_params(cfg, PRNGKey(0))` of each SMOKE config is
carried into the port through `bridge.lm_from_numpy`; the same seeded
inputs then go through both packages:

  * `forward` logits on the plain path and with `use_kernel=True` (the
    JAX side's Pallas flash kernel in interpret mode through
    REPRO_KERNELS=pallas at 128 positions, internvl2's 8 frontend rows
    included; the port's CPU tensors take the kernel's plain version);
  * `decode_step` logits step by step (the vlm's decode ignores the
    frontend, in both);
  * configs field for field, the bridge both ways and the full-width
    parameter count on `meta` against the reference's leaves;
  * `registry`: every id resolves, `input_specs` of every arch x shape
    against the reference's `ShapeDtypeStruct`s, `cells`, and
    `smoke_batch`'s shapes and dtypes (its draws come from a
    torch.Generator and cannot equal jax.random's).

Tolerance: 1e-4 abs/rel on fp32 logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.models import layers, registry, transformer

TOL = 1e-4
ARCHS = ("gemma-7b", "starcoder2-3b", "chatglm3-6b", "internvl2-2b")
# the reference's init_params leaves at full width (jax.eval_shape), and
# its analytic param_count(), which leaves out the norms (and internvl2's
# frontend projection and vocabulary pad)
FULL_WIDTH = {"gemma-7b": (8_537_680_896, 8_537_505_792),
              "starcoder2-3b": (4_312_980_480, 4_312_793_088),
              "chatglm3-6b": (6_243_454_976, 6_243_221_504),
              "internvl2-2b": (1_893_369_856, 1_889_046_528)}
_TORCH_DTYPE = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
                jnp.float32: torch.float32}


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


def _batch(cfg, B, S, seed):
    """S positions in all: a vlm's n_frontend_tokens frontend rows and
    S - n_frontend_tokens tokens."""
    rng = np.random.default_rng(seed)
    nf = cfg.n_frontend_tokens if cfg.frontend else 0
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, S - nf))
           .astype(np.int32)}
    if nf:
        out["frontend"] = rng.standard_normal((B, nf, cfg.d_model)).astype(
            np.float32)
    return out


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
    cfg = registry.get(arch)
    model = transformer.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    leaves, count = FULL_WIDTH[arch]
    assert n == leaves and int(cfg.param_count()) == count
    extra = (2 * cfg.n_layers + 1) * cfg.d_model  # the norms
    if cfg.frontend:
        vpad = layers.pad_to_multiple(cfg.vocab, 16)
        extra += cfg.d_model ** 2 + 2 * (vpad - cfg.vocab) * cfg.d_model
    assert leaves - count == extra


def test_gemma_projections_are_rectangular():
    """gemma's H x hd = 4096 is not its d_model of 3072."""
    cfg = registry.get("gemma-7b")
    attn = transformer.init_params(cfg, device="meta").layers[0].attn
    assert attn.wq.shape == (3072, 4096) and attn.wo.shape == (4096, 3072)
    assert attn.wk.shape == attn.wv.shape == (3072, 4096)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(lms, arch):
    _, params, _, model = lms[arch]
    flat, tree = jax.tree.flatten(params)
    flat2, tree2 = jax.tree.flatten(bridge.lm_to_numpy(model))
    assert tree == tree2
    for a, b in zip(flat, flat2):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(lms, arch):
    jcfg, params, cfg, model = lms[arch]
    batch = _batch(cfg, 2, 32, seed=1)
    want, _ = jtransformer.forward(
        jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = transformer.forward(
        cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    S = batch["tokens"].shape[1]
    assert got.shape == (2, S, layers.pad_to_multiple(cfg.vocab, 16))
    assert float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_kernel_path_equals_pallas_interpret(lms, arch, monkeypatch):
    jcfg, params, cfg, model = lms[arch]
    batch = _batch(cfg, 2, 128, seed=2)
    monkeypatch.setenv("REPRO_KERNELS", "pallas")
    want, _ = jtransformer.forward(
        jcfg, params, {k: jnp.asarray(v) for k, v in batch.items()},
        use_kernel=True)
    got, _ = transformer.forward(
        cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()},
        use_kernel=True)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_equals_reference(lms, arch):
    jcfg, params, cfg, model = lms[arch]
    B, steps = 2, 6
    tok = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, steps)).astype(np.int32)
    step = jax.jit(lambda p, s, t: jtransformer.decode_step(jcfg, p, s, t))
    jstate = jtransformer.init_decode_state(jcfg, B, 16, dtype=jnp.float32)
    state = transformer.init_decode_state(cfg, B, 16, dtype=torch.float32,
                                          device="cpu")
    for i in range(steps):
        want, jstate = step(params, jstate, jnp.asarray(tok[:, i:i + 1]))
        got, state = transformer.decode_step(
            cfg, model, state, torch.from_numpy(tok[:, i:i + 1]))
        _close(got, want)
    assert state["pos"] == int(jstate["pos"]) == steps


@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_every_reference_id_resolves(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(registry.get(arch, smoke)) == \
            dataclasses.asdict(jregistry.get(arch, smoke))
    assert set(registry.ARCHS) == set(jregistry.ARCHS)
    with pytest.raises(KeyError):
        registry.get("no-such-arch")


@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_input_specs_and_cells_equal_reference(arch):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    assert [(n, dataclasses.asdict(s)) for n, s in registry.cells(arch)] == \
        [(n, dataclasses.asdict(s)) for n, s in jregistry.cells(arch)]
    assert {n: dataclasses.asdict(s) for n, s in base.SHAPES.items()} == \
        {n: dataclasses.asdict(s) for n, s in jbase.SHAPES.items()}
    for name, shape in base.SHAPES.items():
        got = registry.input_specs(cfg, shape)
        want = jregistry.input_specs(jcfg, jbase.SHAPES[name])
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == spec.shape
            assert got[key].dtype == _TORCH_DTYPE[spec.dtype.type]


@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_smoke_batch_shapes_and_dtypes_equal_reference(arch):
    cfg, jcfg = registry.get(arch, True), jregistry.get(arch, True)
    got = registry.smoke_batch(cfg, batch=2, seq=8, seed=3)
    want = jregistry.smoke_batch(jcfg, batch=2, seq=8, seed=3)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert tuple(got[key].shape) == arr.shape
        assert got[key].dtype == _TORCH_DTYPE[arr.dtype.type]
    assert int(got["tokens"].min()) >= 0
    assert int(got["tokens"].max()) < cfg.vocab
    again = registry.smoke_batch(cfg, batch=2, seq=8, seed=3)
    assert all(torch.equal(got[k], again[k]) for k in got)
