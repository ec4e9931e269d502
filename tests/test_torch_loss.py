"""The port's training loss against the JAX package (CPU, SMOKE configs).

For SMOKE llama, qwen2-moe (its aux loss in), zamba2 (the bridged
`a_bias` at -3, as tests/test_torch_hybrid.py has it, so the reference
stays finite), xlstm (S = 32: the reference is NaN from S = 128, ROADMAP
Queue 3), whisper (frames) and internvl2 (frontend rows), the port's
`init_params` from a seeded torch.Generator (the reference's shapes and
scales) is carried into the reference through `bridge.lm_to_numpy`; the
same numpy-seeded batch then goes through:

  * `registry.model_fns(cfg)["loss_fn"]`: the loss value, and the
    gradient of every parameter (the port's autograd on `forward(grad=
    True)` against `jax.value_and_grad` of the reference's `loss_fn`,
    mapped onto the reference's pytree by `bridge.grads_to_numpy`);
  * the kernel path's refusal: the port's `flash_attention` and
    `ssd_scan` ops raise on inputs that require grad, and so does
    `loss_fn(use_kernel=True)`; the reference's `jax.grad` through its
    Pallas flash kernel raises too.

Tolerance: the loss 1e-5 relative (fp32 sums in another order); each
gradient leaf within 1e-4 of the leaf's max |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import registry as jregistry
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.models import registry

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B = 2
# arch -> (tokens a sequence, a_bias override or None)
ARCHS = {"llama3.2-3b": (32, None), "qwen2-moe-a2.7b": (32, None),
         "zamba2-7b": (32, -3.0), "xlstm-125m": (32, None),
         "whisper-large-v3": (32, None), "internvl2-2b": (24, None)}


def _batch(cfg, S, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(
        np.int32)}
    rows = (cfg.enc_max_seq if cfg.family == "encdec"
            else cfg.n_frontend_tokens if cfg.frontend else 0)
    if rows:
        out["frontend"] = rng.standard_normal(
            (B, rows, cfg.d_model)).astype(np.float32)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module", params=list(ARCHS))
def case(request):
    arch = request.param
    S, a_bias = ARCHS[arch]
    cfg = registry.get(arch, smoke=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = bridge.lm_to_numpy(registry.model_fns(cfg)["init_params"](
        cfg, gen, device="cpu"))
    if a_bias is not None:
        for stack in (params["mamba"], params["mamba_tail"]):
            stack["mixer"]["a_bias"][...] = a_bias
    model = bridge.lm_from_numpy(cfg, params, device="cpu")
    jcfg = jregistry.get(arch, smoke=True)
    jfns = jregistry.model_fns(jcfg)
    batch = _batch(jcfg, S, seed=len(arch))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jfns["loss_fn"](jcfg, p, jbatch)))(params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return (arch, cfg, model, tbatch, float(loss),
            jax.tree.map(np.asarray, grads))


def test_loss_value_equals_reference(case):
    arch, cfg, model, batch, want, _ = case
    got = registry.model_fns(cfg)["loss_fn"](cfg, model, batch)
    assert got.shape == () and got.requires_grad
    assert np.isfinite(want), arch
    np.testing.assert_allclose(float(got.detach()), want, rtol=LOSS_TOL)


def test_loss_gradients_equal_reference(case):
    arch, cfg, model, batch, _, want = case
    model.zero_grad(set_to_none=True)
    registry.model_fns(cfg)["loss_fn"](cfg, model, batch).backward()
    got = dict(_leaves(bridge.grads_to_numpy(model)))
    want = dict(_leaves(want))
    assert got.keys() == want.keys(), arch
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[key] - w).max())
        assert got[key].shape == w.shape and err <= GRAD_TOL * scale, \
            f"{arch} {key}: {err} against max |g| {scale}"
    model.zero_grad(set_to_none=True)


def test_kernel_path_refuses_gradients_as_the_reference_cannot_give_them():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 128, 64)).astype(
        np.float32)).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q, q, q)
    x = torch.zeros((1, 64, 2, 16), requires_grad=True)
    a = torch.zeros((1, 64, 2))
    bc = torch.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError, match="no backward"):
        ops.ssd_scan(x, a, bc, bc, chunk=32)
    with torch.no_grad():  # no autograd: the op runs
        assert ops.flash_attention(q, q, q).shape == q.shape
        assert ops.ssd_scan(x, a, bc, bc, chunk=32).shape == x.shape
    cfg = registry.get("llama3.2-3b", smoke=True)
    model = registry.model_fns(cfg)["init_params"](cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32)}
    with pytest.raises(ValueError, match="no backward"):
        registry.model_fns(cfg)["loss_fn"](cfg, model, batch,
                                           use_kernel=True)
    # the reference's Pallas kernel (interpret mode here) has no VJP
    jq = jnp.asarray(q.detach().numpy())
    with pytest.raises(Exception):
        jax.grad(lambda t: jnp.sum(jops.flash_attention(
            t, t, t, use_kernel=True)))(jq)
