"""The port's flash_attention against the JAX kernel and its oracle (CPU).

`repro_torch.kernels.ops.flash_attention` on CPU tensors takes its plain
version (`ref.flash_attention_ref`); here it is held to the JAX Pallas
kernel run in interpret mode (`repro.kernels.flash_attention`, as
`tests/test_kernels.py` runs it) and to `repro.kernels.ref.
flash_attention_ref`, on the inputs of `tests/test_kernels.py` (numpy
seed 7, B 2, S 256, D 64, blocks of 64), plus a ragged S = 200 against
the JAX oracle (the Pallas kernel needs S divisible by its blocks).
Tolerance: 1e-5 abs/rel in fp32 (softmax and sums in another order),
5e-2 in bf16 (the JAX oracle rounds its logits to bf16 before the scale).
The CUDA kernel itself is held to the plain version on the card
(`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(H, KH, S, dtype, B=2, D=64, seed=7):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B, H, S, D), (B, KH, S, D), (B, KH, S, D))]
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.from_numpy(a).to(tdt) for a in arrs]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KH", [(4, 4), (4, 2)])
def test_port_equals_pallas_interpret_and_jax_ref(causal, dtype, H, KH):
    (jq, jk, jv), (q, k, v) = _inputs(H, KH, 256, dtype)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 0  # CPU: the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = DTYPES[dtype][2]
    _close(got, pallas_flash(jq, jk, jv, causal=causal, block_q=64,
                             block_k=64, interpret=True), tol)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_length_equals_jax_ref(causal, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(4, 2, 200, dtype, seed=8)
    _close(ops.flash_attention(q, k, v, causal=causal),
           jref.flash_attention_ref(jq, jk, jv, causal=causal),
           DTYPES[dtype][2])


def test_backend_torch_and_scale():
    """backend='torch' is the plain version on any device; an explicit
    scale reaches it (the reference's oracle takes one too)."""
    (jq, jk, jv), (q, k, v) = _inputs(4, 2, 64, "float32", seed=9)
    got = ops.flash_attention(q, k, v, scale=0.3, backend="torch")
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, scale=0.3))
    _close(got, jref.flash_attention_ref(jq, jk, jv, scale=0.3), 1e-5)
    with pytest.raises(ValueError, match="unknown"):
        ops.flash_attention(q, k, v, backend="pallas")
