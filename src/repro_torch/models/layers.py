"""Model building blocks: initialised linears, norms, RoPE, activations.

Mirrors `repro.models.layers` without the logical sharding axes (one
card, no mesh).  Weights keep the reference's `[d_in, d_out]` layout, so a
linear is `x @ w` in both packages and the bridge copies arrays as they
are.  Init helpers draw from an explicit `torch.Generator` on an explicit
device; they cannot give `jax.random`'s numbers, so the tests carry the
reference's weights across instead (`repro_torch.bridge`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no card and no device
    raises, as `api.Local()` does."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "model on the CPU")
        device = "cuda"
    return torch.device(device)


def _normal(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def dense_init(generator, d_in: int, d_out: int, *, scale: float | None = None,
               dtype=torch.float32, device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(generator, (d_in, d_out), dtype, device) * scale


def embed_init(generator, vocab: int, d: int, dtype=torch.float32,
               device=None):
    return _normal(generator, (vocab, d), dtype, device) * 0.02


def norm_init(d: int, dtype=torch.float32, device=None):
    return torch.ones((d,), dtype=dtype, device=device)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the reference's `astype(float32)` sums in: fp32, or fp64
    for fp64 tensors (a float64 run stays float64 throughout)."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm(x, w, eps: float = 1e-5):
    """Cast back to x's dtype before the weight, as the reference."""
    var = x.to(acc_dtype(x.dtype)).square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b=None, eps: float = 1e-5):
    """Mean and (population) variance in fp32, cast back to x's dtype
    before the weight; the bias, if any, after it, as the reference."""
    xf = x.to(acc_dtype(x.dtype))
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w
    return y + b if b is not None else y


def rope_freqs(head_dim: int, max_seq: int, theta: float = 10000.0,
               fraction: float = 1.0, device=None):
    """fp32 rotary tables; fraction < 1 rotates only the leading dims."""
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    f = torch.outer(t, inv)
    return torch.cos(f), torch.sin(f), rot


def apply_rope(x, cos, sin, rot: int, positions=None):
    """x: [B, S, H, D]; positions: [B, S] (defaults to arange).

    Rotates interleaved pairs (0::2, 1::2), not HF's rotate_half, in fp32
    (fp64 for fp64 x), and casts to x's dtype.  Positions past the table clamp to its last
    row, as JAX's gather does.
    """
    B, S, H, D = x.shape
    if positions is None:
        c = cos[:S][None, :, None, :]
        s = sin[:S][None, :, None, :]
    else:
        positions = positions.clamp(0, cos.shape[0] - 1)
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    xr = x[..., :rot].to(acc_dtype(x.dtype))
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    y = torch.stack([y1, y2], dim=-1).reshape(B, S, H, rot).to(x.dtype)
    return torch.cat([y, x[..., rot:]], dim=-1) if rot < D else y


def act_fn(name: str):
    """JAX's gelu is the tanh approximation."""
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def next_token_targets(tokens):
    """(targets, mask) of next-token prediction: position t predicts
    tokens[t + 1]; the last position's target is 0 and masked out."""
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    return targets, mask


def cross_entropy(logits, targets, mask):
    """Mean token NLL.  logits [B, S, V] (fp32-cast); targets [B, S]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(),
                                dim=-1)[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
