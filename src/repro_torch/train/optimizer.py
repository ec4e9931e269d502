"""AdamW with optional int8-quantized moments (mirrors
`repro.train.optimizer`).

    state = init_state(model, AdamConfig())       # keyed by parameter name
    gnorm = apply_updates(params, grads, state, cfg)  # in place

The state is {"m": {name: MomentState}, "v": {...}, "step": int32
tensor}, one entry a tensor of `model.named_parameters()` (the reference
keys its stacked pytree leaves; `bridge.opt_state_from_numpy` maps one
onto the other).  A moment is an fp32 tensor of the parameter's shape
(`scale` None) or, with `quantize_moments`, int8 blocks [n / 256, 256] of
the flattened tensor, zero-padded, with their absmax scales [n / 256, 1].

`apply_updates` keeps the reference's order of operations, so the two
agree to rounding: the gradients clipped by their global norm, the
moments, the bias corrections `1 - b ** step` in fp32, `delta = mh /
(sqrt(vh) + eps) + wd * p` and `p - lr * delta`.  It updates the
parameters and moments in place under `torch.no_grad()`, a tensor at a
time, in two buffers of the tensor's size (three more for the
dequantized moments and a quantization on the int8 path).
`torch.optim.AdamW` is not this update: its decoupled decay rounds
otherwise, and it has no int8 moments.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

BLOCK = 256


class AdamConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False


def _blocks(x) -> torch.Tensor:
    """x flattened and zero-padded to whole blocks, [n / BLOCK, BLOCK]."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.view(-1, BLOCK)


def _quantize(x):
    """Blockwise absmax int8 quantization over the flattened tensor ->
    (int8 [n / BLOCK, BLOCK], fp32 scales [n / BLOCK, 1])."""
    blocks = _blocks(x)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.div(blocks, torch.clamp(scale, min=1e-12))
    q = q.round_().clamp_(-127, 127)
    return q.to(torch.int8), scale.to(torch.float32)


def _dequantize(q, scale, shape):
    n = 1
    for s in shape:
        n *= s
    flat = q.to(torch.float32).mul_(scale).reshape(-1)
    return flat[:n].reshape(shape)


class MomentState(NamedTuple):
    """Either an fp32 tensor (scale None) or (int8 blocks, fp32 scales)."""

    value: Any
    scale: Any  # None when unquantized


def named(params) -> dict:
    """{name: tensor} of a module's parameters, or the mapping itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _zero_moment(p, cfg: AdamConfig) -> MomentState:
    if cfg.quantize_moments:
        nb = -(-p.numel() // BLOCK)
        return MomentState(
            torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
            torch.zeros((nb, 1), dtype=torch.float32, device=p.device))
    return MomentState(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device), None)


def init_state(params, cfg: AdamConfig) -> dict:
    """Zero moments for every parameter (a module or {name: tensor}) and
    step 0, on the parameters' device."""
    params = named(params)
    device = next(iter(params.values())).device
    return {"m": {n: _zero_moment(p, cfg) for n, p in params.items()},
            "v": {n: _zero_moment(p, cfg) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32."""
    total = None
    for g in tensors:
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_factor(gnorm, cfg: AdamConfig) -> torch.Tensor:
    """min(1, grad_clip / max(gnorm, 1e-9)), as a tensor beside gnorm."""
    return torch.clamp(gnorm.new_tensor(cfg.grad_clip)
                       / torch.clamp(gnorm, min=1e-9), max=1.0)


def bias_corrections(step, cfg: AdamConfig):
    """(1 - b1 ** step, 1 - b2 ** step) in fp32, step an int32 tensor."""
    s = step.to(torch.float32)
    return 1 - torch.pow(cfg.b1, s), 1 - torch.pow(cfg.b2, s)


@torch.no_grad()
def update_leaf(p, g, m_st: MomentState, v_st: MomentState, clip,
                corrections, cfg: AdamConfig) -> None:
    """One tensor's AdamW update in place: p, and m_st / v_st's tensors.
    `clip` is `clip_factor` of the global norm, `corrections` the step's
    `bias_corrections`."""
    bc1, bc2 = corrections
    gs = g.to(torch.float32) * clip  # a fresh buffer, g stays as it was
    if cfg.quantize_moments:
        m = _dequantize(m_st.value, m_st.scale, p.shape)
        v = _dequantize(v_st.value, v_st.scale, p.shape)
    else:
        m, v = m_st.value, v_st.value
    tmp = torch.square(gs)
    v.mul_(cfg.b2).add_(tmp.mul_(1 - cfg.b2))  # b2 v + (1 - b2) g^2
    m.mul_(cfg.b1).add_(gs.mul_(1 - cfg.b1))  # b1 m + (1 - b1) g
    mh = torch.div(m, bc1, out=gs)
    vh = torch.div(v, bc2, out=tmp)
    delta = mh.div_(vh.sqrt_().add_(cfg.eps))  # mh / (sqrt(vh) + eps)
    p32 = p if p.dtype == torch.float32 else p.to(torch.float32)
    delta.add_(torch.mul(p32, cfg.weight_decay, out=tmp))
    p32.sub_(delta.mul_(cfg.lr))
    if p32 is not p:
        p.copy_(p32)
    if cfg.quantize_moments:
        for st, x in ((m_st, m), (v_st, v)):
            q, s = _quantize(x)
            st.value.copy_(q)
            st.scale.copy_(s)


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: AdamConfig):
    """One AdamW step in place over {name: parameter} (or a module),
    given {name: gradient}: advances state["step"], updates every
    parameter and its moments, and returns the gradients' global norm
    before clipping (a tensor on the parameters' device)."""
    params = named(params)
    gn = global_norm(grads[n] for n in params)
    clip = clip_factor(gn, cfg)
    state["step"].add_(1)
    corrections = bias_corrections(state["step"], cfg)
    for n, p in params.items():
        update_leaf(p, grads[n], state["m"][n], state["v"][n], clip,
                    corrections, cfg)
    return gn
