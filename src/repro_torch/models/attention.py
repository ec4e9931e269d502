"""GQA attention: train/prefill over the whole sequence, and cached decode.

Mirrors `repro.models.attention`.  `full_attention(use_kernel=True)` (or
`flags.ATTN_IMPL == "flash"`) runs the hand-written flash kernel through
`kernels.ops.flash_attention` in the `[B, H, S, D]` layout: on a CUDA
tensor it launches the kernel or raises, on a CPU tensor it takes the
kernel's plain version.  Otherwise `_naive_attention`, the counterpart of
the reference's XLA einsum path, builds the whole [B, H, S, S] score
tensor.  As in the reference, the kernel path ignores `cfg.window`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from . import flags, layers

NEG = -1e30  # the reference's mask constant, not -inf


class Attention(nn.Module):
    """wq [d, H hd], wk and wv [d, KH hd], wo [H hd, d]: `x @ w`."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq = nn.Parameter(wq)
        self.wk = nn.Parameter(wk)
        self.wv = nn.Parameter(wv)
        self.wo = nn.Parameter(wo)


def init(generator, cfg: ArchConfig, dtype=torch.float32, device=None):
    hd = cfg.hd
    kw = dict(dtype=dtype, device=device)
    return Attention(
        layers.dense_init(generator, cfg.d_model, cfg.n_heads * hd, **kw),
        layers.dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, **kw),
        layers.dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, **kw),
        layers.dense_init(generator, cfg.n_heads * hd, cfg.d_model, **kw))


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, S_max, KH, hd]
    v: torch.Tensor
    pos: int          # current length (the shared write position)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    hd = cfg.hd
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos=0)


def _qkv(p, x, cfg: ArchConfig, rope, positions=None):
    B, S, _ = x.shape
    hd = cfg.hd
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p.wk).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p.wv).reshape(B, S, cfg.n_kv_heads, hd)
    if rope is not None:
        cos, sin, rot = rope
        q = layers.apply_rope(q, cos, sin, rot, positions)
        k = layers.apply_rope(k, cos, sin, rot, positions)
    return q, k, v


def _naive_attention(q, k, v, cfg: ArchConfig, causal: bool):
    S = q.shape[1]
    rep = cfg.n_heads // cfg.n_kv_heads
    kf = k.repeat_interleave(rep, dim=2)
    vf = v.repeat_interleave(rep, dim=2)
    scale = cfg.hd ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q, kf) * scale
    if causal:
        ii = torch.arange(S, device=q.device)
        mask = ii[:, None] >= ii[None, :]
        if cfg.window:
            mask = mask & (ii[:, None] - ii[None, :] < cfg.window)
        logits = torch.where(mask, logits, NEG)
    probs = torch.softmax(logits.to(layers.acc_dtype(logits.dtype)),
                          dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, vf)


def full_attention(p, x, cfg: ArchConfig, rope, *, causal: bool = True,
                   use_kernel: bool = False):
    """Train/prefill attention over the whole sequence."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, rope)
    if use_kernel or flags.ATTN_IMPL == "flash":
        o = ops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal).transpose(1, 2)
    elif flags.ATTN_IMPL == "naive":
        o = _naive_attention(q, k, v, cfg, causal)
    else:
        raise NotImplementedError(
            f"ATTN_IMPL={flags.ATTN_IMPL!r}: the port runs 'naive' and "
            f"'flash'; 'chunked' (_chunked_attention) is still to port, "
            f"ROADMAP.md Queue 1 item 8")
    o = o.reshape(B, S, cfg.n_heads * cfg.hd)
    return o @ p.wo


def decode_attention(p, x, cfg: ArchConfig, rope, cache: KVCache):
    """One-token decode against the KV cache.

    Writes the new k, v into the cache tensors in place (the reference's
    `dynamic_update_slice` returns new arrays; the port saves the copy).
    The write index clamps to max_len - 1 as `dynamic_update_slice` does,
    while the live mask stays `tpos <= pos`, so past max_len every slot is
    live and the last one is overwritten each step.
    """
    B, S, _ = x.shape
    assert S == 1
    hd = cfg.hd
    pos = cache.pos
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, cfg, rope, positions)
    T = cache.k.shape[1]
    at = min(max(pos, 0), T - 1)
    cache.k[:, at] = k[:, 0].to(cache.k.dtype)
    cache.v[:, at] = v[:, 0].to(cache.v.dtype)
    rep = cfg.n_heads // cfg.n_kv_heads
    scale = hd ** -0.5
    qg = q.reshape(B, 1, cfg.n_kv_heads, rep, hd)
    logits = torch.einsum("bskrd,btkd->bkrst", qg,
                          cache.k.to(x.dtype))[..., 0, :]
    logits = logits * scale  # [B, KH, rep, T]
    tpos = torch.arange(T, device=x.device)
    live = tpos <= pos
    if cfg.window:
        live = live & (tpos > pos - cfg.window)
    logits = torch.where(live, logits, NEG)
    probs = torch.softmax(logits.to(layers.acc_dtype(logits.dtype)),
                          dim=-1).to(x.dtype)
    o = torch.einsum("bkrt,btkd->bkrd", probs, cache.v.to(x.dtype))
    o = o.reshape(B, 1, cfg.n_heads * hd)
    return o @ p.wo, KVCache(k=cache.k, v=cache.v, pos=pos + 1)
