"""GQA attention: train/prefill over the whole sequence, and cached decode.

Mirrors `repro.models.attention`.  `full_attention(use_kernel=True)` (or
`flags.ATTN_IMPL == "flash"`) runs the hand-written flash kernel through
`kernels.ops.flash_attention` in the `[B, H, S, D]` layout: on a CUDA
tensor it launches the kernel or raises, on a CPU tensor it takes the
kernel's plain version.  `flags.ATTN_IMPL == "chunked"` at S >= 1024 runs
`_chunked_attention`, the reference's online softmax over 512 x 512 blocks
outside any kernel (plain torch here, as XLA there).  Otherwise
`_naive_attention`, the counterpart of the reference's XLA einsum path,
builds the whole [B, H, S, S] score tensor.  As in the reference, the
kernel path ignores `cfg.window` and the other two apply it.
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


def _chunked_attention(q, k, v, cfg: ArchConfig, causal: bool,
                       block_q: int = 512, block_k: int = 512):
    """Online-softmax attention over (block_q, block_k) block pairs, the
    reference's `_chunked_attention`: the live score tensor is
    [B, H, block_q, block_k], not [B, H, S, S].

    S must be a multiple of both blocks (cut to S when S is shorter), as
    the reference asserts.  The causal and window masks (-1e30) are
    applied per block pair and fully masked pairs still run, so a row whose
    first blocks are all masked sums them in until a live block's maximum
    scales them away, as there.  m, l and acc are fp32 (fp64 for fp64
    inputs); l is clamped at 1e-30.
    """
    B, S, H, hd = q.shape
    rep = H // cfg.n_kv_heads
    kf = k.repeat_interleave(rep, dim=2)
    vf = v.repeat_interleave(rep, dim=2)
    bq, bk = min(block_q, S), min(block_k, S)
    if S % bq or S % bk:
        raise ValueError(f"_chunked_attention: S={S} is not a multiple of "
                         f"the blocks ({bq}, {bk})")
    scale = hd ** -0.5
    acc_t = layers.acc_dtype(q.dtype)
    ii = torch.arange(bq, device=q.device)
    jj = torch.arange(bk, device=q.device)
    outs = []
    for qi in range(S // bq):
        qx = q[:, qi * bq:(qi + 1) * bq]
        acc = torch.zeros((B, H, bq, hd), dtype=acc_t, device=q.device)
        m = torch.full((B, H, bq), NEG, dtype=acc_t, device=q.device)
        l = torch.zeros((B, H, bq), dtype=acc_t, device=q.device)
        for kj in range(S // bk):
            kx = kf[:, kj * bk:(kj + 1) * bk]
            vx = vf[:, kj * bk:(kj + 1) * bk]
            s = torch.einsum("bqhd,bkhd->bhqk", qx, kx).to(acc_t) * scale
            if causal:
                qpos = qi * bq + ii
                kpos = kj * bk + jj
                mask = qpos[:, None] >= kpos[None, :]
                if cfg.window:
                    mask = mask & (qpos[:, None] - kpos[None, :] < cfg.window)
                s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype), vx).to(acc_t)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))  # [B, bq, H, hd]
    return torch.cat(outs, dim=1)


def full_attention(p, x, cfg: ArchConfig, rope, *, causal: bool = True,
                   use_kernel: bool = False):
    """Train/prefill attention over the whole sequence."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, rope)
    if use_kernel or flags.ATTN_IMPL == "flash":
        o = ops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal).transpose(1, 2)
    elif flags.ATTN_IMPL == "chunked" and S >= 1024:
        o = _chunked_attention(q, k, v, cfg, causal)
    else:
        o = _naive_attention(q, k, v, cfg, causal)
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
