"""Sequence mixers: `repro.models.ssm`'s Mamba-2 (zamba2) and xLSTM
(mLSTM matrix memory + sLSTM scalar memory) halves.

  mamba2_init(generator, cfg, device=...)   -> Mamba2 (an nn.Module)
  ssd_chunked(x, a, b, c, chunk=128)        -> y, the plain chunked scan
  mamba2_block(p, x, cfg, use_kernel=...)   -> the train/prefill mixer
  mamba2_init_state(cfg, B), mamba2_step    -> one-token decode
  mlstm_init, mlstm_block, mlstm_init_state, mlstm_step   (MLSTM)
  slstm_init, slstm_block, slstm_init_state, slstm_step   (SLSTM)

`ssd_chunked` is `kernels.ref.ssd_scan_ref`, the plain version of the
ssd_scan kernel: the reference's chunked form with the causal mask taken
before `exp`, so it stays finite where the reference's overflows
(ROADMAP.md Queue 3).  The reference's `mamba2_block` and `mlstm_block`
always run the jnp mirror; here `use_kernel=True` sends the scan through
`ops.ssd_scan`, where the TPU kernel was meant to go (one launch a layer
on a CUDA tensor; the mLSTM's heads of d / H = 192 take the wide kernel).
The chunk is min(chunk, S), and S must be a multiple of it on both
paths.  The mLSTM's matrix memory C_t = f_t C_{t-1} + i_t v_t k_t^T is
that scan with P = value dim, N = key dim, decay log f_t, input i_t v_t,
B = k_t and C = q_t.  The sLSTM is a recurrent cell that the reference
runs in `lax.scan` outside any Pallas kernel; here it is a Python loop
over the positions in plain torch, in the reference's dtypes (its carry
in x's dtype in the block, in fp32 in the one-token step).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops, ref
from . import layers

MAMBA2_PARAMS = ("win", "wb", "wc", "wa", "wgate", "wout", "a_bias")


class Mamba2(nn.Module):
    """win, wgate [d, d_in], wb, wc [d, H N], wa [d, H], wout [d_in, d],
    a_bias [H]: the reference's names and `[d_in, d_out]` layout."""

    def __init__(self, win, wb, wc, wa, wgate, wout, a_bias):
        super().__init__()
        for name, w in zip(MAMBA2_PARAMS,
                           (win, wb, wc, wa, wgate, wout, a_bias)):
            setattr(self, name, nn.Parameter(w))


def _dims(cfg: ArchConfig):
    """(d_in, H, P, N): d_in = 2 d in H heads of P = ssm_head_dim."""
    d_in = 2 * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_init(generator, cfg: ArchConfig, dtype=torch.float32,
                device=None) -> Mamba2:
    d = cfg.d_model
    d_in, H, _, N = _dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return Mamba2(
        layers.dense_init(generator, d, d_in, **kw),
        layers.dense_init(generator, d, H * N, **kw),
        layers.dense_init(generator, d, H * N, **kw),
        layers.dense_init(generator, d, H, **kw),
        layers.dense_init(generator, d, d_in, **kw),
        layers.dense_init(generator, d_in, d, **kw),
        torch.zeros((H,), **kw))


def ssd_chunked(x, a, b, c, *, chunk: int = 128):
    """Chunked SSD scan (plain torch).  x [B,S,H,P] a [B,S,H] b,c [B,S,H,N]."""
    return ref.ssd_scan_ref(x, a, b, c, chunk=chunk)


class SSMState(NamedTuple):
    state: torch.Tensor  # [B, H, P, N] float32


def mamba2_block(p: Mamba2, x, cfg: ArchConfig, *, chunk: int = 128,
                 use_kernel: bool = False):
    """Full-sequence Mamba-2 mixer (train/prefill)."""
    B, S, _ = x.shape
    d_in, H, P, N = _dims(cfg)
    xin = (x @ p.win).reshape(B, S, H, P)
    bmat = (x @ p.wb).reshape(B, S, H, N)
    cmat = (x @ p.wc).reshape(B, S, H, N)
    a = -F.softplus((x @ p.wa) + p.a_bias)  # log-decay < 0
    scan = ops.ssd_scan if use_kernel else ssd_chunked
    y = scan(xin, a, bmat, cmat, chunk=chunk)
    gate = F.silu(x @ p.wgate).reshape(B, S, H, P)
    return (y * gate).reshape(B, S, d_in) @ p.wout


def mamba2_init_state(cfg: ArchConfig, batch: int, device=None) -> SSMState:
    _, H, P, N = _dims(cfg)
    return SSMState(state=torch.zeros((batch, H, P, N), dtype=torch.float32,
                                      device=device))


def mamba2_step(p: Mamba2, x, cfg: ArchConfig, st: SSMState):
    """One-token decode.  x: [B, 1, d] -> (out [B, 1, d], new state)."""
    B = x.shape[0]
    d_in, H, P, N = _dims(cfg)
    xin = (x @ p.win).reshape(B, H, P)
    bmat = (x @ p.wb).reshape(B, H, N)
    cmat = (x @ p.wc).reshape(B, H, N)
    a = -F.softplus((x @ p.wa) + p.a_bias).reshape(B, H)
    decay = torch.exp(a.float())
    new_state = st.state * decay[:, :, None, None] + (
        xin.float()[:, :, :, None] * bmat.float()[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, cmat.float())
    gate = F.silu(x @ p.wgate).reshape(B, H, P)
    out = (y.to(x.dtype) * gate).reshape(B, 1, d_in) @ p.wout
    return out, SSMState(state=new_state)


MLSTM_PARAMS = ("wq", "wk", "wv", "wif", "wo", "wog")
SLSTM_PARAMS = ("wx", "wh")


class MLSTM(nn.Module):
    """wq, wk, wv, wo, wog [d, d], wif [d, 2 H] (input gate logits, then
    forget gate logits): the reference's names and layout."""

    def __init__(self, wq, wk, wv, wif, wo, wog):
        super().__init__()
        for name, w in zip(MLSTM_PARAMS, (wq, wk, wv, wif, wo, wog)):
            setattr(self, name, nn.Parameter(w))


class SLSTM(nn.Module):
    """wx, wh [d, 4 d]: the input and recurrent projections of the i, f,
    z, o gates, in that order."""

    def __init__(self, wx, wh):
        super().__init__()
        self.wx = nn.Parameter(wx)
        self.wh = nn.Parameter(wh)


def mlstm_init(generator, cfg: ArchConfig, dtype=torch.float32,
               device=None) -> MLSTM:
    d, H = cfg.d_model, cfg.n_heads
    kw = dict(dtype=dtype, device=device)
    wq, wk, wv = (layers.dense_init(generator, d, d, **kw) for _ in range(3))
    return MLSTM(wq, wk, wv, layers.dense_init(generator, d, 2 * H, **kw),
                 layers.dense_init(generator, d, d, **kw),
                 layers.dense_init(generator, d, d, **kw))


def mlstm_block(p: MLSTM, x, cfg: ArchConfig, *, chunk: int = 128,
                use_kernel: bool = False):
    """mLSTM with sigmoid forget gates through the SSD scan (train/prefill)."""
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    q = (x @ p.wq).reshape(B, S, H, hd) / (hd ** 0.5)
    k = (x @ p.wk).reshape(B, S, H, hd)
    v = (x @ p.wv).reshape(B, S, H, hd)
    gif = x @ p.wif
    i_gate = torch.sigmoid(gif[..., :H])                       # [B, S, H]
    log_f = F.logsigmoid(gif[..., H:].to(layers.acc_dtype(x.dtype)))
    scan = ops.ssd_scan if use_kernel else ssd_chunked
    y = scan(v * i_gate[..., None], log_f, k, q, chunk=chunk)
    og = torch.sigmoid(x @ p.wog)
    return (y.reshape(B, S, d) * og) @ p.wo


def mlstm_init_state(cfg: ArchConfig, batch: int, device=None) -> SSMState:
    hd = cfg.d_model // cfg.n_heads
    return SSMState(state=torch.zeros((batch, cfg.n_heads, hd, hd),
                                      dtype=torch.float32, device=device))


def mlstm_step(p: MLSTM, x, cfg: ArchConfig, st: SSMState):
    """One-token decode.  x: [B, 1, d] -> (out [B, 1, d], new state)."""
    B, _, d = x.shape
    H = cfg.n_heads
    hd = d // H
    q = (x @ p.wq).reshape(B, H, hd) / (hd ** 0.5)
    k = (x @ p.wk).reshape(B, H, hd)
    v = (x @ p.wv).reshape(B, H, hd)
    gif = (x @ p.wif).reshape(B, 2 * H)
    i_gate = torch.sigmoid(gif[:, :H])
    f_gate = torch.sigmoid(gif[:, H:]).float()
    new_state = st.state * f_gate[:, :, None, None] + (
        (v * i_gate[..., None]).float()[:, :, :, None]
        * k.float()[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, q.float())
    og = torch.sigmoid(x @ p.wog).reshape(B, H, hd)
    out = (y.to(x.dtype) * og).reshape(B, 1, d) @ p.wo
    return out, SSMState(state=new_state)


def slstm_init(generator, cfg: ArchConfig, dtype=torch.float32,
               device=None) -> SLSTM:
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return SLSTM(layers.dense_init(generator, d, 4 * d, **kw),
                 layers.dense_init(generator, d, 4 * d, **kw))


def _slstm_cell(g, c):
    """(h, c) from the gate pre-activations g [B, 4 d] and the cell c."""
    i, f, z, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
    return torch.sigmoid(o) * torch.tanh(c), c


def slstm_block(p: SLSTM, x, cfg: ArchConfig):
    """sLSTM: the scalar-memory recurrent cell, a position at a time."""
    B, S, d = x.shape
    gx = x @ p.wx  # [B, S, 4 d]
    h = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    c = h
    ys = []
    for t in range(S):
        h, c = _slstm_cell(gx[:, t] + h @ p.wh, c)
        ys.append(h)
    return torch.stack(ys, dim=1)


class SLSTMState(NamedTuple):
    h: torch.Tensor  # [B, d] float32
    c: torch.Tensor  # [B, d] float32


def slstm_init_state(cfg: ArchConfig, batch: int, device=None) -> SLSTMState:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMState(h=z, c=z)


def slstm_step(p: SLSTM, x, cfg: ArchConfig, st: SLSTMState):
    """One-token decode.  x: [B, 1, d] -> (out [B, 1, d], new state)."""
    B, _, d = x.shape
    g = x.reshape(B, d) @ p.wx + st.h.to(x.dtype) @ p.wh
    h, c = _slstm_cell(g.float(), st.c)
    return h.to(x.dtype).reshape(B, 1, d), SLSTMState(h=h, c=c)
