"""Sequence mixers: the Mamba-2 half of `repro.models.ssm` (zamba2).

  mamba2_init(generator, cfg, device=...)   -> Mamba2 (an nn.Module)
  ssd_chunked(x, a, b, c, chunk=128)        -> y, the plain chunked scan
  mamba2_block(p, x, cfg, use_kernel=...)   -> the train/prefill mixer
  mamba2_init_state(cfg, B), mamba2_step    -> one-token decode

`ssd_chunked` is `kernels.ref.ssd_scan_ref`, the plain version of the
ssd_scan kernel: the reference's chunked form with the causal mask taken
before `exp`, so it stays finite where the reference's overflows
(ROADMAP.md Queue 3).  The reference's `mamba2_block` always runs the jnp
mirror; here `use_kernel=True` sends the scan through `ops.ssd_scan`,
where the TPU kernel was meant to go (one launch a layer on a CUDA
tensor).  The chunk is min(chunk, S), and S must be a multiple of it on
both paths.  The xLSTM half (mLSTM, sLSTM) raises.
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


def _xlstm(name: str):
    def unported(*args, **kwargs):
        raise NotImplementedError(
            f"ssm.{name}: the xLSTM half of models/ssm.py (mLSTM, sLSTM) is "
            f"still to port, ROADMAP.md Queue 1 item 8")
    unported.__name__ = name
    return unported


mlstm_init = _xlstm("mlstm_init")
mlstm_block = _xlstm("mlstm_block")
mlstm_init_state = _xlstm("mlstm_init_state")
mlstm_step = _xlstm("mlstm_step")
slstm_init = _xlstm("slstm_init")
slstm_block = _xlstm("slstm_block")
slstm_init_state = _xlstm("slstm_init_state")
slstm_step = _xlstm("slstm_step")
