"""FFN blocks: the GLU and the mixture of experts (mirrors
`repro.models.ffn`).

The MoE dispatch is the assembly pipeline's aggregated exchange: tokens
sort by destination expert through `core/exchange._bucket`, rank within
their run, and scatter into a capacity-padded [E, C, d] buffer, experts
as owner shards (DESIGN.md §4).  The rows `_bucket` refuses for capacity
are filtered out before each scatter (the reference drops them in its
`mode="drop"` scatters); the combine is an `index_add_`, atomic on the
card, so the card's sums of a token's k expert rows are held to a
tolerance, not bit for bit.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.exchange import _bucket
from . import layers


class GLU(nn.Module):
    """wi, wg [d, f], wo [f, d]: act(x @ wg) * (x @ wi) @ wo."""

    def __init__(self, wi, wg, wo):
        super().__init__()
        self.wi = nn.Parameter(wi)
        self.wg = nn.Parameter(wg)
        self.wo = nn.Parameter(wo)


def glu_init(generator, d: int, f: int, dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    return GLU(layers.dense_init(generator, d, f, **kw),
               layers.dense_init(generator, d, f, **kw),
               layers.dense_init(generator, f, d, **kw))


def glu(p, x, act: str):
    a = layers.act_fn(act)
    return (a(x @ p.wg) * (x @ p.wi)) @ p.wo


class MoE(nn.Module):
    """router [d, E], wi / wg [E, d, f], wo [E, f, d] (E counts the padded
    experts), and `shared`, a GLU of d x n_shared f, or None."""

    def __init__(self, router, wi, wg, wo, shared=None):
        super().__init__()
        self.router = nn.Parameter(router)
        self.wi = nn.Parameter(wi)
        self.wg = nn.Parameter(wg)
        self.wo = nn.Parameter(wo)
        self.shared = shared


def moe_init(generator, cfg: ArchConfig, dtype=torch.float32, device=None):
    """The reference's shapes and scales: the router a dense init, the
    experts N(0, 1) / sqrt(d) (wi, wg) and / sqrt(f) (wo)."""
    E = cfg.n_experts + cfg.expert_pad
    d, f = cfg.d_model, cfg.moe_d_ff
    kw = dict(dtype=dtype, device=device)
    router = layers.dense_init(generator, d, E, **kw)
    experts = [layers._normal(generator, shape, dtype, device).mul_(scale)
               for shape, scale in (((E, d, f), d ** -0.5),
                                    ((E, d, f), d ** -0.5),
                                    ((E, f, d), f ** -0.5))]
    shared = (glu_init(generator, d, cfg.n_shared_experts * f, **kw)
              if cfg.n_shared_experts else None)
    return MoE(router, *experts, shared)


def top_k(probs, k: int):
    """`jax.lax.top_k` on the last axis: values in descending order, ties
    to the lower index (a stable descending sort; `torch.topk` does not
    promise the tie order, and the order feeds the dispatch ranks)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tokens: int, cfg: ArchConfig,
             capacity_factor: float = 1.25) -> int:
    """Rows an expert takes: the reference's
    max(128, int(cf T k / E) // 128 * 128)."""
    E = cfg.n_experts + cfg.expert_pad
    return max(128, int(capacity_factor * tokens * cfg.top_k / E)
               // 128 * 128)


def moe(p, x, cfg: ArchConfig, *, capacity_factor: float = 1.25):
    """Top-k MoE with sort-based capacity dispatch.

    x: [B, S, d] -> (out [B, S, d], aux), aux the Switch load-balance
    loss E * sum_e f_e P_e.  The padded experts' logits are -1e30, so no
    token routes there; (token, expert) pairs past an expert's capacity C
    (`_bucket`'s overflow) are dropped, as in the reference.
    """
    B, S, d = x.shape
    E = cfg.n_experts + cfg.expert_pad
    k = cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    logits = (xt @ p.router).to(layers.acc_dtype(x.dtype))
    if cfg.expert_pad:
        pad = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # aux load-balance loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=probs.dtype, device=x.device).index_add_(
        0, top_e.reshape(-1), torch.ones_like(top_p).reshape(-1)) / (T * k)
    aux = E * torch.sum(me * ce)
    # ---- dispatch: the assembly exchange's sort-bucket ----
    flat_e = top_e.reshape(T * k).to(torch.int32)
    flat_w = top_p.reshape(T * k)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    C = capacity(T, cfg, capacity_factor)
    perm, slot, keep, _ = _bucket(
        flat_e, torch.ones((T * k,), dtype=torch.bool, device=x.device),
        E, C)
    kept = perm[keep]             # (token, expert) pairs that fit
    slots = slot[keep]
    toks = flat_t[kept]
    buf = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    buf[slots] = xt[toks]
    xe = buf.reshape(E, C, d)
    # ---- expert compute (batched products over the expert axis) ----
    a = layers.act_fn(cfg.act)
    h = a(torch.bmm(xe, p.wg)) * torch.bmm(xe, p.wi)
    ye = torch.bmm(h, p.wo).reshape(E * C, d)
    # ---- combine: scatter back weighted by the router probability ----
    w = flat_w[kept].to(x.dtype)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, toks, ye[slots] * w[:, None])
    if p.shared is not None:
        out = out + glu(p.shared, xt, cfg.act)
    return out.reshape(B, S, d), aux
