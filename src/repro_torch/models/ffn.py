"""FFN blocks: the GLU (mirrors `repro.models.ffn.glu_init` / `glu`).

Mixture-of-experts (`moe`, on `core/exchange._bucket`) waits for an MoE
config (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import torch
from torch import nn

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
