"""The dense decoder stack: prefill forward and cached decode.

Mirrors `repro.models.transformer` for the dense family (llama3.2-3b):

  init_params(cfg, generator, device=...)   -> Transformer (an nn.Module)
  forward(cfg, model, batch, use_kernel=...) -> (logits [B, S, Vpad], aux)
  init_decode_state(cfg, B, max_len)         -> {"caches", "pos"}
  decode_step(cfg, model, state, tokens)     -> (logits [B, 1, Vpad], state)

The reference scans one stacked pytree over the layers; here a
`Transformer` holds an `nn.ModuleList` of `DenseLayer`s whose weights keep
the reference's names and `[d_in, d_out]` layout.  PyTorch runs eagerly,
so there is no jit, scan or remat: `forward` runs under
`torch.inference_mode()` unless `grad=True`.  The vocabulary is padded to
a multiple of 16; with tied embeddings the head is `embed.T`.  The hybrid
(zamba2), xLSTM, MoE and frontend families raise (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from . import attention, ffn, layers


class DenseLayer(nn.Module):
    """Pre-norm attention + GLU: ln1, attn, ln2, mlp (absent if d_ff = 0)."""

    def __init__(self, attn, ln1, ln2, mlp=None):
        super().__init__()
        self.attn = attn
        self.ln1 = nn.Parameter(ln1)
        self.ln2 = nn.Parameter(ln2)
        self.mlp = mlp


class Transformer(nn.Module):
    """embed [Vpad, d], ln_f [d], lm_head [d, Vpad] (None when tied) and
    the layers."""

    def __init__(self, cfg: ArchConfig, embed, ln_f, dense_layers,
                 lm_head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.ln_f = nn.Parameter(ln_f)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)
        self.layers = nn.ModuleList(dense_layers)

    def head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def check_family(cfg: ArchConfig) -> None:
    """The port runs the dense family only; the rest names its ROADMAP
    item."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid family (zamba2: Mamba-2 layers, "
            f"_hybrid_forward, _hybrid_decode, ssd_scan) is the next slice, "
            f"ROADMAP.md Queue 2 item 8")
    if cfg.xlstm or cfg.is_moe or cfg.frontend or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (xLSTM, MoE, frontends, "
            f"enc-dec) is still to port, ROADMAP.md Queue 1 item 8")


def init_params(cfg: ArchConfig, generator=None, *, device=None,
                dtype=torch.float32) -> Transformer:
    """Random weights from `generator` (a torch.Generator on `device`, or
    None for the device's default), with the reference's shapes and
    scales.  Runs on the card unless `device` is given; device="meta"
    builds the shapes only."""
    check_family(cfg)
    device = layers.resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    vpad = layers.pad_to_multiple(cfg.vocab, 16)
    embed = layers.embed_init(generator, vpad, cfg.d_model, **kw)
    ln_f = layers.norm_init(cfg.d_model, **kw)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = layers.dense_init(generator, cfg.d_model, vpad, **kw)
    stack = []
    for _ in range(cfg.n_layers):
        attn = attention.init(generator, cfg, **kw)
        mlp = (ffn.glu_init(generator, cfg.d_model, cfg.d_ff, **kw)
               if cfg.d_ff else None)
        stack.append(DenseLayer(attn, layers.norm_init(cfg.d_model, **kw),
                                layers.norm_init(cfg.d_model, **kw), mlp))
    return Transformer(cfg, embed, ln_f, stack, lm_head)


def _rope(cfg: ArchConfig, max_len: int, device):
    if cfg.rope_fraction <= 0:
        return None
    return layers.rope_freqs(cfg.hd, max_len, cfg.rope_theta,
                             cfg.rope_fraction, device=device)


def _dense_layer(cfg: ArchConfig, lp: DenseLayer, h, rope, use_kernel):
    h = h + attention.full_attention(
        lp.attn, layers.rmsnorm(h, lp.ln1, cfg.norm_eps), cfg, rope,
        use_kernel=use_kernel)
    if lp.mlp is not None:
        h = h + ffn.glu(lp.mlp, layers.rmsnorm(h, lp.ln2, cfg.norm_eps),
                        cfg.act)
    return h


def forward(cfg: ArchConfig, model: Transformer, batch, *,
            use_kernel: bool = False, grad: bool = False):
    """Prefill forward -> (logits [B, S, Vpad], aux_loss).

    `use_kernel=True` runs every layer's attention through the flash
    kernel (one launch a layer on a CUDA tensor).
    """
    check_family(cfg)
    with torch.inference_mode(not grad):
        tokens = batch["tokens"]
        h = model.embed[tokens]
        rope = _rope(cfg, tokens.shape[1], h.device)
        for lp in model.layers:
            h = _dense_layer(cfg, lp, h, rope, use_kernel)
        h = layers.rmsnorm(h, model.ln_f, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h @ model.head(), aux


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None):
    """One KV cache a layer, all at the shared write position `pos`."""
    check_family(cfg)
    device = layers.resolve_device(device)
    with torch.inference_mode():
        caches = [attention.init_cache(cfg, batch, max_len, dtype, device)
                  for _ in range(cfg.n_layers)]
    return {"caches": caches, "pos": 0}


def decode_step(cfg: ArchConfig, model: Transformer, state, tokens):
    """One-token decode.  tokens: [B, 1] -> (logits [B, 1, Vpad], state).

    The caches of `state` are updated in place; the returned state holds
    the same tensors and pos + 1.
    """
    check_family(cfg)
    with torch.inference_mode():
        h = model.embed[tokens]
        rope = _rope(cfg, cfg.max_seq, h.device)
        pos = state["pos"]
        caches = []
        for lp, cache in zip(model.layers, state["caches"]):
            a, cache = attention.decode_attention(
                lp.attn, layers.rmsnorm(h, lp.ln1, cfg.norm_eps), cfg, rope,
                attention.KVCache(cache.k, cache.v, pos))
            h = h + a
            if lp.mlp is not None:
                h = h + ffn.glu(lp.mlp, layers.rmsnorm(h, lp.ln2,
                                                       cfg.norm_eps), cfg.act)
            caches.append(cache)
        h = layers.rmsnorm(h, model.ln_f, cfg.norm_eps)
        return h @ model.head(), {"caches": caches, "pos": pos + 1}
