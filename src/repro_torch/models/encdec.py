"""Encoder-decoder stack, the whisper-large-v3 backbone (mirrors
`repro.models.encdec`).

The audio conv frontend is a stub, as in the reference: the caller hands
over frame embeddings [B, S_audio, d_model] (`registry.input_specs`).
Positions are learned (`pos_enc`, `pos_dec`), norms are layernorms, and
each decoder layer adds a cross-attention into the encoder's output:

  init_params(cfg, generator, device=...)   -> EncDecLM
  encode(cfg, model, frames)                -> enc_out [B, S_audio, d]
  forward(cfg, model, batch, use_kernel=...) -> (logits [B, S, Vpad], 0.0)
  loss_fn(cfg, model, batch)                 -> scalar training loss
  init_decode_state(cfg, B, max_len)         -> {"caches", "enc_out", "pos"}
  decode_step(cfg, model, state, tokens)     -> (logits [B, 1, Vpad], state)

`forward(use_kernel=True)` runs the decoder's causal self-attention
through the flash kernel (one launch a decoder layer on a CUDA tensor).
The encoder's non-causal attention takes no `use_kernel`, as in the
reference: it reaches the kernel only under `flags.ATTN_IMPL == "flash"`.
The cross-attention is a plain einsum over the encoder states, outside
any kernel in both packages (the flash op takes equal q and kv lengths).

`init_decode_state` zeroes `enc_out`, as the reference's does, and
nothing in either package writes it: a caller that serves audio puts
`encode`'s output in `state["enc_out"]` before decoding (the state is
made under `torch.inference_mode`, so replace the tensor rather than
copy into it outside that mode), or the decoder attends to zeros
(ROADMAP.md Queue 3).  `remat` is accepted and does nothing on one
eager card; `forward` runs under `torch.inference_mode()` unless
`grad=True`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from . import attention, ffn, layers


class EncLayer(nn.Module):
    """Pre-norm non-causal attention + GLU: ln1, attn, ln2, mlp."""

    def __init__(self, attn, mlp, ln1, ln2):
        super().__init__()
        self.attn = attn
        self.mlp = mlp
        self.ln1 = nn.Parameter(ln1)
        self.ln2 = nn.Parameter(ln2)


class DecLayer(nn.Module):
    """Pre-norm causal self-attention (ln1, attn), cross-attention into
    the encoder's output (ln2, xattn) and GLU (ln3, mlp)."""

    def __init__(self, attn, xattn, mlp, ln1, ln2, ln3):
        super().__init__()
        self.attn = attn
        self.xattn = xattn
        self.mlp = mlp
        self.ln1 = nn.Parameter(ln1)
        self.ln2 = nn.Parameter(ln2)
        self.ln3 = nn.Parameter(ln3)


class EncDecLM(nn.Module):
    """embed [Vpad, d], pos_dec [max_seq, d], pos_enc [enc_max_seq, d],
    `enc` (n_enc_layers `EncLayer`s), `dec` (n_layers `DecLayer`s), ln_f,
    ln_enc [d] and lm_head [d, Vpad]."""

    def __init__(self, cfg: ArchConfig, embed, pos_dec, pos_enc, enc, dec,
                 ln_f, ln_enc, lm_head):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.pos_dec = nn.Parameter(pos_dec)
        self.pos_enc = nn.Parameter(pos_enc)
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)
        self.ln_f = nn.Parameter(ln_f)
        self.ln_enc = nn.Parameter(ln_enc)
        self.lm_head = nn.Parameter(lm_head)


def _check(cfg: ArchConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                         f"'encdec'; use models.transformer")


def init_params(cfg: ArchConfig, generator=None, *, device=None,
                dtype=torch.float32) -> EncDecLM:
    """Random weights from `generator` with the reference's shapes and
    scales (learned positions N(0, 1) x 0.01).  Runs on the card unless
    `device` is given; device="meta" builds the shapes only."""
    _check(cfg)
    device = layers.resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    d = cfg.d_model
    vpad = layers.pad_to_multiple(cfg.vocab, 16)
    embed = layers.embed_init(generator, vpad, d, **kw)
    pos_dec = layers._normal(generator, (cfg.max_seq, d), dtype, device) * 0.01
    pos_enc = layers._normal(generator, (cfg.enc_max_seq, d), dtype,
                             device) * 0.01

    def norm():
        return layers.norm_init(d, **kw)

    enc = [EncLayer(attention.init(generator, cfg, **kw),
                    ffn.glu_init(generator, d, cfg.d_ff, **kw), norm(), norm())
           for _ in range(cfg.n_enc_layers)]
    dec = [DecLayer(attention.init(generator, cfg, **kw),
                    attention.init(generator, cfg, **kw),
                    ffn.glu_init(generator, d, cfg.d_ff, **kw),
                    norm(), norm(), norm())
           for _ in range(cfg.n_layers)]
    lm_head = layers.dense_init(generator, d, vpad, **kw)
    return EncDecLM(cfg, embed, pos_dec, pos_enc, enc, dec, norm(), norm(),
                    lm_head)


def _cross_attention(p, x, enc_out, cfg: ArchConfig):
    """q from the decoder's x [B, S, d], k and v from enc_out [B, Se, d];
    softmax in fp32, cast back to x's dtype."""
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    hd = cfg.hd
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, hd)
    k = (enc_out @ p.wk).reshape(B, Se, cfg.n_kv_heads, hd)
    v = (enc_out @ p.wv).reshape(B, Se, cfg.n_kv_heads, hd)
    rep = cfg.n_heads // cfg.n_kv_heads
    kf = k.repeat_interleave(rep, dim=2)
    vf = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, kf) * (hd ** -0.5)
    probs = torch.softmax(logits.to(layers.acc_dtype(logits.dtype)),
                          dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", probs, vf)
    return o.reshape(B, S, cfg.n_heads * hd) @ p.wo


def encode(cfg: ArchConfig, model: EncDecLM, frames, *, remat: bool = True,
           grad: bool = False):
    """frames [B, S_audio, d_model] (the stub frontend's output, S_audio <=
    enc_max_seq) -> the encoder's states, layernormed by ln_enc."""
    _check(cfg)
    eps = cfg.norm_eps
    with torch.inference_mode(not grad):
        h = frames + model.pos_enc[:frames.shape[1]][None]
        for lp in model.enc:
            h = h + attention.full_attention(
                lp.attn, layers.layernorm(h, lp.ln1, eps=eps), cfg, None,
                causal=False)
            h = h + ffn.glu(lp.mlp, layers.layernorm(h, lp.ln2, eps=eps),
                            cfg.act)
        return layers.layernorm(h, model.ln_enc, eps=eps)


def _cross_and_mlp(cfg: ArchConfig, lp: DecLayer, h, enc_out):
    """A decoder layer after its self-attention: h plus the cross-attention
    on ln2(h), then plus the GLU on ln3(h)."""
    eps = cfg.norm_eps
    h = h + _cross_attention(lp.xattn, layers.layernorm(h, lp.ln2, eps=eps),
                             enc_out, cfg)
    return h + ffn.glu(lp.mlp, layers.layernorm(h, lp.ln3, eps=eps), cfg.act)


def forward(cfg: ArchConfig, model: EncDecLM, batch, *,
            use_kernel: bool = False, remat: bool = True,
            grad: bool = False):
    """Teacher-forced forward: batch = {"frontend": frames [B, Sa, d],
    "tokens": [B, S]} -> (logits [B, S, Vpad], a float32 zero)."""
    with torch.inference_mode(not grad):
        enc_out = encode(cfg, model, batch["frontend"], grad=grad)
        tokens = batch["tokens"]
        h = model.embed[tokens] + model.pos_dec[:tokens.shape[1]][None]
        for lp in model.dec:
            h = h + attention.full_attention(
                lp.attn, layers.layernorm(h, lp.ln1, eps=cfg.norm_eps), cfg,
                None, causal=True, use_kernel=use_kernel)
            h = _cross_and_mlp(cfg, lp, h, enc_out)
        h = layers.layernorm(h, model.ln_f, eps=cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h @ model.lm_head, aux


def loss_fn(cfg: ArchConfig, model: EncDecLM, batch, *,
            use_kernel: bool = False, aux_weight: float = 0.0):
    """Mean next-token cross-entropy of the teacher-forced decoder over
    `forward(grad=True)`'s logits (the family has no aux loss, so
    aux_weight is unused, as in the reference)."""
    logits, _ = forward(cfg, model, batch, use_kernel=use_kernel, grad=True)
    targets, mask = layers.next_token_targets(batch["tokens"])
    return layers.cross_entropy(logits, targets, mask)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None):
    """One KV cache a decoder layer at the shared write position `pos`,
    and `enc_out` [batch, enc_max_seq, d] zeroed, both in `dtype`."""
    _check(cfg)
    device = layers.resolve_device(device)
    with torch.inference_mode():
        return {"caches": [attention.init_cache(cfg, batch, max_len, dtype,
                                                device)
                           for _ in range(cfg.n_layers)],
                "enc_out": torch.zeros((batch, cfg.enc_max_seq, cfg.d_model),
                                       dtype=dtype, device=device),
                "pos": 0}


def decode_step(cfg: ArchConfig, model: EncDecLM, state, tokens):
    """One-token decode.  tokens: [B, 1] -> (logits [B, 1, Vpad], state).

    The position's learned row is pos_dec[pos] (clamped to the table's
    last row, as `dynamic_slice` clamps); the cross-attention reads
    `state["enc_out"]` cast to the embeddings' dtype.  The KV caches are
    updated in place; the returned state holds pos + 1.
    """
    _check(cfg)
    with torch.inference_mode():
        pos = state["pos"]
        row = min(max(pos, 0), model.pos_dec.shape[0] - 1)
        h = model.embed[tokens] + model.pos_dec[row][None, None]
        enc_out = state["enc_out"].to(h.dtype)
        caches = []
        for lp, cache in zip(model.dec, state["caches"]):
            a, cache = attention.decode_attention(
                lp.attn, layers.layernorm(h, lp.ln1, eps=cfg.norm_eps), cfg,
                None, attention.KVCache(cache.k, cache.v, pos))
            h = _cross_and_mlp(cfg, lp, h + a, enc_out)
            caches.append(cache)
        h = layers.layernorm(h, model.ln_f, eps=cfg.norm_eps)
        return h @ model.lm_head, {"caches": caches,
                                   "enc_out": state["enc_out"],
                                   "pos": pos + 1}
