"""Decoder stacks: the dense family, the MoE family (qwen2-moe, arctic),
the vlm family (internvl2), the hybrid family (zamba2) and the xLSTM
family, with prefill forward and cached decode.

Mirrors `repro.models.transformer` for llama3.2-3b, gemma-7b,
starcoder2-3b, chatglm3-6b, qwen2-moe-a2.7b, arctic-480b, internvl2-2b,
zamba2-7b and xlstm-125m:

  init_params(cfg, generator, device=...)   -> Transformer, HybridLM or
                                               XLSTMLM
  forward(cfg, model, batch, use_kernel=...) -> (logits [B, S, Vpad], aux)
  loss_fn(cfg, model, batch)                 -> scalar training loss
  init_decode_state(cfg, B, max_len)         -> the family's decode state
  decode_step(cfg, model, state, tokens)     -> (logits [B, 1, Vpad], state)

The reference scans stacked pytrees over the layers; here a `Transformer`
holds an `nn.ModuleList` of `DenseLayer`s (an MoE layer's `DenseLayer`
carries `moe`, and arctic's also the parallel dense `mlp`, both fed the
same normed input), and a `HybridLM` its Mamba-2
layers in groups of `attn_every` (a `mamba_tail` of the rest) and one
weight-tied `shared` attention + GLU block that runs after every group,
and an `XLSTMLM` n_layers / 2 `XLSTMPair`s (an mLSTM, then an sLSTM block,
each pre-normed).
Weights keep the reference's names and `[d_in, d_out]` layout.  PyTorch
runs eagerly, so there is no jit, scan or remat: `forward` runs under
`torch.inference_mode()` unless `grad=True`.  The vocabulary is padded to
a multiple of 16; with tied embeddings the head is `embed.T`.  `forward`
returns the MoE layers' aux losses summed (zero for the other families).
Rotary tables are built only for the families that attend (not xLSTM).
A config with a vision frontend (internvl2) carries the reference's stub
`frontend` projection [d, d]: `forward` prepends `batch["frontend"] @
frontend` to the token embeddings, builds the rotary tables over both,
and returns logits over the token positions only; `decode_step` ignores
the frontend, as the reference does.  The enc-dec family (whisper) is
`models.encdec`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from . import attention, ffn, layers, ssm


class DenseLayer(nn.Module):
    """Pre-norm attention + FFN: ln1, attn, ln2, then `moe` (an `ffn.MoE`,
    MoE family) and/or `mlp` (a GLU: the dense FFN, or arctic's parallel
    dense residual; absent if d_ff = 0)."""

    def __init__(self, attn, ln1, ln2, mlp=None, moe=None):
        super().__init__()
        self.attn = attn
        self.ln1 = nn.Parameter(ln1)
        self.ln2 = nn.Parameter(ln2)
        self.moe = moe
        self.mlp = mlp


class MambaLayer(nn.Module):
    """Pre-norm Mamba-2 mixer: ln, mixer."""

    def __init__(self, mixer, ln):
        super().__init__()
        self.mixer = mixer
        self.ln = nn.Parameter(ln)


class XLSTMPair(nn.Module):
    """One xLSTM pair: ln_m, m (an `ssm.MLSTM`), then ln_s, s (an
    `ssm.SLSTM`), each a pre-normed residual block."""

    def __init__(self, m, s, ln_m, ln_s):
        super().__init__()
        self.m = m
        self.s = s
        self.ln_m = nn.Parameter(ln_m)
        self.ln_s = nn.Parameter(ln_s)


class _LM(nn.Module):
    """embed [Vpad, d], ln_f [d], lm_head [d, Vpad] (None when tied) and
    frontend [d, d], the stub frontend projection (None without one)."""

    def __init__(self, cfg: ArchConfig, embed, ln_f, lm_head, frontend=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.ln_f = nn.Parameter(ln_f)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)
        self.frontend = None if frontend is None else nn.Parameter(frontend)

    def head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


class Transformer(_LM):
    """The dense family: the embedding, head and the layers."""

    def __init__(self, cfg: ArchConfig, embed, ln_f, dense_layers,
                 lm_head=None, frontend=None):
        super().__init__(cfg, embed, ln_f, lm_head, frontend)
        self.layers = nn.ModuleList(dense_layers)


class HybridLM(_LM):
    """The hybrid family: `mamba` (n_layers // attn_every groups of
    attn_every `MambaLayer`s), `mamba_tail` (the n_layers % attn_every
    left, maybe none) and `shared`, one `DenseLayer` called after every
    group."""

    def __init__(self, cfg: ArchConfig, embed, ln_f, mamba_groups,
                 mamba_tail, shared, lm_head=None, frontend=None):
        super().__init__(cfg, embed, ln_f, lm_head, frontend)
        self.mamba = nn.ModuleList(nn.ModuleList(g) for g in mamba_groups)
        self.mamba_tail = nn.ModuleList(mamba_tail)
        self.shared = shared


class XLSTMLM(_LM):
    """The xLSTM family: `pairs`, n_layers // 2 `XLSTMPair`s."""

    def __init__(self, cfg: ArchConfig, embed, ln_f, pairs, lm_head=None,
                 frontend=None):
        super().__init__(cfg, embed, ln_f, lm_head, frontend)
        self.pairs = nn.ModuleList(pairs)


def check_family(cfg: ArchConfig) -> None:
    """This module runs the dense, MoE, vlm, hybrid and xLSTM families and
    the vision frontend; the enc-dec family and the audio frontend are
    `models.encdec`'s (`registry.model_fns` picks the module)."""
    if cfg.family == "encdec" or cfg.frontend not in (None, "vision"):
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} with frontend "
            f"{cfg.frontend!r} runs in models.encdec, not "
            f"models.transformer")
    if not (cfg.xlstm or cfg.family in ("dense", "moe", "vlm", "hybrid")):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _has_mlp(cfg: ArchConfig) -> bool:
    """A dense GLU beside (arctic) or instead of the experts."""
    return bool(cfg.d_ff) and (not cfg.is_moe or cfg.parallel_dense_ffn)


def _dense_layer_init(generator, cfg: ArchConfig, **kw) -> DenseLayer:
    attn = attention.init(generator, cfg, **kw)
    moe = ffn.moe_init(generator, cfg, **kw) if cfg.is_moe else None
    mlp = (ffn.glu_init(generator, cfg.d_model, cfg.d_ff, **kw)
           if _has_mlp(cfg) else None)
    return DenseLayer(attn, layers.norm_init(cfg.d_model, **kw),
                      layers.norm_init(cfg.d_model, **kw), mlp, moe)


def _mamba_layer_init(generator, cfg: ArchConfig, **kw) -> MambaLayer:
    return MambaLayer(ssm.mamba2_init(generator, cfg, **kw),
                      layers.norm_init(cfg.d_model, **kw))


def _xlstm_pair_init(generator, cfg: ArchConfig, **kw) -> XLSTMPair:
    return XLSTMPair(ssm.mlstm_init(generator, cfg, **kw),
                     ssm.slstm_init(generator, cfg, **kw),
                     layers.norm_init(cfg.d_model, **kw),
                     layers.norm_init(cfg.d_model, **kw))


def init_params(cfg: ArchConfig, generator=None, *, device=None,
                dtype=torch.float32):
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
    frontend = None
    if cfg.frontend:
        frontend = layers.dense_init(generator, cfg.d_model, cfg.d_model, **kw)
    if cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.n_layers, cfg.attn_every)
        groups = [[_mamba_layer_init(generator, cfg, **kw)
                   for _ in range(cfg.attn_every)] for _ in range(n_groups)]
        tail = [_mamba_layer_init(generator, cfg, **kw) for _ in range(rem)]
        shared = _dense_layer_init(generator, cfg, **kw)
        return HybridLM(cfg, embed, ln_f, groups, tail, shared, lm_head,
                        frontend)
    if cfg.xlstm:
        assert cfg.n_layers % 2 == 0, cfg.n_layers
        pairs = [_xlstm_pair_init(generator, cfg, **kw)
                 for _ in range(cfg.n_layers // 2)]
        return XLSTMLM(cfg, embed, ln_f, pairs, lm_head, frontend)
    stack = [_dense_layer_init(generator, cfg, **kw)
             for _ in range(cfg.n_layers)]
    return Transformer(cfg, embed, ln_f, stack, lm_head, frontend)


def _rope(cfg: ArchConfig, max_len: int, device):
    """Rotary tables, for the families that attend (all but xLSTM)."""
    if cfg.rope_fraction <= 0 or cfg.xlstm:
        return None
    return layers.rope_freqs(cfg.hd, max_len, cfg.rope_theta,
                             cfg.rope_fraction, device=device)


def _ffn(cfg: ArchConfig, lp: DenseLayer, h):
    """h plus the layer's FFN on rmsnorm(h): the experts, then the dense
    GLU (both on the same normed input).  Returns (h, the MoE's aux loss
    or None)."""
    hn = layers.rmsnorm(h, lp.ln2, cfg.norm_eps)
    aux = None
    if lp.moe is not None:
        mo, aux = ffn.moe(lp.moe, hn, cfg)
        h = h + mo
    if lp.mlp is not None:
        h = h + ffn.glu(lp.mlp, hn, cfg.act)
    return h, aux


def _dense_layer(cfg: ArchConfig, lp: DenseLayer, h, rope, use_kernel):
    """One attention + FFN block -> (h, the MoE's aux loss or None)."""
    h = h + attention.full_attention(
        lp.attn, layers.rmsnorm(h, lp.ln1, cfg.norm_eps), cfg, rope,
        use_kernel=use_kernel)
    return _ffn(cfg, lp, h)


def _mamba_layer(cfg: ArchConfig, lp: MambaLayer, h, use_kernel):
    return h + ssm.mamba2_block(
        lp.mixer, layers.rmsnorm(h, lp.ln, cfg.norm_eps), cfg,
        use_kernel=use_kernel)


def _hybrid_forward(cfg: ArchConfig, model: HybridLM, h, rope, use_kernel):
    """zamba2: groups of Mamba-2 layers, the shared block after each."""
    for group in model.mamba:
        for lp in group:
            h = _mamba_layer(cfg, lp, h, use_kernel)
        h, _ = _dense_layer(cfg, model.shared, h, rope, use_kernel)
    for lp in model.mamba_tail:
        h = _mamba_layer(cfg, lp, h, use_kernel)
    return h


def _xlstm_forward(cfg: ArchConfig, model: XLSTMLM, h, use_kernel):
    for lp in model.pairs:
        h = h + ssm.mlstm_block(
            lp.m, layers.rmsnorm(h, lp.ln_m, cfg.norm_eps), cfg,
            use_kernel=use_kernel)
        h = h + ssm.slstm_block(
            lp.s, layers.rmsnorm(h, lp.ln_s, cfg.norm_eps), cfg)
    return h


def forward(cfg: ArchConfig, model, batch, *, use_kernel: bool = False,
            grad: bool = False):
    """Prefill forward -> (logits [B, S, Vpad], aux_loss).

    `use_kernel=True` runs every attention through the flash kernel and
    every Mamba-2 or mLSTM scan through the ssd_scan kernel (one launch
    each on a CUDA tensor).  aux_loss is the MoE layers' load-balance
    losses summed in layer order from a float32 zero (zero for the other
    families).  With a frontend, batch["frontend"] [B, F, d] is projected
    and prepended: the layers see F + S positions, the logits the last S.
    """
    check_family(cfg)
    with torch.inference_mode(not grad):
        tokens = batch["tokens"]
        S = tokens.shape[1]
        h = model.embed[tokens]
        if cfg.frontend:
            fe = batch["frontend"] @ model.frontend
            h = torch.cat([fe.to(h.dtype), h], dim=1)
        rope = _rope(cfg, h.shape[1], h.device)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.family == "hybrid":
            h = _hybrid_forward(cfg, model, h, rope, use_kernel)
        elif cfg.xlstm:
            h = _xlstm_forward(cfg, model, h, use_kernel)
        else:
            for lp in model.layers:
                h, a_loss = _dense_layer(cfg, lp, h, rope, use_kernel)
                if a_loss is not None:
                    aux = aux + a_loss
        h = layers.rmsnorm(h, model.ln_f, cfg.norm_eps)
        if cfg.frontend:
            h = h[:, -S:]  # logits over the text positions only
        return h @ model.head(), aux


def loss_fn(cfg: ArchConfig, model, batch, *, use_kernel: bool = False,
            aux_weight: float = 0.01):
    """The training loss: mean next-token cross-entropy over the logits
    of `forward(grad=True)` plus aux_weight times the MoE aux loss, a
    scalar that autograd can differentiate.  The kernel ops have no
    backward, so `use_kernel=True` raises once autograd is on (as the
    reference's kernel path cannot be differentiated)."""
    logits, aux = forward(cfg, model, batch, use_kernel=use_kernel,
                          grad=True)
    targets, mask = layers.next_token_targets(batch["tokens"])
    return layers.cross_entropy(logits, targets, mask) + aux_weight * aux


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None):
    """Dense: one KV cache a layer, all at the shared write position `pos`.
    Hybrid: an fp32 `SSMState` a Mamba-2 layer (`mamba` in groups,
    `mamba_tail`, None without a tail) and one KV cache a group for the
    shared block (`shared_cache`), in `dtype`.  xLSTM: an fp32 mLSTM
    `SSMState` (`m`) and sLSTM `SLSTMState` (`s`) a pair; `dtype` is
    ignored, as in the reference."""
    check_family(cfg)
    device = layers.resolve_device(device)
    with torch.inference_mode():
        def caches(n):
            return [attention.init_cache(cfg, batch, max_len, dtype, device)
                    for _ in range(n)]

        if cfg.xlstm:
            n_pairs = cfg.n_layers // 2
            return {"m": [ssm.mlstm_init_state(cfg, batch, device)
                          for _ in range(n_pairs)],
                    "s": [ssm.slstm_init_state(cfg, batch, device)
                          for _ in range(n_pairs)], "pos": 0}
        if cfg.family != "hybrid":
            return {"caches": caches(cfg.n_layers), "pos": 0}
        n_groups, rem = divmod(cfg.n_layers, cfg.attn_every)

        def states(n):
            return [ssm.mamba2_init_state(cfg, batch, device)
                    for _ in range(n)]

        return {"mamba": [states(cfg.attn_every) for _ in range(n_groups)],
                "mamba_tail": states(rem) if rem else None,
                "shared_cache": caches(n_groups), "pos": 0}


def _dense_decode_layer(cfg: ArchConfig, lp: DenseLayer, h, rope, cache,
                        pos):
    a, cache = attention.decode_attention(
        lp.attn, layers.rmsnorm(h, lp.ln1, cfg.norm_eps), cfg, rope,
        attention.KVCache(cache.k, cache.v, pos))
    h, _ = _ffn(cfg, lp, h + a)
    return h, cache


def _mamba_decode_layers(cfg: ArchConfig, lps, h, states):
    new = []
    for lp, st in zip(lps, states):
        out, st = ssm.mamba2_step(
            lp.mixer, layers.rmsnorm(h, lp.ln, cfg.norm_eps), cfg, st)
        h = h + out
        new.append(st)
    return h, new


def _hybrid_decode(cfg: ArchConfig, model: HybridLM, state, h, rope):
    pos = state["pos"]
    new_mamba, new_caches = [], []
    for group, gst, cache in zip(model.mamba, state["mamba"],
                                 state["shared_cache"]):
        h, gst = _mamba_decode_layers(cfg, group, h, gst)
        h, cache = _dense_decode_layer(cfg, model.shared, h, rope, cache, pos)
        new_mamba.append(gst)
        new_caches.append(cache)
    tail = state["mamba_tail"]
    if tail is not None:
        h, tail = _mamba_decode_layers(cfg, model.mamba_tail, h, tail)
    return h, {"mamba": new_mamba, "mamba_tail": tail,
               "shared_cache": new_caches, "pos": pos + 1}


def _xlstm_decode(cfg: ArchConfig, model: XLSTMLM, state, h):
    new_m, new_s = [], []
    for lp, m_st, s_st in zip(model.pairs, state["m"], state["s"]):
        out, m_st = ssm.mlstm_step(
            lp.m, layers.rmsnorm(h, lp.ln_m, cfg.norm_eps), cfg, m_st)
        h = h + out
        out, s_st = ssm.slstm_step(
            lp.s, layers.rmsnorm(h, lp.ln_s, cfg.norm_eps), cfg, s_st)
        h = h + out
        new_m.append(m_st)
        new_s.append(s_st)
    return h, {"m": new_m, "s": new_s, "pos": state["pos"] + 1}


def decode_step(cfg: ArchConfig, model, state, tokens):
    """One-token decode.  tokens: [B, 1] -> (logits [B, 1, Vpad], state).

    The KV caches of `state` are updated in place; the SSM, mLSTM and
    sLSTM states are replaced.  The returned state holds pos + 1.
    """
    check_family(cfg)
    with torch.inference_mode():
        h = model.embed[tokens]
        rope = _rope(cfg, cfg.max_seq, h.device)
        if cfg.family == "hybrid":
            h, new_state = _hybrid_decode(cfg, model, state, h, rope)
        elif cfg.xlstm:
            h, new_state = _xlstm_decode(cfg, model, state, h)
        else:
            pos = state["pos"]
            caches = []
            for lp, cache in zip(model.layers, state["caches"]):
                h, cache = _dense_decode_layer(cfg, lp, h, rope, cache, pos)
                caches.append(cache)
            new_state = {"caches": caches, "pos": pos + 1}
        h = layers.rmsnorm(h, model.ln_f, cfg.norm_eps)
        return h @ model.head(), new_state
