"""Architecture config schema + the four assigned input shapes.

The port's own copy of `repro.configs.base` (no JAX there, but the port
imports nothing of the reference), field for field and number for number.
Every ported architecture lives in its own module exporting CONFIG (the
exact published numbers) and SMOKE (a reduced same-family config for CPU
smoke tests).  `models.registry.get(arch_id)` resolves them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str            # dense | moe | encdec | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    act: str = "silu"                    # glu gate activation
    rope_fraction: float = 1.0           # <1: partial rotary (GLM 2d-RoPE)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq: int = 1 << 19
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    parallel_dense_ffn: bool = False     # arctic: dense residual FFN + MoE
    expert_pad: int = 0                  # pad experts for EP divisibility
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_max_seq: int = 1500
    # --- frontend stubs ---
    frontend: Optional[str] = None       # "audio" | "vision"
    n_frontend_tokens: int = 0           # patches/frames prepended
    # --- hybrid / ssm ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0                  # zamba2: shared attn block period
    xlstm: bool = False                  # xlstm: mLSTM/sLSTM alternation
    # --- attention backend ---
    window: int = 0                      # sliding window (0 = full)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> float:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        if self.xlstm:
            blk = 8 * d * d  # qkv+gates+proj approximation per xlstm block
            return self.vocab * d * (1 if self.tie_embeddings else 2) + (
                self.n_layers * blk
            )
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
        moe_ffn = self.n_experts * 3 * d * self.moe_d_ff + (
            self.n_shared_experts * 3 * d * self.moe_d_ff
        )
        if self.family == "hybrid":
            d_in = 2 * d
            mamba = d * 2 * d_in + d_in * d + d_in * (2 * self.ssm_state + 32)
            n_attn = self.n_layers // max(self.attn_every, 1)
            return self.vocab * d * 2 + self.n_layers * (mamba + 0) + (
                attn + dense_ffn
            )  # shared attn block counted once
        per_layer = attn + dense_ffn + moe_ffn
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        enc = self.n_enc_layers * (attn + dense_ffn)
        return emb + self.n_layers * per_layer + enc

    def active_param_count(self) -> float:
        """Active (per-token) params — MoE counts top_k + shared experts."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        moe_active = self.n_layers * self.top_k * 3 * d * self.moe_d_ff
        return full - moe_all + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs
LONG_CONTEXT_ARCHS = ("zamba2-7b", "xlstm-125m")


def shape_applicable(arch_id: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True
