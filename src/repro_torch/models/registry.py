"""Architecture registry: arch id -> config, model functions, input specs.

Mirrors `repro.models.registry` for all ten of the reference's
architectures; an unknown id raises KeyError, as in the reference.
`input_specs(cfg, shape)` returns tensors on the `meta` device, the
stand-ins of the reference's `ShapeDtypeStruct`s: every model input of
one (arch x shape) cell, with its shape and dtype and no storage
(frontends are stubs: precomputed frame or patch embeddings).
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeConfig,
                                      shape_applicable)
from . import encdec, transformer

ARCHS = {
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "llama3.2-3b": "repro_torch.configs.llama32_3b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}


def get(arch_id: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(ARCHS[arch_id])
    return mod.SMOKE if smoke else mod.CONFIG


def model_fns(cfg: ArchConfig):
    """(init_params, forward, loss_fn, init_decode_state, decode_step):
    the enc-dec family's from `encdec`, the rest from `transformer`."""
    if cfg.family == "encdec":
        mod = encdec
    else:
        transformer.check_family(cfg)
        mod = transformer
    return {
        "init_params": mod.init_params,
        "forward": mod.forward,
        "loss_fn": mod.loss_fn,
        "init_decode_state": mod.init_decode_state,
        "decode_step": mod.decode_step,
    }


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta tensors of one (arch, shape) cell's inputs: int32 tokens, bf16
    frontends.  Decode takes one token a sequence; the enc-dec family fills
    the encoder with min(S, enc_max_seq) frames and decodes
    max(128, min(S, 4096)) tokens against them; a vision frontend takes
    n_frontend_tokens of the S positions."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), torch.int32)}
    if cfg.family == "encdec":
        sa = min(S, 8 * cfg.enc_max_seq)
        st = max(128, min(S, 4096))
        return {"frontend": _spec((B, min(sa, cfg.enc_max_seq), cfg.d_model),
                                  torch.bfloat16),
                "tokens": _spec((B, st), torch.int32)}
    if cfg.frontend == "vision":
        nf = cfg.n_frontend_tokens
        return {"frontend": _spec((B, nf, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, S - nf), torch.int32)}
    return {"tokens": _spec((B, S), torch.int32)}


def smoke_batch(cfg: ArchConfig, batch: int = 2, seq: int = 32,
                seed: int = 0):
    """Concrete small inputs for CPU smoke tests: int32 tokens in
    [0, vocab) and, for a frontend, fp32 N(0, 1) embeddings, drawn from a
    CPU `torch.Generator` seeded with `seed` (the reference's shapes and
    dtypes; its `jax.random` draws cannot be reproduced)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                   dtype=torch.int32)}
    rows = (cfg.enc_max_seq if cfg.family == "encdec"
            else cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    if rows:
        out["frontend"] = torch.randn((batch, rows, cfg.d_model),
                                      generator=gen, dtype=torch.float32)
    return out


def cells(arch_id: str):
    """All applicable (shape_name, ShapeConfig) cells for an arch."""
    return [(name, sc) for name, sc in SHAPES.items()
            if shape_applicable(arch_id, name)]
