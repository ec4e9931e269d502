"""Architecture registry: arch id -> config and model functions.

Mirrors `repro.models.registry` for the architectures the port has.  An
id of the reference that the port lacks raises and names its ROADMAP
item; an unknown id raises KeyError, as in the reference.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig
from . import transformer

ARCHS = {
    "llama3.2-3b": "repro_torch.configs.llama32_3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

# the reference's other architectures, still to port
UNPORTED = {
    **dict.fromkeys(
        ("whisper-large-v3", "chatglm3-6b", "gemma-7b", "starcoder2-3b",
         "internvl2-2b"),
        "ROADMAP.md Queue 1 item 8 (the rest of the LM substrate)"),
}


def get(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: {UNPORTED[arch_id]}")
    mod = importlib.import_module(ARCHS[arch_id])
    return mod.SMOKE if smoke else mod.CONFIG


def model_fns(cfg: ArchConfig):
    """(init_params, forward, init_decode_state, decode_step); `loss_fn`
    waits for the training slice (ROADMAP.md Queue 1 item 8)."""
    transformer.check_family(cfg)
    return {
        "init_params": transformer.init_params,
        "forward": transformer.forward,
        "init_decode_state": transformer.init_decode_state,
        "decode_step": transformer.decode_step,
    }
