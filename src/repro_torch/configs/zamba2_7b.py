"""zamba2-7b [arXiv:2411.15242]: Mamba-2 backbone + shared attention blocks.

81 Mamba-2 layers with one SHARED (weight-tied) attention+MLP block invoked
after every `attn_every` layers (13 groups of 6, then a tail of 3).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,             # shared block MLP
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    max_seq=1 << 20,
)

SMOKE = ArchConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    ssm_state=16, ssm_head_dim=16, attn_every=3, max_seq=512,
)
