"""starcoder2-3b [arXiv:2402.19173]: dense code model, GQA kv=2, RoPE."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    act="gelu",
    max_seq=1 << 16,
)

SMOKE = ArchConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    act="gelu", max_seq=256,
)
