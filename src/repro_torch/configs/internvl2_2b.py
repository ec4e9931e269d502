"""internvl2-2b [arXiv:2404.16821]: InternViT frontend (stub) + InternLM2 LM."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    frontend="vision",
    n_frontend_tokens=256,   # ViT patch embeddings prepended (stub)
    max_seq=1 << 16,
)

SMOKE = ArchConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    frontend="vision", n_frontend_tokens=8, max_seq=256,
)
