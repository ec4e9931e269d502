"""chatglm3-6b [arXiv:2406.12793]: dense, GQA kv=2, partial (2d) RoPE."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_fraction=0.5,      # GLM applies rotary to half the head dims
    max_seq=1 << 16,
)

SMOKE = ArchConfig(
    name="chatglm3-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=256,
    rope_fraction=0.5, max_seq=256,
)
