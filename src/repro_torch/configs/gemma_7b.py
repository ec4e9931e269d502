"""gemma-7b [arXiv:2403.08295]: GeGLU, head_dim=256 (16 heads x 256 > d_model)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="gelu",             # GeGLU
    tie_embeddings=True,
    max_seq=1 << 16,
)

SMOKE = ArchConfig(
    name="gemma-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=192,
    vocab=512, act="gelu", tie_embeddings=True, max_seq=256,
)
