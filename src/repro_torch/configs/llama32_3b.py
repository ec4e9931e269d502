"""llama3.2-3b [hf:meta-llama/Llama-3.2-*]: small llama3, GQA kv=8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    max_seq=1 << 16,
)

SMOKE = ArchConfig(
    name="llama32-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    tie_embeddings=True, max_seq=256,
)
