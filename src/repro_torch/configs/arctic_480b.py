"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: dense-MoE hybrid.

128 experts top-2 with a parallel dense residual FFN per layer.  At 480 B
parameters it does not fit one card: the port runs it at SMOKE size only.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    parallel_dense_ffn=True,
    max_seq=1 << 16,
)

SMOKE = ArchConfig(
    name="arctic-smoke",
    family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=96, vocab=256,
    n_experts=8, top_k=2, moe_d_ff=96, parallel_dense_ffn=True, max_seq=256,
)
