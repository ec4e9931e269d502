"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4 shared + 60 routed top-4.

The paper's UC1 aggregated exchange IS this model's expert dispatch
(DESIGN.md §4).  60 experts pad to 64 for 16-way EP divisibility.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,                 # FFN fully MoE (shared experts cover dense path)
    vocab=151936,
    n_experts=60,
    expert_pad=4,           # -> 64 for EP over the 16-way model axis
    top_k=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    max_seq=1 << 16,
)

SMOKE = ArchConfig(
    name="qwen2-moe-smoke",
    family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=256,
    n_experts=6, expert_pad=2, top_k=2, n_shared_experts=1, moe_d_ff=96,
    max_seq=256,
)
