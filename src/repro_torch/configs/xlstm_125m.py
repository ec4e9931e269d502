"""xlstm-125m [arXiv:2405.04517]: alternating mLSTM/sLSTM blocks, d_ff=0.

Sub-quadratic (recurrent): runs the long_500k cell.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                 # xLSTM blocks carry their own projections
    vocab=50304,
    xlstm=True,
    max_seq=1 << 20,
)

SMOKE = ArchConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0, vocab=256,
    xlstm=True, max_seq=512,
)
