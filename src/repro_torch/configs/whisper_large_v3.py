"""whisper-large-v3 [arXiv:2212.04356]: enc-dec audio transformer.

Backbone only — the conv frontend is a stub; input_specs provide
precomputed frame embeddings (per assignment spec).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,           # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    act="gelu",
    rope_fraction=0.0,     # whisper uses learned/sinusoidal positions
    frontend="audio",
    max_seq=1 << 16,
    enc_max_seq=1500,
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128, act="gelu", rope_fraction=0.0,
    frontend="audio", max_seq=128, enc_max_seq=32,
)
