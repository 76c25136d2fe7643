"""Whisper-base — enc-dec audio backbone; conv frontend STUB
[arXiv:2212.04356].  6 encoder + 6 decoder layers, d=512, LN + GELU,
sinusoidal positions (rope disabled), tied embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51_865,
    rope_theta=0.0, act="gelu", qkv_bias=True, tie_embeddings=True,
)
