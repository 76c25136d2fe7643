"""Granite-34B-Code — dense, MQA (kv=1) [arXiv:2405.04324; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24_576, vocab=49_152, rope_theta=10_000.0,
)
