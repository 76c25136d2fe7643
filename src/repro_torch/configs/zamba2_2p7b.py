"""Zamba2-2.7B — Mamba2 backbone + weight-shared attention block every 6
SSM layers [arXiv:2411.15242; hf]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    head_dim=80, d_ff=10_240, vocab=32_000, attn_every=6,
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, expand=2, headdim=64, d_conv=4, chunk=256),
)
