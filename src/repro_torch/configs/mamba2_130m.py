"""Mamba2-130M — attention-free SSD (state-space duality)
[arXiv:2405.21060]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=0,
    d_ff=0, vocab=50_280, rope_theta=0.0,
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, d_conv=4, chunk=256),
)
