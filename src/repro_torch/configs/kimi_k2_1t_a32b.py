"""Kimi-K2-1T-A32B — trillion-parameter MoE: 384 experts top-8 + shared
expert, first layer dense (DeepSeek-V3-style) [arXiv:2501.kimi2]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    head_dim=112, d_ff=18_432, vocab=163_840, rope_theta=50_000.0,
    moe=MoEConfig(
        n_experts=384, top_k=8, expert_ff=2048,
        moe_every=1, first_dense=1, dense_ff=18_432,
        shared_expert_ff=2048,
    ),
)
