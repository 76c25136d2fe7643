"""Llama-4-Maverick-400B-A17B — MoE, 128 experts top-1 + shared expert,
MoE every other layer (matching ~400B total / ~17B active)
[hf:meta-llama/Llama-4-*]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=16_384, vocab=202_048, rope_theta=500_000.0,
    moe=MoEConfig(
        n_experts=128, top_k=1, expert_ff=8192,
        moe_every=2, shared_expert_ff=8192, dense_ff=16_384,
    ),
)
