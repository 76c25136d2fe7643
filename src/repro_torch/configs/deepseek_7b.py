"""DeepSeek-7B — dense llama-arch [arXiv:2401.02954; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102_400, rope_theta=10_000.0,
)
