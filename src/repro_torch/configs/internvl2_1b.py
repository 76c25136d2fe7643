"""InternVL2-1B — ViT frontend STUB + InternLM2-like 1B LM backbone
[arXiv:2404.16821; hf].  input_specs feeds precomputed patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    head_dim=64, d_ff=4864, vocab=151_655, rope_theta=1_000_000.0,
)
