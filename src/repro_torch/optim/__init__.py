"""repro_torch.optim — AdamW with f32, bf16 or block-quantized int8 moments
(``optim.adamw``, ``optim.quant``).  Gradient compression
(``optim/compress.py``) comes with the mesh tier, ROADMAP.md queue A item 6.
"""

from .adamw import (  # noqa: F401
    AdamWConfig, AdamWState, global_norm, init, update, warmup_cosine,
)
from .quant import BLOCK, Quantized, dequantize, quantize  # noqa: F401
