"""repro_torch.optim — AdamW with f32, bf16 or block-quantized int8 moments
(``optim.adamw``, ``optim.quant``), and the int8 gradient compression of
the cross-pod all-reduce (``optim.compress``, on the mesh tier's
collectives).
"""

from .adamw import (  # noqa: F401
    AdamWConfig, AdamWState, global_norm, init, update, warmup_cosine,
)
from .quant import BLOCK, Quantized, dequantize, quantize  # noqa: F401
