"""Block-wise 8-bit quantization of optimizer moments (8-bit-Adam style).

The port of the reference's ``optim/quant.py``, moments part: tensors are
flattened and quantized in blocks of ``BLOCK`` with a per-block absmax
scale, bit for bit the reference's ``quantize``/``dequantize`` (the same
f32 division, round-half-to-even and clip).  ``optim.adamw`` keeps its
moments this way with ``moments_dtype='int8'``.  The GEMM-operand helpers
(``quantize_tensor``, ``quantize_channels``) and the weight-only tree
functions come with B1's int8/fp8 modes (ROADMAP.md queue A item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

BLOCK = 256


@dataclasses.dataclass
class Quantized:
    """int8 payload + per-block f32 scales + original shape/dtype."""

    q: torch.Tensor       # (nblocks, BLOCK) int8
    scale: torch.Tensor   # (nblocks, 1) f32
    shape: Tuple[int, ...]
    dtype: torch.dtype


def quantize_blocks(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale) of a 1-D tensor, zero-padded to whole blocks."""
    flat = flat.to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      n: int) -> torch.Tensor:
    """The first ``n`` values of the f32 blocks ``q * scale``, flat."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def quantize(x: torch.Tensor) -> Quantized:
    q, scale = quantize_blocks(x.reshape(-1))
    return Quantized(q, scale, tuple(x.shape), x.dtype)


def dequantize(qv: Quantized) -> torch.Tensor:
    n = 1
    for d in qv.shape:
        n *= d
    return dequantize_blocks(qv.q, qv.scale, n).reshape(qv.shape).to(
        qv.dtype
    )
