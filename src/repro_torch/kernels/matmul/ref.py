"""Plain PyTorch version of the blocked matmul kernel (B5)."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=None) -> torch.Tensor:
    """a @ b accumulated in float32, then cast to ``out_dtype`` (a's)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)
