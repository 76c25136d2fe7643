"""Plain PyTorch version of the fused weighted contraction (paper eq 2),
kernel B7's oracle."""

from __future__ import annotations

import torch


def weighted_matmul_ref(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                        out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    # same contract as the kernel: the zipper (a*g) runs in the input dtype,
    # accumulation happens in float32
    scaled = a * g[None, :]
    return torch.matmul(scaled.float(), b.float()).to(out_dtype)
