"""Wrapper for the fused weighted contraction kernel (B7).

As in the reference's ``kernels/fused_rnz/ops.py`` this entry is always the
hand-written kernel (the generated route for the same contraction is
``ops.weighted_dense``): on a CUDA tensor, or with ``interpret=True``, it
calls ``weighted_matmul_cuda`` with the caller's blocks, filled in by
``choose_matmul_blocks``; otherwise it is ``weighted_matmul_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.autotune import choose_matmul_blocks
from .fused_rnz import weighted_matmul_cuda
from .ref import weighted_matmul_ref


def weighted_matmul(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, *,
                    block_m: Optional[int] = None,
                    block_n: Optional[int] = None,
                    block_k: Optional[int] = None,
                    interpret: bool = False) -> torch.Tensor:
    if not (interpret or a.is_cuda):
        return weighted_matmul_ref(a, b, g)
    m, k = a.shape
    _, n = b.shape
    if block_m is None or block_n is None or block_k is None:
        bm, bn, bk = choose_matmul_blocks(m, n, k,
                                          elem_bytes=a.element_size())
        block_m, block_n, block_k = (block_m or bm, block_n or bn,
                                     block_k or bk)
    return weighted_matmul_cuda(a, b, g, block_m=block_m, block_n=block_n,
                                block_k=block_k)
