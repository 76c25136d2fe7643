"""Blocked matmul, kernel B5: the paper's section 4 winner, by hand.

Replaces the reference's ``kernels/matmul/matmul.py::matmul_pallas``, a
3-D-grid Pallas kernel (M/bm, N/bn, K/bk) that streams K blocks through
VMEM into a resident f32 accumulator.  Here the kernel is kind 0 of
``codegen/csrc/baselines.cu``: a CTA owns an output tile and loops over K
into an f32 accumulator held in registers.  bf16 operands that TMA can
read run the ring body (a persistent grid of 128 x 256 tiles, TMA loads
into a four-stage mbarrier ring feeding ``wgmma``); other bf16 operands a
three-stage ``cp.async`` ring on ``mma.sync`` (64 x 128 tiles); f32 the
FMA pipes (128 x 64).  ``_baselines.baseline_body`` picks the body.  The
CUDA tile is the kernel's own, not the caller's blocks: those are checked
to divide the extents, as the reference asserts, and otherwise do not
change the result.

On a CUDA tensor ``matmul_cuda`` launches the kernel (``MATMUL.launches``
counts it); on CPU tensors it runs ``matmul_ref``.
"""

from __future__ import annotations

import torch

from .._baselines import MATMUL
from .ref import matmul_ref

__all__ = ["MATMUL", "matmul_cuda"]


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, block_m: int,
                block_n: int, block_k: int, out_dtype=None) -> torch.Tensor:
    """C = A @ B.  A: (M, K), B: (K, N); block sizes must divide the
    operand extents."""
    m, ka = a.shape
    kb, n = b.shape
    if ka != kb:
        raise AssertionError((tuple(a.shape), tuple(b.shape)))
    if m % block_m or n % block_n or ka % block_k:
        raise AssertionError(((m, n, ka), (block_m, block_n, block_k)))
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    return MATMUL(a, b, out_dtype)
