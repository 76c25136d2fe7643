"""Fused weighted contraction, kernel B7 (paper eq 2 / eq 6):

    C_ik = sum_j A_ij * B_jk * g_j

Replaces the reference's ``kernels/fused_rnz/fused_rnz.py::
weighted_matmul_pallas``.  The paper's point: BLAS-style libraries form
``A' = A .* g`` (a temporary the size of A) before the GEMM; the rnz-nzip
fusion rule (eq 27) folds the scaling into the reduction zipper.  Here the
kernel is kind 2 of ``codegen/csrc/baselines.cu`` (its prologue hook): the
g chunk of each K step rides the ``cp.async`` ring beside the A and B
tiles and scales the A fragments in registers, with ``a * g`` rounded to
the input dtype as the TPU kernel multiplies its VMEM block (the
generated kernel B1 instead scales in f32 and rounds once for the
product: each is held to its own reference).  The CUDA kernel tiles by
its own CTA tile (64 x 128 for bf16, 128 x 64 for f32); the caller's
blocks are checked to divide the extents, as the reference asserts.

On a CUDA tensor ``weighted_matmul_cuda`` launches the kernel
(``FUSED_RNZ.launches`` counts it); on CPU tensors it runs
``weighted_matmul_ref``.
"""

from __future__ import annotations

import torch

from .._baselines import FUSED_RNZ
from .ref import weighted_matmul_ref

__all__ = ["FUSED_RNZ", "weighted_matmul_cuda"]


def weighted_matmul_cuda(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                         *, block_m: int, block_n: int, block_k: int,
                         out_dtype=None) -> torch.Tensor:
    m, ka = a.shape
    kb, n = b.shape
    if ka != kb or tuple(g.shape) != (ka,):
        raise AssertionError((tuple(a.shape), tuple(b.shape),
                              tuple(g.shape)))
    if m % block_m or n % block_n or ka % block_k:
        raise AssertionError(((m, n, ka), (block_m, block_n, block_k)))
    out_dtype = out_dtype or a.dtype
    if all(t.device.type == "cpu" for t in (a, b, g)):
        return weighted_matmul_ref(a, b, g, out_dtype)
    return FUSED_RNZ(a, b, out_dtype, g=g)
