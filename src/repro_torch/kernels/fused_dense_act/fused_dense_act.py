"""Fused dense + normalization + nonlinearity, kernel B6 (paper eqs 3-5):

    y_k^b = sum_i W_ik x_i^b + beta_k          (dense)
    z_k   = (y_k^b - E_k) / sqrt(V_k + eps)    (normalization, given stats)
    r_k   = h(z_k)                             (elementwise nonlinearity)

Replaces the reference's
``kernels/fused_dense_act/fused_dense_act.py::fused_dense_act_pallas``.
The last two stages are low arithmetic density, so they run on the f32
accumulator before the one store instead of round-tripping device memory.
Here the kernel is kind 1 of ``codegen/csrc/baselines.cu`` (its epilogue
hook): bf16 operands TMA can read run its persistent TMA / ``wgmma`` ring
(128 x 256 tiles, the epilogue on the f32 fragments from each tile's
staged column factors), other bf16 calls ``mma.sync`` (64 x 128), f32 the
FMA body (128 x 64); the caller's blocks are checked to divide the
extents, as the reference asserts.  Activations: relu, gelu (the tanh
approximation), tanh, id, as the reference's kernel.

On a CUDA tensor ``fused_dense_act_cuda`` launches the kernel
(``FUSED_DENSE_ACT.launches`` counts it); on CPU tensors it runs
``fused_dense_act_ref``.
"""

from __future__ import annotations

import torch

from .._baselines import FUSED_DENSE_ACT
from .ref import ACTIVATIONS, fused_dense_act_ref

__all__ = ["FUSED_DENSE_ACT", "fused_dense_act_cuda"]


def fused_dense_act_cuda(x: torch.Tensor, w: torch.Tensor,
                         beta: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, *, act: str = "gelu",
                         eps: float = 1e-5, block_b: int, block_k: int,
                         block_i: int, out_dtype=None) -> torch.Tensor:
    """x (B, I) @ w (I, K), then bias, normalization and ``act`` on the
    (K,) vectors."""
    b, i = x.shape
    i2, k = w.shape
    if i != i2 or not (tuple(beta.shape) == tuple(mean.shape)
                       == tuple(var.shape) == (k,)):
        raise AssertionError((tuple(x.shape), tuple(w.shape)))
    if b % block_b or k % block_k or i % block_i:
        raise AssertionError(((b, k, i), (block_b, block_k, block_i)))
    if act not in ACTIVATIONS:
        raise KeyError(act)
    out_dtype = out_dtype or x.dtype
    tensors = (x, w, beta, mean, var)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_dense_act_ref(x, w, beta, mean, var, act=act, eps=eps,
                                   out_dtype=out_dtype)
    return FUSED_DENSE_ACT(x, w, out_dtype, beta=beta, mean=mean, var=var,
                           act=act, eps=eps)
