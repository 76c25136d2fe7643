"""Wrapper for fused dense + norm + activation: generated epilogue first.

Routing as the reference's ``kernels/fused_dense_act/ops.py``: the
generator's matmul with an ``Epilogue(act, bias, norm, eps)`` (kernel B1)
subsumes this kernel; the hand-written kernel B6
(``fused_dense_act_cuda``) stays as the verification baseline, reached
with ``use_generated=False``.  Off a CUDA tensor and without ``interpret``
the call is ``fused_dense_act_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.autotune import choose_matmul_blocks
from .fused_dense_act import fused_dense_act_cuda
from .ref import fused_dense_act_ref


def _generated(x, w, beta, mean, var, act, eps, block_b, block_k, block_i,
               interpret):
    from ... import codegen
    from ...core.enumerate import matmul_spec

    b, i = x.shape
    _, k = w.shape
    spec = matmul_spec(b, i, k)
    if block_b is None:
        schedule = codegen.tune_schedule(spec, dtype=x.dtype)
    else:
        schedule = codegen.default_schedule(
            spec, {"i": block_b, "k": block_k, "j": block_i}
        )
    epi = codegen.Epilogue(act=act, bias=True, norm=True, eps=eps)
    kern = codegen.cached_compile(spec, schedule, epilogue=epi,
                                  interpret=interpret)
    return kern(x, w, bias=beta, mean=mean, var=var)


def fused_dense_act(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor, *,
                    act: str = "gelu", eps: float = 1e-5,
                    block_b: Optional[int] = None,
                    block_k: Optional[int] = None,
                    block_i: Optional[int] = None, interpret: bool = False,
                    use_generated: bool = True) -> torch.Tensor:
    if not (interpret or x.is_cuda):
        return fused_dense_act_ref(x, w, beta, mean, var, act=act, eps=eps)
    b, i = x.shape
    _, k = w.shape
    if use_generated and block_b is None and block_k is None and (
        block_i is None
    ):
        return _generated(x, w, beta, mean, var, act, eps, None, None, None,
                          interpret)
    if block_b is None or block_k is None or block_i is None:
        bb, bk, bi = choose_matmul_blocks(b, k, i,
                                          elem_bytes=x.element_size())
        block_b, block_k, block_i = (block_b or bb, block_k or bk,
                                     block_i or bi)
    if use_generated:
        return _generated(x, w, beta, mean, var, act, eps, block_b, block_k,
                          block_i, interpret)
    return fused_dense_act_cuda(x, w, beta, mean, var, act=act, eps=eps,
                                block_b=block_b, block_k=block_k,
                                block_i=block_i)
