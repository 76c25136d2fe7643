"""Public wrapper for the blocked matmul: generated kernel first.

Routing as the reference's ``kernels/matmul/ops.py``: the schedule-driven
generator (``repro_torch.codegen``, kernel B1) compiles the matmul's
Schedule; its blocks come from the tuner when the caller pins none, else
from the caller (filled in by ``choose_matmul_blocks``).  The hand-written
kernel B5 (``matmul_cuda``) is the verification baseline, reached with
``use_generated=False``.  The reference's "on a TPU" is "on a CUDA
tensor" here; ``interpret`` and ``force_kernel`` (the reference's
``force_pallas``) make a CPU call take the same routes, whose kernels then
run their plain versions.  Otherwise the call is ``matmul_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.autotune import choose_matmul_blocks
from ...core.enumerate import matmul_spec
from .matmul import matmul_cuda
from .ref import matmul_ref


def _generated_matmul(a, b, block_m, block_n, block_k, interpret):
    from ... import codegen

    m, k = a.shape
    _, n = b.shape
    spec = matmul_spec(m, k, n)  # extents: i=m, j=k, k=n
    if block_m is None:
        schedule = codegen.tune_schedule(spec, dtype=a.dtype)
    else:
        schedule = codegen.default_schedule(
            spec, {"i": block_m, "k": block_n, "j": block_k}
        )
    kern = codegen.cached_compile(spec, schedule, interpret=interpret)
    return kern(a, b)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           block_m: Optional[int] = None, block_n: Optional[int] = None,
           block_k: Optional[int] = None, interpret: bool = False,
           force_kernel: bool = False,
           use_generated: bool = True) -> torch.Tensor:
    m, k = a.shape
    _, n = b.shape
    if not (force_kernel or interpret or a.is_cuda):
        return matmul_ref(a, b)
    if use_generated and block_m is None and block_n is None and (
        block_k is None
    ):
        return _generated_matmul(a, b, None, None, None, interpret)
    if block_m is None or block_n is None or block_k is None:
        bm, bn, bk = choose_matmul_blocks(m, n, k,
                                          elem_bytes=a.element_size())
        block_m, block_n, block_k = (block_m or bm, block_n or bn,
                                     block_k or bk)
    if use_generated:
        return _generated_matmul(a, b, block_m, block_n, block_k, interpret)
    return matmul_cuda(a, b, block_m=block_m, block_n=block_n,
                       block_k=block_k)
