"""Framework-level dense ops, routed through the kernel generator.

``dense`` is the single entry point every model projection goes through.
As in the reference, a 2-D GEMM whose M, K and N are all multiples of 128
is *eligible*: it compiles through ``repro_torch.codegen`` with the
schedule from the plan DB (serving-phase ladder first, then the unphased
one) or else the tuner (``codegen.tune_schedule``), and runs
``csrc/contract.cu`` on CUDA tensors.  The device decides, never a probe
for a card: the reference's "on a TPU" becomes "on a CUDA tensor", and
``interpret=True`` keeps its reference meaning of making a call eligible
off the device rule, so CPU tests reach the kernel's plain version.
Everything else is ``torch.matmul`` with f32 accumulation, as the
reference leaves it to ``jnp.dot(..., preferred_element_type=f32)``.

``grouped_dense`` is the ragged grouped GEMM of the MoE experts.  It has
no alignment rule: on a CUDA tensor (or with ``interpret=True``) every call
with rows compiles the ``GroupedSpec`` through the same lookup and runs
``csrc/grouped.cu`` (kernel B3); otherwise it is the plain per-group loop.

Serving runs under ``torch.inference_mode()``; ``differentiable=`` is
accepted for the reference's signature and the ``autograd.Function``
comes with the training slice.  ``quant=`` comes with B1's int8/fp8 modes.
"""

from __future__ import annotations

import torch

from ..codegen import cached_compile, grouped_ref, tune_schedule
from ..core.enumerate import grouped_matmul_spec, matmul_spec
from ..search import active_phase, default_plan_db


def _tuned_kernel(spec, dtype, *, out_dtype=None, interpret=False):
    """Generated kernel for ``spec``: searched plan first, tuned fallback.

    Lookup order as in the reference (no mesh tier yet): the active
    serving phase's ladder, then the unphased ladder, then the analytic
    tuner with its persistent cache.
    """
    db = default_plan_db()
    schedule = None
    phase = active_phase()
    if phase is not None:
        schedule = db.best_schedule(spec, dtype, phase=phase)
    if schedule is None:
        schedule = db.best_schedule(spec, dtype)
    if schedule is None:
        schedule = tune_schedule(spec, dtype=dtype)
    return cached_compile(spec, schedule, out_dtype=out_dtype,
                          interpret=interpret)


def warm_dense_cache(shapes, dtype=torch.bfloat16) -> int:
    """Pre-tune schedules for (m, k, n) GEMMs; returns #schedules readied."""
    count = 0
    for m, k, n in shapes:
        tune_schedule(matmul_spec(m, k, n), dtype=dtype)
        count += 1
    return count


def _dense_kernel_ok(x: torch.Tensor, w: torch.Tensor,
                     interpret: bool) -> bool:
    return (x.is_cuda or interpret) and x.dim() == 2 and all(
        s % 128 == 0 for s in (*x.shape, w.shape[1])
    )


def _matmul_f32(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` accumulated in f32, then cast to ``out_dtype``.

    A same-type bf16 or f32 product already accumulates in f32 (the
    serving engine turns TF32 and reduced-precision bf16 reductions off);
    anything else is upcast first.
    """
    if x.dtype == w.dtype == out_dtype and x.dtype in (
        torch.float32, torch.bfloat16
    ):
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def dense(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
          interpret: bool = False, differentiable: bool = True,
          quant=None) -> torch.Tensor:
    """x: (..., D) @ w: (D, F) -> (..., F), f32 accumulation."""
    if quant is not None:
        raise NotImplementedError(
            "quantized dense (quant=) comes with B1's int8/fp8 modes, "
            "ROADMAP.md queue A item 2"
        )
    out_dtype = out_dtype or x.dtype
    if _dense_kernel_ok(x, w, interpret):
        m, d = x.shape
        kern = _tuned_kernel(matmul_spec(m, d, w.shape[1]), x.dtype,
                             interpret=interpret)
        return kern(x, w).to(out_dtype)
    return _matmul_f32(x, w, out_dtype)


def _grouped_kernel_ok(x: torch.Tensor, interpret: bool) -> bool:
    return (x.is_cuda or interpret) and x.dim() == 2


def _grouped_raw(x, w, group_sizes, out_dtype, interpret):
    if x.shape[0] and _grouped_kernel_ok(x, interpret):
        kern = _tuned_kernel(
            grouped_matmul_spec(group_sizes, x.shape[1], w.shape[2]),
            x.dtype, interpret=interpret,
        )
        # as in the reference, the kernel stores in x.dtype and only then
        # casts: in bf16 the f32 accumulator is rounded to bf16 first
        return kern(x, w).to(out_dtype)
    # the static per-group loop, the semantic definition of the op
    return grouped_ref(x, w, group_sizes, out_dtype=out_dtype)


def grouped_dense(x: torch.Tensor, w: torch.Tensor, group_sizes, *,
                  out_dtype=None, interpret: bool = False,
                  differentiable: bool = True) -> torch.Tensor:
    """Ragged grouped GEMM: row block g of ``x`` hits expert matrix w[g].

    x: (N, K) with N = sum(group_sizes), w: (G, K, F) -> (N, F).  One
    kernel launch walks the static group offsets (``codegen.fused_gen``)
    instead of G separate products -- the MoE expert-FFN pattern
    (``models.moe``).  Empty and size-1 groups are legal; empty groups
    contribute no rows and launch no work.
    """
    out_dtype = out_dtype or x.dtype
    group_sizes = tuple(int(s) for s in group_sizes)
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(
            f"grouped_dense expects x (N, K) and w (G, K, F); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}"
        )
    if len(group_sizes) != w.shape[0]:
        raise ValueError(
            f"{len(group_sizes)} group sizes for {w.shape[0]} expert slabs"
        )
    if sum(group_sizes) != x.shape[0]:
        raise ValueError(
            f"group sizes sum to {sum(group_sizes)} but x has "
            f"{x.shape[0]} rows"
        )
    return _grouped_raw(x, w, group_sizes, out_dtype, interpret)
