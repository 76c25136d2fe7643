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
``batched_dense`` and ``dense_transposed`` are the reference's batched and
transposed entry points on the same kernel (every 3-D call, every call,
respectively, on a CUDA tensor or with ``interpret=True``).

``weighted_dense`` is the paper's eq 2, ``sum_j x_ij w_jk g_j``: on a CUDA
tensor every call (x's leading axes folded into M), and with
``interpret=True`` every 2-D call, compiles the three-operand
``weighted_matmul`` spec and runs B1's vector mode (g scales the A tile as
it is staged, no ``x * g`` copy in device memory); a CPU tensor otherwise
has ``x * g`` rounded in x's dtype and multiplied with f32 accumulation, as
the reference does.  ``dense_act`` is eqs 3-5, dense + bias + normalization
+ activation: on a CUDA tensor (leading axes folded the same way) or with
``interpret=True`` every call runs B1 with an
``Epilogue(act, bias, norm, eps)`` on its f32 accumulator, and otherwise
``kernels.fused_dense_act.ref.fused_dense_act_ref``.  On both
kernel paths the kernel writes the operand dtype and ``ops`` then casts to
``out_dtype``, as the reference does.  Neither op carries state: their
inputs are all arguments.

``grouped_dense`` is the ragged grouped GEMM of the MoE experts.  It has
no alignment rule: on a CUDA tensor (or with ``interpret=True``) every call
with rows compiles the ``GroupedSpec`` through the same lookup and runs
``csrc/grouped.cu`` (kernel B3); otherwise it is the plain per-group loop.

All entry points are differentiable by default, as in the reference:
where a call dispatches to a kernel, ``differentiable=True`` routes it
through the ``repro_torch.grad`` ``autograd.Function``s, whose backward
GEMMs are the derived specs on the same kernels (B1 for ``matmul.dA/.dB``
and ``weighted_matmul.dA/.dB/.dg``, B3's dX orientation and B4 for
``grouped_matmul.dX/.dW``).  The kernels
write through ctypes into fresh tensors that carry no ``grad_fn``, so
without the wrapper a kernel path would give no gradient at all.
``differentiable=False`` on a kernel path returns an output detached from
the graph (nothing can be differentiated through it, as the reference's
bare Pallas primal has no VJP); the non-kernel paths stay plain torch ops
that autograd differentiates natively.  ``quant=`` and ``chain_dense``
come with B1's int8/fp8 and chain modes (ROADMAP.md queue A item 2b).
"""

from __future__ import annotations

import torch

from ..codegen import Epilogue, cached_compile, grouped_ref, tune_schedule
from ..core.enumerate import (
    batched_matmul_spec,
    grouped_matmul_spec,
    matmul_spec,
    transposed_matmul_spec,
    weighted_matmul_spec,
)
from ..search import active_phase, default_plan_db


def _tuned_kernel(spec, dtype, *, epilogue=None, out_dtype=None,
                  interpret=False):
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
    return cached_compile(spec, schedule, epilogue=epilogue,
                          out_dtype=out_dtype, interpret=interpret)


def warm_dense_cache(shapes, dtype=torch.bfloat16) -> int:
    """Pre-tune schedules for (m, k, n) GEMMs; returns #schedules readied."""
    count = 0
    for m, k, n in shapes:
        tune_schedule(matmul_spec(m, k, n), dtype=dtype)
        count += 1
    return count


def _dt_name(dtype) -> str:
    """Hashable dtype key for the grad factory caches."""
    return str(dtype).replace("torch.", "")


# -- kernel-dispatch predicates, shared with the grad.vjp backward passes --


def _dense_kernel_ok(x: torch.Tensor, w: torch.Tensor,
                     interpret: bool) -> bool:
    return (x.is_cuda or interpret) and x.dim() == 2 and all(
        s % 128 == 0 for s in (*x.shape, w.shape[1])
    )


def _batched_kernel_ok(x: torch.Tensor, w: torch.Tensor,
                       interpret: bool) -> bool:
    return (x.is_cuda or interpret) and x.dim() == 3 and w.dim() == 3


def _generic_kernel_ok(x: torch.Tensor, interpret: bool) -> bool:
    return x.is_cuda or interpret


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


def _dense_raw(x, w, out_dtype, interpret):
    if _dense_kernel_ok(x, w, interpret):
        m, d = x.shape
        kern = _tuned_kernel(matmul_spec(m, d, w.shape[1]), x.dtype,
                             interpret=interpret)
        return kern(x, w).to(out_dtype)
    return _matmul_f32(x, w, out_dtype)


def dense(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
          interpret: bool = False, differentiable: bool = True,
          quant=None) -> torch.Tensor:
    """x: (..., D) @ w: (D, F) -> (..., F), f32 accumulation.

    On the kernel path, ``differentiable`` (the default) goes through
    ``grad.dense_vjp``: the same primal plus a backward whose dA/dB GEMMs
    run the derived specs ``matmul.dA``/``matmul.dB`` on the kernel.
    """
    if quant is not None:
        raise NotImplementedError(
            "quantized dense (quant=) comes with B1's int8/fp8 modes, "
            "ROADMAP.md queue A item 2b"
        )
    out_dtype = out_dtype or x.dtype
    if _dense_kernel_ok(x, w, interpret):
        if differentiable:
            from ..grad import dense_vjp

            return dense_vjp(_dt_name(out_dtype), bool(interpret))(x, w)
        with torch.no_grad():
            return _dense_raw(x, w, out_dtype, interpret)
    return _dense_raw(x, w, out_dtype, interpret)


def _weighted_kernel_ok(x: torch.Tensor, interpret: bool) -> bool:
    # every CUDA call runs B1 (``weighted_dense`` folds x's leading axes
    # into M first); off the card ``interpret`` reaches the kernel's plain
    # version for a 2-D x only, as in the reference
    return x.is_cuda or (interpret and x.dim() == 2)


def _fold_rows(op, x, w, *rest, **kw):
    """``op`` on x with its leading axes folded into rows, so that a CUDA
    call of any rank runs the one 2-D spec on B1, backward included."""
    out = op(x.reshape(-1, x.shape[-1]), w, *rest, **kw)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _weighted_dense_raw(x, w, g, out_dtype, interpret):
    if _weighted_kernel_ok(x, interpret):
        m, d = x.shape
        kern = _tuned_kernel(weighted_matmul_spec(m, d, w.shape[1]), x.dtype,
                             interpret=interpret)
        return kern(x, w, g).to(out_dtype)
    # the zipper x * g rounds in x's dtype, then an f32-accumulated product
    return _matmul_f32(x * g[None, :], w, out_dtype)


def weighted_dense(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                   out_dtype=None, interpret: bool = False,
                   differentiable: bool = True) -> torch.Tensor:
    """sum_j x_.j w_jk g_j -- paper eq 2, through the generator.

    The three-operand ``weighted_matmul`` spec with its own plan-DB and
    autotune keys; the hand-written ``kernels/fused_rnz`` kernel (B7)
    remains as a verification baseline.  On the kernel path the backward
    (``grad.weighted_dense_vjp``) runs the derived ``weighted_matmul.dA``,
    ``.dB`` and ``.dg`` specs, one B1 launch each; ``dg`` is a genuine
    three-operand contraction, dg[j] = sum_ik dout[i,k] A[i,j] B[j,k].
    """
    out_dtype = out_dtype or x.dtype
    if x.is_cuda and x.dim() != 2:
        return _fold_rows(weighted_dense, x, w, g, out_dtype=out_dtype,
                          interpret=interpret, differentiable=differentiable)
    if _weighted_kernel_ok(x, interpret):
        if differentiable:
            from ..grad import weighted_dense_vjp

            return weighted_dense_vjp(_dt_name(out_dtype),
                                      bool(interpret))(x, w, g)
        with torch.no_grad():
            return _weighted_dense_raw(x, w, g, out_dtype, interpret)
    return _weighted_dense_raw(x, w, g, out_dtype, interpret)


def _batched_dense_raw(x, w, out_dtype, interpret):
    if _batched_kernel_ok(x, w, interpret):
        b, m, d = x.shape
        kern = _tuned_kernel(batched_matmul_spec(b, m, d, w.shape[2]),
                             x.dtype, interpret=interpret)
        return kern(x, w).to(out_dtype)
    return torch.einsum("bmd,bdf->bmf", x.float(), w.float()).to(out_dtype)


def batched_dense(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
                  interpret: bool = False,
                  differentiable: bool = True) -> torch.Tensor:
    """x: (B, M, D) @ w: (B, D, F) -> (B, M, F) through the generator."""
    out_dtype = out_dtype or x.dtype
    if _batched_kernel_ok(x, w, interpret):
        if differentiable:
            from ..grad import batched_dense_vjp

            return batched_dense_vjp(_dt_name(out_dtype),
                                     bool(interpret))(x, w)
        with torch.no_grad():
            return _batched_dense_raw(x, w, out_dtype, interpret)
    return _batched_dense_raw(x, w, out_dtype, interpret)


def _dense_transposed_raw(a, b, out_dtype, interpret):
    if _generic_kernel_ok(a, interpret):
        d, m = a.shape
        kern = _tuned_kernel(transposed_matmul_spec(m, d, b.shape[1]),
                             a.dtype, interpret=interpret)
        return kern(a, b).to(out_dtype)
    return torch.einsum("dm,df->mf", a.float(), b.float()).to(out_dtype)


def dense_transposed(a: torch.Tensor, b: torch.Tensor, out_dtype=None,
                     interpret: bool = False,
                     differentiable: bool = True) -> torch.Tensor:
    """a: (D, M) (stored transposed), b: (D, F) -> (M, F) = a.T @ b."""
    out_dtype = out_dtype or a.dtype
    if _generic_kernel_ok(a, interpret):
        if differentiable:
            from ..grad import dense_transposed_vjp

            return dense_transposed_vjp(_dt_name(out_dtype),
                                        bool(interpret))(a, b)
        with torch.no_grad():
            return _dense_transposed_raw(a, b, out_dtype, interpret)
    return _dense_transposed_raw(a, b, out_dtype, interpret)


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
    contribute no rows and launch no work.  On the kernel path the
    backward (``grad.grouped_vjp``) stays ragged: dX on B3's dX
    orientation, dW on B4.
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
    if x.shape[0] and _grouped_kernel_ok(x, interpret):
        if differentiable:
            from ..grad import grouped_vjp

            return grouped_vjp(group_sizes, _dt_name(out_dtype),
                               bool(interpret))(x, w)
        with torch.no_grad():
            return _grouped_raw(x, w, group_sizes, out_dtype, interpret)
    return _grouped_raw(x, w, group_sizes, out_dtype, interpret)


def _dense_act_raw(x, w, beta, mean, var, *, act, eps, out_dtype, interpret):
    if _generic_kernel_ok(x, interpret):
        m, d = x.shape
        epi = Epilogue(act=act, bias=True, norm=True, eps=eps)
        kern = _tuned_kernel(matmul_spec(m, d, w.shape[1]), x.dtype,
                             epilogue=epi, interpret=interpret)
        return kern(x, w, bias=beta, mean=mean, var=var).to(out_dtype)
    from ..kernels.fused_dense_act.ref import fused_dense_act_ref

    return fused_dense_act_ref(x, w, beta, mean, var, act=act,
                               eps=eps).to(out_dtype)


def dense_act(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
              mean: torch.Tensor, var: torch.Tensor, *, act: str = "gelu",
              eps: float = 1e-5, out_dtype=None, interpret: bool = False,
              differentiable: bool = True) -> torch.Tensor:
    """Generated dense + bias + normalization + activation (paper eqs 3-5).

    Subsumes ``kernels/fused_dense_act`` (B6, kept as the baseline): the
    epilogue runs on B1's f32 accumulator before the store, so y and z
    never round-trip device memory.  The backward
    (``grad.dense_act_vjp``) recomputes the accumulator with one extra B1
    launch, runs the element-wise epilogue VJP with torch autograd on
    ``Epilogue.apply`` and routes dacc through ``matmul.dA``/``.dB``.
    """
    out_dtype = out_dtype or x.dtype
    if x.is_cuda and x.dim() != 2:
        return _fold_rows(dense_act, x, w, beta, mean, var, act=act, eps=eps,
                          out_dtype=out_dtype, interpret=interpret,
                          differentiable=differentiable)
    if _generic_kernel_ok(x, interpret):
        if differentiable:
            from ..grad import dense_act_vjp

            return dense_act_vjp(act, float(eps), _dt_name(out_dtype),
                                 bool(interpret))(x, w, beta, mean, var)
        with torch.no_grad():
            return _dense_act_raw(x, w, beta, mean, var, act=act, eps=eps,
                                  out_dtype=out_dtype, interpret=interpret)
    return _dense_act_raw(x, w, beta, mean, var, act=act, eps=eps,
                          out_dtype=out_dtype, interpret=interpret)
