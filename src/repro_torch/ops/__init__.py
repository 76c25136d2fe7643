"""Framework-level dense ops, routed through the kernel generator.

``dense`` is the single entry point every model projection goes through.
Every non-empty call on a CUDA tensor is *eligible* (x's leading axes
folded into M; B1 masks ragged edges, so no alignment rule): it compiles
through ``repro_torch.codegen`` with the schedule from the plan DB
(serving-phase ladder first, then the unphased one) or else the tuner
(``codegen.tune_schedule``), and runs ``csrc/contract.cu``.  The device
decides, never a probe for a card: the reference's "on a TPU" becomes "on
a CUDA tensor".  Off the card ``interpret=True`` keeps the reference's
gate, a 2-D GEMM whose M, K and N are all multiples of 128, so CPU tests
reach the kernel's plain version where the reference reaches its kernel.
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
``grouped_matmul.dX/.dW``).  A launch called directly has no gradient, so
without the wrapper a kernel path would give none at all (under a
dispatch mode a launch is a ``repro_torch`` custom op, ``ops.library``,
whose autograd formula is the same derived-spec backward, for a traced
graph replayed without its wrapper: ``capture``).
``differentiable=False`` on a kernel path returns an output detached from
the graph (nothing can be differentiated through it, as the reference's
bare Pallas primal has no VJP); the non-kernel paths stay plain torch ops
that autograd differentiates natively.

``dense(quant="int8"|"fp8")`` is the low-precision tier: x is quantized
per tensor and w per output channel (plain PyTorch ops, as the reference's
``jnp`` ops), and every non-empty CUDA call (and, off the card, a
128-aligned one with ``interpret``) runs the ``quantized_matmul_spec`` on
B1's 8-bit tensor-core mode with ``Epilogue(dequant=True)`` applying
``qscale = sx * sw`` to its int32 (int8) or f32 (fp8) accumulator; the
quantized W is written k-major (the 8-bit mma's B fragment wants
consecutive k), the same values.  Other calls dequantize and multiply in
f32 with the same quantization.  The kernel path has no
gradient, as the reference's bare ``pallas_call`` has none: its output's
backward raises.  ``chain_dense`` is ``a @ b @ c`` on B1's chain mode, the
intermediate never in device memory, forward and (``grad.chain_dense_vjp``)
the three derived backward specs, one launch each.

Every entry point takes DTensor operands (parameters placed by
``launch.steps.shard_tree``), on the CPU too: such a call always takes
the kernel path, its plan looked up at the global extents for the op's
identity (never the mesh-qualified route, ``_tuned_kernel(sharded=)``),
and its launch goes through the op's sharding rule
(``ops.library.sharded_launch``), which runs the kernel's twin at each
rank's local extents (its plan looked up at those); the derived backward
specs take the same route.

``attention`` is fused QK^T -> online softmax -> PV over folded heads, q
(H, S, D), k (H, T, D), v (H, T, E): on a CUDA tensor (or with
``interpret=True``) a 3-D call compiles the ``AttentionSpec`` and runs
``csrc/attention.cu`` (kernel B2, one launch), the (S, T) probabilities
never in device memory; its backward (``grad.attention_vjp``) recomputes
them in f32 and runs the three derived specs ``attention.dQ/.dK/.dV`` on
B1, with or without ``kv_lengths``.  Off the card it is the plain f32
version ``codegen.attention_ref``, natively differentiable.
"""

from __future__ import annotations

import torch

from ..codegen import (
    Epilogue,
    attention_ref,
    cached_compile,
    grouped_ref,
    tune_schedule,
)
from ..core.enumerate import (
    QUANT_FORMATS,
    attention_spec,
    batched_matmul_spec,
    chain_matmul_spec,
    grouped_matmul_spec,
    matmul_spec,
    quantized_matmul_spec,
    transposed_matmul_spec,
    weighted_matmul_spec,
)
from ..codegen.cache import default_cache
from ..codegen.cache import generation as cache_generation
from ..codegen.cuda_gen import CardPlan
from ..codegen.fused_gen import FusedPlan, plan_from_dict
from ..obs import counter
from ..search import active_phase, default_plan_db
from .library import is_dtensor


#: ``_tuned_kernel``'s answers for the process: key -> (cache generation
#: at the lookup's end, kernel); emptied past ``_MEMO_MAX`` keys
_LOOKUPS: dict = {}
_MEMO_MAX = 4096


def _spec_key(spec) -> tuple:
    """The root contraction's identity as ``codegen.cache.spec_signature``
    defines it, as a hashable tuple (no JSON on the hot path)."""
    root = spec.root()
    q = root.quant
    kind = getattr(root, "fused_kind", "")
    return (root.name, tuple(root.operands.items()), root.output,
            tuple(root.extents.items()), root.reducer,
            None if q is None else (q.dtype, q.accum, q.scale),
            (kind, repr(sorted(root.fused_meta().items()))) if kind else None)


def _mesh_plan_kernel(spec, dtype, *, epilogue=None, out_dtype=None,
                      interpret=False):
    """A mesh-bound kernel from a mesh-qualified plan, or None.

    When the caller runs under a mesh of more than one rank
    (``launch.mesh.set_mesh``), the plan DB is consulted under the
    mesh-shape-qualified key ('2x4'-style, ``plandb.plan_key(mesh=...)``)
    for the best rung that actually distributes (``best_sharded_entry``).
    A sharded plan whose mesh axes match the active mesh compiles through
    ``codegen.bind_mesh`` with the plan's measured collective strategy:
    each rank launches the kernel on its shard.  Any mismatch (axis names
    or sizes, no plan) returns None and the caller falls back to the
    single-rank lookup, as in the reference -- a replica without mesh
    sweeps behaves exactly as before.
    """
    from ..launch.mesh import active_mesh, mesh_shape_descriptor
    from ..search import schedule_mesh_axes

    mesh = active_mesh()
    if mesh is None:
        return None
    sched, entry = default_plan_db().best_sharded_entry(
        spec, dtype, mesh=mesh_shape_descriptor(mesh))
    if sched is None:
        return None
    if any(mesh.shape.get(a) != n
           for a, n in schedule_mesh_axes(sched).items()):
        return None
    return cached_compile(
        spec, sched, epilogue=epilogue, out_dtype=out_dtype,
        interpret=interpret, mesh=mesh,
        collective=entry.get("collective") or "psum",
    )


def _mesh_key(mesh):
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(int(r) for r in mesh.devices.flat),
            tuple(mesh.devices.shape), mesh.transport)


def _tuned_kernel(spec, dtype, *, epilogue=None, out_dtype=None,
                  interpret=False, sharded=False):
    """Generated kernel for ``spec``: searched plan first, tuned fallback.

    ``sharded`` marks a call on DTensor operands (or a rank's twin of one,
    ``ops.library.local_kernel``): the op's sharding rule distributes it,
    so the mesh-qualified route is never taken for it.

    Lookup order as in the reference: under an active mesh the
    mesh-qualified plan first (``_mesh_plan_kernel``, a
    ``MeshBoundKernel``), then the active serving phase's ladder, then the
    unphased ladder, then the analytic tuner with its persistent cache;
    under an epilogue its own ladder (``search_schedule(epilogue=)``,
    the epilogue-qualified key, phased then unphased) comes before the
    product's.  A winning rung's ``card`` (the B1 tile plan a card
    ladder measured, the 8-bit ring's ``Q8Plan``, the chain's
    ``ChainPlan``, or a fused spec's ``FusedPlan``) is compiled into the
    kernel (``cached_compile(card=)``, whose memo keys it), except a plan
    measured without the epilogue a call runs under (B1's launch runs
    another body there, the 8-bit ring's time was not taken with it) and
    a plan of the other family than the spec's.  The answer is kept for the process
    (the reference looks up once per trace), keyed on the spec, dtype,
    epilogue, output dtype, ``interpret``, the active phase, the plan
    DB's and tuner cache's paths and the active mesh, and dropped when
    either cache is opened,
    written or cleared (``codegen.cache.generation``), so a new ladder's
    plan replaces the kept kernel (whose ``card`` is the plan it was
    compiled with); ``obs`` counts
    ``ops.lookup.memo_hit`` / ``.memo_miss``.  A hit skips the plan DB,
    the tuner cache and ``cached_compile``, and their counters.
    """
    from ..launch.mesh import active_mesh

    db = default_plan_db()
    phase = active_phase()
    mesh = None if sharded else active_mesh()
    key = (_spec_key(spec), dtype, epilogue, out_dtype, interpret, phase,
           getattr(db, "path", None), default_cache().path, _mesh_key(mesh))
    kept = _LOOKUPS.get(key)
    if kept is not None and kept[0] == cache_generation():
        counter("ops.lookup.memo_hit").inc()
        return kept[1]
    counter("ops.lookup.memo_miss").inc()
    if mesh is not None:
        kern = _mesh_plan_kernel(spec, dtype, epilogue=epilogue,
                                 out_dtype=out_dtype, interpret=interpret)
        if kern is not None:
            _keep(key, kern)
            return kern
    fused = bool(getattr(spec.root(), "fused_kind", ""))
    # the ladders to ask, first hit wins: under an epilogue its own
    # (measured on the body the launch runs), then the product's
    quals = [None]
    if epilogue is not None and not fused:
        quals.insert(0, epilogue.kind)
    schedule, rung, own = None, {}, False
    for qual in quals:
        kw = {} if qual is None else {"epilogue": qual}
        for ph in ((phase, None) if phase is not None else (None,)):
            schedule, rung = db.best_entry(spec, dtype, phase=ph, **kw)
            if schedule is not None:
                break
        if schedule is not None:
            own = qual is not None
            break
    if schedule is None:
        schedule = tune_schedule(spec, dtype=dtype)
    # a card ladder's winner carries the plan it was measured with
    card = plan_from_dict(rung.get("card"))
    if not fused and epilogue is not None and not own:
        # measured without the epilogue: B1's launch under one runs
        # another body (the fused ring, tc32's epilogue mode), and the
        # 8-bit ring's time under it was never taken
        card = None
    if isinstance(card, CardPlan) and fused:
        card = None
    if isinstance(card, FusedPlan) and not fused:
        card = None
    kern = cached_compile(spec, schedule, epilogue=epilogue,
                          out_dtype=out_dtype, interpret=interpret,
                          card=card)
    _keep(key, kern)
    return kern


def _keep(key, kern) -> None:
    if len(_LOOKUPS) >= _MEMO_MAX:
        _LOOKUPS.clear()
    _LOOKUPS[key] = (cache_generation(), kern)


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
    # every non-empty 2-D CUDA call runs B1 (``dense`` folds x's leading
    # axes into M first; B1 masks ragged edges); off the card ``interpret``
    # keeps the reference's gate, a 2-D GEMM with M, K and N multiples of 128
    if x.is_cuda or is_dtensor(x):
        return x.dim() == 2 and x.numel() > 0 and w.numel() > 0
    return interpret and x.dim() == 2 and all(
        s % 128 == 0 for s in (*x.shape, w.shape[1])
    )


def _batched_kernel_ok(x: torch.Tensor, w: torch.Tensor,
                       interpret: bool) -> bool:
    return (x.is_cuda or interpret or is_dtensor(x)) and x.dim() == 3 and (
        w.dim() == 3)


def _generic_kernel_ok(x: torch.Tensor, interpret: bool) -> bool:
    # a DTensor operand always takes the kernel's op, whose sharding rule
    # distributes it (``ops.library.sharded_launch``), on the CPU too
    return x.is_cuda or interpret or is_dtensor(x)


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
                             interpret=interpret, sharded=is_dtensor(x))
        return kern(x, w).to(out_dtype)
    return _matmul_f32(x, w, out_dtype)


class _NoGradient(torch.autograd.Function):
    """Marks a kernel output that has no gradient rule: the forward passes
    it through, a backward through it raises (as ``jax.grad`` over the
    reference's bare ``pallas_call`` does), so a caller that asked for a
    gradient is never handed a silent zero."""

    @staticmethod
    def forward(ctx, out, *inputs):
        ctx.what = "the quantized kernel path of ops.dense(quant=)"
        return out.view_as(out)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(f"{ctx.what} is not differentiable (int8/fp8 "
                           f"storage, as in the reference); call it under "
                           f"torch.no_grad() or without quant=")


def _quant_kernel_ok(x2: torch.Tensor, w: torch.Tensor,
                     interpret: bool) -> bool:
    # every non-empty CUDA call runs B1's 8-bit mode, ragged shapes too;
    # off the card ``interpret`` reaches the kernel's plain version for the
    # 128-aligned shapes the reference's kernel path takes
    if not x2.shape[0]:
        return False
    return x2.is_cuda or is_dtensor(x2) or _dense_kernel_ok(x2, w,
                                                            interpret)


def _dense_quant(x, w, fmt, out_dtype, interpret):
    """Dynamic-quantized dense: int8/fp8 storage, dequant epilogue.

    ``x`` is quantized per tensor (one absmax scale), ``w`` per output
    channel (one scale per column of F): the combined ``qscale = sx * sw``
    row is what the kernel's dequant epilogue multiplies into the
    accumulator, so the kernel streams 1-byte operands and writes
    real-valued output in one pass.  ``w`` is quantized k-major (the 8-bit
    kernel reads its k axis contiguous) and taken as the (D, F) view.  An
    empty batch, and a CPU call without ``interpret``, take the
    dequantize-then-dot fallback with the same quantization.
    """
    from ..optim.quant import quantize_channels_kmajor, quantize_tensor

    if fmt not in QUANT_FORMATS:
        raise ValueError(
            f"quant must be one of {sorted(QUANT_FORMATS)}, got {fmt!r}"
        )
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    qx, sx = quantize_tensor(x2, fmt)
    qwt, sw = quantize_channels_kmajor(w, fmt)
    qw = qwt.t()
    qscale = (sx * sw).to(torch.float32)
    if _quant_kernel_ok(x2, w, interpret):
        m, d = x2.shape
        kern = _tuned_kernel(
            quantized_matmul_spec(m, d, w.shape[1], fmt), qx.dtype,
            epilogue=Epilogue(dequant=True), out_dtype=torch.float32,
            interpret=interpret, sharded=is_dtensor(x),
        )
        with torch.no_grad():
            out = kern(qx, qw, qscale=qscale)
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _NoGradient.apply(out, x, w)
    else:
        out = torch.matmul(qx.float(), qw.float()) * qscale[None, :]
    return out.reshape(*lead, w.shape[1]).to(out_dtype)


def dense(x: torch.Tensor, w: torch.Tensor, out_dtype=None,
          interpret: bool = False, differentiable: bool = True,
          quant=None) -> torch.Tensor:
    """x: (..., D) @ w: (D, F) -> (..., F), f32 accumulation.

    On the kernel path, ``differentiable`` (the default) goes through
    ``grad.dense_vjp``: the same primal plus a backward whose dA/dB GEMMs
    run the derived specs ``matmul.dA``/``matmul.dB`` on the kernel.

    ``quant`` ('int8' | 'fp8') takes the low-precision tier instead
    (``_dense_quant``): dynamic quantization, the dtype-qualified plan
    (``matmul@...@dtype=int8``) and B1's 8-bit mode with the dequant
    epilogue, one launch.  It is inference-oriented: only the fallback
    path is differentiable (through the scales, as in the reference).
    """
    out_dtype = out_dtype or x.dtype
    if quant is not None:
        return _dense_quant(x, w, quant, out_dtype, interpret)
    if (x.is_cuda or is_dtensor(x)) and x.dim() != 2:
        return _fold_rows(dense, x, w, out_dtype=out_dtype,
                          interpret=interpret, differentiable=differentiable)
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
    return x.is_cuda or is_dtensor(x) or (interpret and x.dim() == 2)


def _fold_rows(op, x, w, *rest, **kw):
    """``op`` on x with its leading axes folded into rows, so that a CUDA
    call of any rank runs the one 2-D spec on B1, backward included."""
    out = op(x.reshape(-1, x.shape[-1]), w, *rest, **kw)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _weighted_dense_raw(x, w, g, out_dtype, interpret):
    if _weighted_kernel_ok(x, interpret):
        m, d = x.shape
        kern = _tuned_kernel(weighted_matmul_spec(m, d, w.shape[1]), x.dtype,
                             interpret=interpret, sharded=is_dtensor(x))
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
    if (x.is_cuda or is_dtensor(x)) and x.dim() != 2:
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
                             x.dtype, interpret=interpret,
                             sharded=is_dtensor(x))
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


def _chain_dense_raw(a, b, c, out_dtype, interpret):
    if _generic_kernel_ok(a, interpret):
        m, k1 = a.shape
        kern = _tuned_kernel(
            chain_matmul_spec(m, k1, b.shape[1], c.shape[1]), a.dtype,
            interpret=interpret, sharded=is_dtensor(a))
        return kern(a, b, c).to(out_dtype)
    # the reference's fallback: a @ b accumulated in f32 and rounded to
    # a's dtype, then the second product
    ab = torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(ab.float(), c.float()).to(out_dtype)


def chain_dense(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                out_dtype=None, interpret: bool = False,
                differentiable: bool = True) -> torch.Tensor:
    """a @ b @ c without materializing the intermediate in device memory.

    B1's chain mode: one launch, two reductions (``chain_matmul``).  The
    backward specs are three-operand contractions (e.g.
    ``chain_matmul.dB``: dB[j,k] = sum_il A[i,j] g[i,l] C[k,l]), each one
    more chain launch (``grad.chain_dense_vjp``).
    """
    out_dtype = out_dtype or a.dtype
    if _generic_kernel_ok(a, interpret):
        if differentiable:
            from ..grad import chain_dense_vjp

            return chain_dense_vjp(_dt_name(out_dtype),
                                   bool(interpret))(a, b, c)
        with torch.no_grad():
            return _chain_dense_raw(a, b, c, out_dtype, interpret)
    return _chain_dense_raw(a, b, c, out_dtype, interpret)


def _dense_transposed_raw(a, b, out_dtype, interpret):
    if _generic_kernel_ok(a, interpret):
        d, m = a.shape
        kern = _tuned_kernel(transposed_matmul_spec(m, d, b.shape[1]),
                             a.dtype, interpret=interpret,
                             sharded=is_dtensor(a))
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
    return (x.is_cuda or interpret or is_dtensor(x)) and x.dim() == 2


def _grouped_raw(x, w, group_sizes, out_dtype, interpret):
    if x.shape[0] and _grouped_kernel_ok(x, interpret):
        kern = _tuned_kernel(
            grouped_matmul_spec(group_sizes, x.shape[1], w.shape[2]),
            x.dtype, interpret=interpret, sharded=is_dtensor(x),
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
                             epilogue=epi, interpret=interpret,
                             sharded=is_dtensor(x))
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
    if (x.is_cuda or is_dtensor(x)) and x.dim() != 2:
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


def _attention_kernel_ok(q: torch.Tensor, interpret: bool) -> bool:
    return (q.is_cuda or interpret or is_dtensor(q)) and q.dim() == 3


def _attention_raw(q, k, v, *, causal, kv_lengths, out_dtype, interpret):
    if _attention_kernel_ok(q, interpret):
        h, s, d = q.shape
        kern = _tuned_kernel(
            attention_spec(h, s, k.shape[1], d, e=v.shape[2],
                           causal=causal),
            q.dtype, interpret=interpret, sharded=is_dtensor(q),
        )
        return kern(q, k, v, kv_lengths=kv_lengths).to(out_dtype)
    return attention_ref(q, k, v, causal=causal, kv_lengths=kv_lengths,
                         out_dtype=out_dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, kv_lengths=None, out_dtype=None,
              interpret: bool = False,
              differentiable: bool = True) -> torch.Tensor:
    """Fused QK^T -> online-softmax -> PV through the searched kernel.

    q: (H, S, D), k: (H, T, D), v: (H, T, E) -> (H, S, E).  Scores are
    scaled by D^-0.5 and accumulated in f32; kernel B2 walks the KV axis
    inside each CTA carrying the running max and sum, so the (S, T)
    probability matrix never exists in device memory
    (``codegen.fused_gen``).  ``causal`` masks columns after the row;
    ``kv_lengths`` (int32, one per folded head) masks columns ``>=
    length``; rows with no valid column return exact zeros.

    On the kernel path a differentiable call goes through
    ``grad.attention_vjp`` (a recompute backward, masked as the forward,
    whose GEMMs are the derived ``attention.dQ/.dK/.dV`` specs).  Unlike
    the reference, whose differentiable call with ``kv_lengths`` takes its
    plain version, lengths reach the kernel here too.  Off the kernel path
    the plain version is natively differentiable.
    """
    out_dtype = out_dtype or q.dtype
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(
            f"attention expects 3-D (H, S|T, D|E) operands; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if kv_lengths is not None:
        kv_lengths = torch.as_tensor(kv_lengths, device=q.device).to(
            torch.int32).reshape(-1).contiguous()
    if _attention_kernel_ok(q, interpret):
        if differentiable:
            from ..grad import attention_vjp

            return attention_vjp(bool(causal), _dt_name(out_dtype),
                                 bool(interpret))(q, k, v, kv_lengths)
        with torch.no_grad():
            return _attention_raw(q, k, v, causal=causal,
                                  kv_lengths=kv_lengths, out_dtype=out_dtype,
                                  interpret=interpret)
    return _attention_raw(q, k, v, causal=causal, kv_lengths=kv_lengths,
                          out_dtype=out_dtype, interpret=interpret)
