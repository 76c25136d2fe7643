"""``torch.autograd.Function``s: primal and cotangent GEMMs through codegen.

A kernel launch writes through ctypes into a fresh output, directly or,
under a dispatch mode, as one ``torch.library`` custom op of the
``repro_torch`` namespace (``ops.library``: ``contract``, ``attention``,
``grouped``, ``grouped_dw``).  A launch inside an ``ops`` entry point is
differentiated by the wrapper around it: without these wrappers autograd
through a model on the card gives no gradient to any projection or
expert weight.  (The ops carry the same cotangents as their own autograd
formula, ``launch_cotangents`` and kin, for a graph that holds a launch
without its wrapper: a ``capture`` replay.)  As an op, each launch is
seen by the mode:
a selective-checkpoint policy (``models.layers.remat``) can save a
forward's launch output and a dry-run (``launch.dryrun``) can trace it on
fake tensors.  Each wrapper here pairs an ``ops`` primal with the reference's
hand-derived VJP (``repro/grad/vjp.py``), whose GEMMs are the derived
ContractionSpecs of ``grad.derive`` lowered through the very same pipeline
as the forward pass (``ops._tuned_kernel``: the plan DB first, the tuner
second), so on a CUDA tensor the backward GEMMs run the hand-written
kernels too: ``matmul.dA``/``.dB`` on B1 (``csrc/contract.cu``),
``grouped_matmul.dX`` on B3's dX orientation (``csrc/grouped.cu``) and
``grouped_matmul.dW`` on B4 (``csrc/grouped_dw.cu``); the weighted
family's ``weighted_matmul.dA``/``.dB`` on B1's vector mode and ``.dg`` on
its row-reduce mode; ``chain_matmul.dA``/``.dB``/``.dC`` on its chain mode;
``attention.dQ``/``.dK``/``.dV`` on B1 as batched products over the heads.

The reference's rules hold:

* cotangents are cast to their primal operand's dtype before the backward
  GEMM, so bf16 training runs bf16 backward GEMMs with f32 accumulation;
* each backward GEMM keys its own derived spec through ``_tuned_kernel``;
* ``dense`` with a non-2-D ``x`` backpropagates with the f32 einsum;
* the grouped non-kernel backward is the per-group loop, never an einsum
  over the group axis (which would sum the groups together).

Unlike the reference, a backward computes only the cotangents autograd
asks for (``ctx.needs_input_grad``); in training every operand needs one.
The factories are memoized on their static parameters (dtype name,
``interpret``, group sizes) as the reference's ``custom_vjp`` factories
are, and return a plain function of the tensors.  ``dense_act`` recomputes
its f32 accumulator with one extra B1 launch and differentiates the
element-wise epilogue with torch autograd on ``Epilogue.apply``.  The
``attention`` VJP runs its forward on B2 and recomputes the probabilities
in its backward, whose three GEMMs ``attention.dQ/.dK/.dV`` run on B1.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, Optional, Sequence

import torch

from ..codegen.cuda_gen import contract_ref
from ..codegen.fused_gen import attention_probs
from ..codegen.epilogue import Epilogue
from .derive import COTANGENT, derived_specs


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch,
                                                                str(dtype))


def apply_spec(spec, arrays: Dict[str, torch.Tensor], *, out_dtype,
               interpret: bool = False, use_kernel: bool = False):
    """Evaluate ``spec`` over named tensors: generated kernel or einsum.

    The kernel path is the exact ``ops._tuned_kernel`` pipeline the primal
    uses, keyed by this (possibly derived) spec.  The other path is the
    kernel's plain version (``contract_ref``: a product-sum over f32
    upcasts), the reference's f32-accumulated einsum.
    """
    if use_kernel:
        from ..ops import _tuned_kernel
        from ..ops.library import is_dtensor

        first = next(iter(spec.operands))
        kern = _tuned_kernel(spec, arrays[first].dtype, interpret=interpret,
                             sharded=any(is_dtensor(a)
                                         for a in arrays.values()))
        return kern(*(arrays[n] for n in spec.operands)).to(out_dtype)
    return contract_ref(spec, *(arrays[n] for n in spec.operands),
                        out_dtype=out_dtype)


def _cotangent_gemms(spec, g, operands, *, interpret, use_kernel,
                     wrt: Optional[Iterable[str]] = None):
    """Operand cotangents of ``spec`` via its derived backward specs; only
    those named in ``wrt`` when it is given."""
    wanted = None if wrt is None else set(wrt)
    out = {}
    for name, dspec in derived_specs(spec).items():
        if wanted is not None and name not in wanted:
            continue
        arrays = {COTANGENT: g.to(operands[name].dtype)}
        for other, arr in operands.items():
            if other != name:
                arrays[other] = arr
        out[name] = apply_spec(
            dspec, arrays, out_dtype=operands[name].dtype,
            interpret=interpret, use_kernel=use_kernel,
        )
    return out


def launch_cotangents(kernel, g, arrays, wanted):
    """The operand cotangents of one B1 launch (a ``codegen.CompiledKernel``
    called on ``arrays``, the root spec's operands in order): each the
    derived spec of its operand on the same kernel pipeline, as the
    ``ops`` wrappers of this module run them, None where ``wanted`` is
    false.  What ``ops.library`` registers as the autograd formula of
    ``repro_torch::contract``, so a launch replayed from a traced graph
    (``capture``) differentiates as the wrapper around it did.  A launch
    with an epilogue or of an 8-bit spec has no such rule and raises."""
    spec = kernel.spec.root()
    if kernel.epilogue is not None or spec.quant is not None or getattr(
            spec, "fused_kind", ""):
        raise RuntimeError(
            f"a {spec.name} launch with an epilogue, an 8-bit or a fused "
            f"spec has no gradient rule of its own; differentiate through "
            f"its ops entry point instead")
    names = tuple(spec.operands)
    cots = _cotangent_gemms(
        spec, g, dict(zip(names, arrays)), interpret=kernel.interpret,
        use_kernel=True, wrt=[n for n, w in zip(names, wanted) if w])
    return [cots.get(n) for n in names]


def _wanted(ctx, names: Sequence[str]):
    return [n for n, need in zip(names, ctx.needs_input_grad) if need]


def _annotate(op: str):
    """A profiler range ``grad.<op>.backward`` around a backward's GEMMs,
    so a trace can tell backward kernels from forward ones.  Each backward
    unpacks its saved tensors before entering it: under ``cfg.remat`` that
    unpacking recomputes the layer's forward, which stays outside."""
    return torch.profiler.record_function(f"grad.{op}.backward")


class _Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, out_dtype, interpret):
        from .. import ops

        ctx.save_for_backward(x, w)
        ctx.interpret = interpret
        return ops._dense_raw(x, w, out_dtype, interpret)

    @staticmethod
    def backward(ctx, g):
        from .. import ops
        from ..core.enumerate import matmul_spec

        x, w = ctx.saved_tensors
        if x.dim() != 2:
            # the primal was a plain product over the flattened batch; keep
            # the classical batched VJP (still f32-accumulated)
            gf = g.float()
            dx = dw = None
            if ctx.needs_input_grad[0]:
                dx = torch.einsum("...f,df->...d", gf, w.float()).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.einsum("...d,...f->df", x.float(), gf).to(w.dtype)
            return dx, dw, None, None
        m, d = x.shape
        spec = matmul_spec(m, d, w.shape[1])
        with _annotate("dense"):
            cots = _cotangent_gemms(
                spec, g, {"A": x, "B": w}, interpret=ctx.interpret,
                use_kernel=ops._dense_kernel_ok(x, w, ctx.interpret),
                wrt=_wanted(ctx, ("A", "B")),
            )
        return cots.get("A"), cots.get("B"), None, None


class _BatchedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, out_dtype, interpret):
        from .. import ops

        ctx.save_for_backward(x, w)
        ctx.interpret = interpret
        return ops._batched_dense_raw(x, w, out_dtype, interpret)

    @staticmethod
    def backward(ctx, g):
        from .. import ops
        from ..core.enumerate import batched_matmul_spec

        x, w = ctx.saved_tensors
        b, m, d = x.shape
        spec = batched_matmul_spec(b, m, d, w.shape[2])
        with _annotate("batched_dense"):
            cots = _cotangent_gemms(
                spec, g, {"A": x, "B": w}, interpret=ctx.interpret,
                use_kernel=ops._batched_kernel_ok(x, w, ctx.interpret),
                wrt=_wanted(ctx, ("A", "B")),
            )
        return cots.get("A"), cots.get("B"), None, None


class _DenseTransposed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, out_dtype, interpret):
        from .. import ops

        ctx.save_for_backward(a, b)
        ctx.interpret = interpret
        return ops._dense_transposed_raw(a, b, out_dtype, interpret)

    @staticmethod
    def backward(ctx, g):
        from .. import ops
        from ..core.enumerate import transposed_matmul_spec

        a, b = ctx.saved_tensors
        d, m = a.shape
        spec = transposed_matmul_spec(m, d, b.shape[1])
        with _annotate("dense_transposed"):
            cots = _cotangent_gemms(
                spec, g, {"A": a, "B": b}, interpret=ctx.interpret,
                use_kernel=ops._generic_kernel_ok(a, ctx.interpret),
                wrt=_wanted(ctx, ("A", "B")),
            )
        return cots.get("A"), cots.get("B"), None, None


class _WeightedDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, g, out_dtype, interpret):
        from .. import ops

        ctx.save_for_backward(x, w, g)
        ctx.interpret = interpret
        return ops._weighted_dense_raw(x, w, g, out_dtype, interpret)

    @staticmethod
    def backward(ctx, grad_out):
        from .. import ops
        from ..core.enumerate import weighted_matmul_spec

        x, w, g = ctx.saved_tensors
        m, d = x.shape
        spec = weighted_matmul_spec(m, d, w.shape[1])
        with _annotate("weighted_dense"):
            cots = _cotangent_gemms(
                spec, grad_out, {"A": x, "B": w, "g": g},
                interpret=ctx.interpret,
                use_kernel=ops._weighted_kernel_ok(x, ctx.interpret),
                wrt=_wanted(ctx, ("A", "B", "g")),
            )
        return cots.get("A"), cots.get("B"), cots.get("g"), None, None


class _DenseAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, beta, mean, var, act, eps, out_dtype, interpret):
        from .. import ops

        ctx.save_for_backward(x, w, beta, mean, var)
        ctx.act, ctx.eps, ctx.interpret = act, eps, interpret
        return ops._dense_act_raw(x, w, beta, mean, var, act=act, eps=eps,
                                  out_dtype=out_dtype, interpret=interpret)

    @staticmethod
    def backward(ctx, g):
        from .. import ops
        from ..core.enumerate import matmul_spec

        x, w, beta, mean, var = ctx.saved_tensors
        m, d = x.shape
        spec = matmul_spec(m, d, w.shape[1])
        use_kernel = ops._generic_kernel_ok(x, ctx.interpret)
        epi = Epilogue(act=ctx.act, bias=True, norm=True, eps=ctx.eps)
        with _annotate("dense_act"):
            # the fused forward never stored its accumulator: recompute it
            # (same spec, same plan as the primal), then the element-wise
            # epilogue VJP on it
            acc = apply_spec(spec, {"A": x, "B": w}, out_dtype=torch.float32,
                             interpret=ctx.interpret, use_kernel=use_kernel)
            leaves = [acc] + [v.detach().requires_grad_(True)
                              for v in (beta, mean, var)]
            leaves[0].requires_grad_(True)
            with torch.enable_grad():
                out = epi.apply(leaves[0], {
                    name: v.float().reshape(1, -1)
                    for name, v in zip(("bias", "mean", "var"), leaves[1:])
                })
                dacc, dbeta, dmean, dvar = torch.autograd.grad(
                    out, leaves, g.float())
            cots = _cotangent_gemms(
                spec, dacc, {"A": x, "B": w}, interpret=ctx.interpret,
                use_kernel=use_kernel, wrt=_wanted(ctx, ("A", "B")),
            )
        return (cots.get("A"), cots.get("B"), dbeta.to(beta.dtype),
                dmean.to(mean.dtype), dvar.to(var.dtype), None, None, None,
                None)


class _ChainDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, out_dtype, interpret):
        from .. import ops

        ctx.save_for_backward(a, b, c)
        ctx.interpret = interpret
        return ops._chain_dense_raw(a, b, c, out_dtype, interpret)

    @staticmethod
    def backward(ctx, g):
        from .. import ops
        from ..core.enumerate import chain_matmul_spec

        a, b, c = ctx.saved_tensors
        m, k1 = a.shape
        spec = chain_matmul_spec(m, k1, b.shape[1], c.shape[1])
        with _annotate("chain_dense"):
            cots = _cotangent_gemms(
                spec, g, {"A": a, "B": b, "C": c}, interpret=ctx.interpret,
                use_kernel=ops._generic_kernel_ok(a, ctx.interpret),
                wrt=_wanted(ctx, ("A", "B", "C")),
            )
        return cots.get("A"), cots.get("B"), cots.get("C"), None, None


class _Grouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes, out_dtype, interpret):
        from .. import ops

        ctx.save_for_backward(x, w)
        ctx.group_sizes = group_sizes
        ctx.interpret = interpret
        return ops._grouped_raw(x, w, group_sizes, out_dtype, interpret)

    @staticmethod
    def backward(ctx, g):
        from .. import ops

        x, w = ctx.saved_tensors
        dx, dw = grouped_cotangents(
            x, w, g, ctx.group_sizes, interpret=ctx.interpret,
            use_kernel=bool(x.shape[0]) and ops._grouped_kernel_ok(
                x, ctx.interpret),
            need=ctx.needs_input_grad[:2])
        return dx, dw, None, None, None


def grouped_cotangents(x, w, g, sizes, *, interpret: bool, use_kernel: bool,
                       need=(True, True)):
    """(dX, dW) of the ragged grouped GEMM x (N, K), w (G, K, F), each
    None where ``need`` says so: on the kernel path ``grouped_matmul.dX``
    (B3's dX orientation) and ``.dW`` (B4); otherwise the per-group loop."""
    from ..codegen.fused_gen import _group_offsets
    from ..core.enumerate import grouped_matmul_spec

    need_x, need_w = need
    n, kdim = x.shape
    fdim = w.shape[2]
    dx = dw = None
    if use_kernel:
        dsp = derived_specs(grouped_matmul_spec(sizes, kdim, fdim))
        with _annotate("grouped"):
            if need_x:
                dx = apply_spec(
                    dsp["X"], {COTANGENT: g.to(x.dtype), "W": w},
                    out_dtype=x.dtype, interpret=interpret, use_kernel=True,
                )
            if need_w:
                dw = apply_spec(
                    dsp["W"], {COTANGENT: g.to(w.dtype), "X": x},
                    out_dtype=w.dtype, interpret=interpret, use_kernel=True,
                )
        return dx, dw
    # the per-group loop: an einsum here would sum over the group axis
    gf, xf = g.float(), x.float()
    if need_x:
        dx = torch.zeros((n, kdim), dtype=torch.float32, device=x.device)
    if need_w:
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for gi, (off, size) in enumerate(zip(_group_offsets(sizes), sizes)):
        if not size:
            continue  # empty group: zero dW slab, no dX rows
        rows = slice(off, off + size)
        if need_x:
            dx[rows] = gf[rows] @ w[gi].float().T
        if need_w:
            dw[gi] = xf[rows].T @ gf[rows]
    return (None if dx is None else dx.to(x.dtype),
            None if dw is None else dw.to(w.dtype))


# ---------------------------------------------------------------------------
# per-op factories (memoized => one wrapper per static config)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def dense_vjp(out_dtype: str, interpret: bool):
    """(M, D) @ (D, F) with backward dA/dB through derived-spec kernels."""
    dt = _torch_dtype(out_dtype)
    return lambda x, w: _Dense.apply(x, w, dt, interpret)


@functools.lru_cache(maxsize=None)
def batched_dense_vjp(out_dtype: str, interpret: bool):
    """(B, M, D) @ (B, D, F) with backward batched_matmul.dA/.dB."""
    dt = _torch_dtype(out_dtype)
    return lambda x, w: _BatchedDense.apply(x, w, dt, interpret)


@functools.lru_cache(maxsize=None)
def dense_transposed_vjp(out_dtype: str, interpret: bool):
    """(D, M)ᵀ @ (D, F) with backward transposed_matmul.dA/.dB."""
    dt = _torch_dtype(out_dtype)
    return lambda a, b: _DenseTransposed.apply(a, b, dt, interpret)


@functools.lru_cache(maxsize=None)
def grouped_vjp(group_sizes: tuple, out_dtype: str, interpret: bool):
    """Ragged grouped GEMM: the backward stays ragged.

    Both cotangents are GroupedSpecs with the same ``group_sizes``
    (``grouped_matmul.dX/.dW``): on the kernel path dX runs B3's dX
    orientation and dW kernel B4; otherwise both are the per-group loop.
    """
    dt = _torch_dtype(out_dtype)
    sizes = tuple(int(s) for s in group_sizes)
    return lambda x, w: _Grouped.apply(x, w, sizes, dt, interpret)


@functools.lru_cache(maxsize=None)
def weighted_dense_vjp(out_dtype: str, interpret: bool):
    """sum_j x_ij w_jk g_j with every cotangent a derived-spec contraction:
    ``weighted_matmul.dA``/``.dB`` (g scales an output column or row) and
    ``.dg``, a three-operand contraction over (i, k) producing a vector,
    each one B1 launch on the kernel path."""
    dt = _torch_dtype(out_dtype)
    return lambda x, w, g: _WeightedDense.apply(x, w, g, dt, interpret)


@functools.lru_cache(maxsize=None)
def dense_act_vjp(act: str, eps: float, out_dtype: str, interpret: bool):
    """Fused dense+bias+norm+act with an epilogue-aware backward: one B1
    launch recomputes the accumulator, torch autograd differentiates
    ``Epilogue.apply`` on it, and dacc goes through ``matmul.dA``/``.dB``
    (three B1 launches in all on the kernel path)."""
    dt = _torch_dtype(out_dtype)
    return lambda x, w, beta, mean, var: _DenseAct.apply(
        x, w, beta, mean, var, act, eps, dt, interpret)


@functools.lru_cache(maxsize=None)
def chain_dense_vjp(out_dtype: str, interpret: bool):
    """a @ b @ c with the three cotangents through the derived
    ``chain_matmul.dA``/``.dB``/``.dC`` specs, each a chain of three
    (transposed) matrices on B1's chain mode: one launch forward, three
    backward, on the kernel path."""
    dt = _torch_dtype(out_dtype)
    return lambda a, b, c: _ChainDense.apply(a, b, c, dt, interpret)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, causal, out_dtype, interpret):
        from .. import ops

        ctx.save_for_backward(q, k, v)
        ctx.kv_lengths = kv_lengths
        ctx.causal, ctx.interpret = causal, interpret
        return ops._attention_raw(q, k, v, causal=causal,
                                  kv_lengths=kv_lengths, out_dtype=out_dtype,
                                  interpret=interpret)

    @staticmethod
    def backward(ctx, g):
        from .. import ops

        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_cotangents(
            q, k, v, g, ctx.kv_lengths, causal=ctx.causal,
            interpret=ctx.interpret,
            use_kernel=ops._attention_kernel_ok(q, ctx.interpret),
            need=ctx.needs_input_grad[:3])
        return dq, dk, dv, None, None, None, None


def attention_cotangents(q, k, v, g, kv_lengths, *, causal: bool,
                         interpret: bool, use_kernel: bool,
                         need=(True, True, True)):
    """(dQ, dK, dV) of fused attention, each None where ``need`` says so:
    the forward kept no probabilities, so they are recomputed in f32 under
    the forward's masks (plain products, as the reference's einsums
    outside a kernel); a row with no visible column has P = 0, hence
    dS = 0.  The three GEMMs are the derived specs
    ``attention.dQ/.dK/.dV``, on B1 where ``use_kernel``."""
    from ..core.enumerate import attention_spec

    h, s, d = q.shape
    t, e = k.shape[1], v.shape[2]
    dsp = derived_specs(attention_spec(h, s, t, d, e=e, causal=causal))
    need_q, need_k, need_v = need
    scale = d ** -0.5
    dq = dk = dv = None
    with _annotate("attention"):
        big_p = attention_probs(q, k, causal=causal, kv_lengths=kv_lengths)
        if need_v:
            dv = apply_spec(
                dsp["V"], {COTANGENT: g.to(v.dtype), "P": big_p.to(v.dtype)},
                out_dtype=v.dtype, interpret=interpret,
                use_kernel=use_kernel)
        if need_q or need_k:
            dp = torch.matmul(g.float(), v.float().transpose(1, 2))
            dterm = (dp * big_p).sum(dim=-1, keepdim=True)
            ds = big_p * (dp - dterm) * scale
            del dp
            if need_q:
                dq = apply_spec(
                    dsp["Q"], {COTANGENT: ds.to(q.dtype), "K": k},
                    out_dtype=q.dtype, interpret=interpret,
                    use_kernel=use_kernel)
            if need_k:
                dk = apply_spec(
                    dsp["K"], {COTANGENT: ds.to(k.dtype), "Q": q},
                    out_dtype=k.dtype, interpret=interpret,
                    use_kernel=use_kernel)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def attention_vjp(causal: bool, out_dtype: str, interpret: bool):
    """Fused attention with a recompute backward.

    The forward (``ops._attention_raw``, one B2 launch) never stores the
    (s, t) probability matrix; the backward recomputes scores and P in
    f32, forms dS = P * (dP - D) * scale element-wise and routes the three
    GEMMs through the derived specs ``attention.dQ/.dK/.dV``, each one B1
    launch on the kernel path.  ``kv_lengths`` (None or an int32 tensor,
    one entry per head) masks the forward and the recompute alike.
    """
    dt = _torch_dtype(out_dtype)
    return lambda q, k, v, kv_lengths=None: _Attention.apply(
        q, k, v, kv_lengths, bool(causal), dt, interpret)
