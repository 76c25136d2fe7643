"""KernelPlan -> CUDA contraction kernel: the port's ``pallas_gen``.

The reference lowers a (spec, schedule) pair to a Pallas kernel whose grid
and blocks follow the ``KernelPlan``.  The port lowers every product-reduce
spec it takes onto ONE hand-written Hopper kernel (``csrc/contract.cu``),
the strided batched contraction

    C[b, m, n] = sum_k A[b, m, k] * B[b, k, n]      (f32 accumulation)

by folding two operands' indices into four groups:

    batch  indices in A, B and the output
    m      output indices of A only
    n      output indices of B only
    k      reduce indices shared by A and B

A reduce index held by one operand only is summed out first (in f32, as
the reference's ``_contract`` sums it), the operands are passed as permuted
views with their strides (a copy only where a group of indices cannot be
flattened into one stride), and the (batch, m, n) result is permuted back
to ``spec.output`` order.  Matmul, transposed, batched and tensor
contractions all run on the same kernel.  A bf16 operand whose innermost
folded axis is not unit-stride (the backward's transposed operands) is
copied contiguous first, so the kernel takes its 16-byte load body.

Three-operand specs are classified by their index sets, not their names
(``_classify``), into the kernel's two extra modes, one launch each:

    vector      a 1-D operand whose index lies in a group of the other two's
                product: on k it scales the A tile as it is staged (in f32,
                rounded once to the operand type: the weighted spec
                A_ij B_jk g_j -> ik, paper eq 2); on batch, m or n it
                multiplies the accumulator in the epilogue (the derived
                ``weighted_matmul.dA`` and ``.dB``);
    row reduce  a third operand T holding the product's (m, n) indices and
                an output that is n alone: C[n] = sum_m (A.B)[m, n] T[m, n]
                (the derived ``weighted_matmul.dg``,
                dg_j = sum_i A_ij (dout . B^T)_ij), summed deterministically
                (per-CTA partial rows, then the last CTA of each column
                block adds them in order; no float atomics).

Any other spec of three or more operands (the chain A@B@C, two reductions)
raises ``NotImplementedError`` naming ROADMAP.md queue A item 2b.

The ``Epilogue`` (``codegen.epilogue``: scale, bias, normalization,
activation) runs on the f32 accumulator before the one store; its vectors
run along ``spec.output[-1]``, which the kernel finds in whichever folded
group (batch, m or n) holds it.  ``CompiledKernel.__call__`` takes them by
keyword, as the reference's does.  The output dtype follows the
reference's rule (``pallas_gen.py:249-261``): ``out_dtype`` when given,
else the first operand's.

The plan still decides shapes (operand checks, the memo key), but not the
kernel's grid: the reference tuner scores a TPU and often picks a single
block, while the CUDA kernel tiles the output into its own CTAs (64 x 128
on the tensor cores for bf16 operands, 128 x 64 on the FMA pipes for f32).

Devices: on a CUDA tensor the call launches the kernel (or raises); on a
CPU tensor it runs ``contract_ref``, the plain PyTorch version.  Nothing
falls back from one to the other.  Fused specs (``fused_kind`` set) go to
``fused_gen.compile_fused`` (the grouped matmul, kernels B3 and B4).
Int8/fp8 specs and meshes are later slices and raise
``NotImplementedError`` naming the ``ROADMAP.md`` queue-A item.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.enumerate import ContractionSpec, einsum_formula
from ..core.schedule import Schedule
from .cache import dtype_name
from .epilogue import ACT_CODES, Epilogue
from .plan import KernelPlan, build_plan

#: operand / output dtypes the kernel takes, with its dtype codes
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype_name(dtype))


def _einsum_f32(spec: ContractionSpec, operands) -> torch.Tensor:
    """The spec's product-sum over f32 upcasts.  A three-operand spec (only
    ``_classify``'s weighted family is taken) folds its third operand as
    the reference's ``_contract`` does, never through an (i, j, k)
    intermediate: a vector multiplies the operand that holds its index; a
    row reduce forms the product of the other two on T's indices, then
    multiplies by T and sums."""
    arrays = {name: o.float() for name, o in zip(spec.operands, operands)}
    if len(arrays) <= 2:
        return torch.einsum(einsum_formula(spec), *arrays.values())
    fold = _classify(spec)
    ops = spec.operands
    letters = {i: chr(ord("a") + n) for n, i in enumerate(spec.root().indices)}
    sub = lambda axes: "".join(letters[i] for i in axes)  # noqa: E731
    extra = arrays.pop(fold.extra)
    if fold.kind == "vector":
        (j,) = ops[fold.extra]
        x = fold.a if j in ops[fold.a] else fold.b
        arrays[x] = arrays[x] * extra.reshape(
            [spec.extents[j] if i == j else 1 for i in ops[x]])
    a, b = arrays[fold.a], arrays[fold.b]
    ia, ib = sub(ops[fold.a]), sub(ops[fold.b])
    if fold.kind == "vector":
        return torch.einsum(f"{ia},{ib}->{sub(spec.output)}", a, b)
    it = sub(fold.target)
    prod = torch.einsum(f"{ia},{ib}->{it}", a, b)
    return torch.einsum(f"{it},{it}->{sub(spec.output)}", prod, extra)


def contract_ref(spec: ContractionSpec, *operands: torch.Tensor,
                 out_dtype, epilogue: Optional[Epilogue] = None,
                 vectors: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """The plain PyTorch version: the product-sum over float32 upcasts
    (a three-operand spec's third operand folded first),
    then the epilogue with its vectors along the last output axis, then
    the cast."""
    acc = _einsum_f32(spec, operands)
    if epilogue is not None and not epilogue.is_identity:
        lead = (1,) * (len(spec.output) - 1)
        acc = epilogue.apply(acc, {
            name: vectors[name].float().reshape(lead + (-1,))
            for name in epilogue.vector_names
        })
    return acc.to(_torch_dtype(out_dtype))


class _Vec(ctypes.Structure):
    """``struct Vec`` of contract.cu."""

    _fields_ = [("p", ctypes.c_void_p), ("div", ctypes.c_longlong),
                ("len", ctypes.c_longlong), ("axis", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _Params(ctypes.Structure):
    """``struct ContractParams`` of contract.cu, field for field."""

    _fields_ = (
        [("A", ctypes.c_void_p), ("B", ctypes.c_void_p),
         ("C", ctypes.c_void_p)]
        + [(f, ctypes.c_longlong) for f in (
            "batch", "M", "N", "K", "sAb", "sAm", "sAk", "sBb", "sBk", "sBn",
            "sCb", "sCm", "sCn")]
        + [(f, _Vec) for f in ("kscale", "mul", "scale", "bias", "mean",
                               "var")]
        + [("T", ctypes.c_void_p), ("sTm", ctypes.c_longlong),
           ("sTn", ctypes.c_longlong), ("partial", ctypes.c_void_p),
           ("counter", ctypes.c_void_p), ("eps", ctypes.c_float),
           ("act", ctypes.c_int), ("in_dtype", ctypes.c_int),
           ("out_dtype", ctypes.c_int)]
    )


class VecArg(NamedTuple):
    """A vector operand of the kernel: element ``(coord // div) % len`` of
    ``tensor`` (f32, contiguous, on the card) scales or shifts the output
    at folded coordinate ``coord`` of ``axis`` (0 batch, 1 m, 2 n, 3 k)."""

    tensor: torch.Tensor
    axis: int
    div: int = 1


class ContractLauncher:
    """The ctypes wrapper of ``contract_launch``; counts its launches.

    ``launches`` goes up by one for every kernel launch and for nothing
    else, so a run can show that its GEMMs went through the kernel.
    """

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._tiles = {}  # dtype code -> (CTA rows, CTA columns)

    def _fn(self):
        if self._lib is None:
            from .build import load

            lib = load("contract")
            lib.contract_launch.argtypes = [ctypes.POINTER(_Params),
                                            ctypes.c_void_p]
            lib.contract_launch.restype = ctypes.c_int
            for fn in (lib.contract_tile_m, lib.contract_tile_n):
                fn.argtypes = [ctypes.c_int]
                fn.restype = ctypes.c_int
            lib.contract_params_size.restype = ctypes.c_int
            if lib.contract_params_size() != ctypes.sizeof(_Params):
                raise RuntimeError(
                    f"contract.cu's ContractParams is "
                    f"{lib.contract_params_size()} bytes, its ctypes mirror "
                    f"{ctypes.sizeof(_Params)}"
                )
            self._lib = lib
        return self._lib

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype, *, kscale: Optional[VecArg] = None,
                 mul: Optional[VecArg] = None,
                 epilogue: Optional[Epilogue] = None,
                 vectors: Optional[Dict[str, VecArg]] = None,
                 t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """a (batch, M, K) @ b (batch, K, N) -> new (batch, M, N) tensor.

        ``kscale`` scales A along k as it is staged; ``mul`` and the
        ``epilogue`` with its ``vectors`` act on the accumulator before the
        store.  With ``t`` (M, N) (batch 1) the result is instead the (N,)
        vector ``sum_m (a @ b)[m, n] * t[m, n]``.
        """
        if a.device.type != "cuda" or b.device != a.device:
            raise ValueError(
                f"contract kernel takes CUDA tensors on one device, got "
                f"{a.device} and {b.device}"
            )
        if a.dtype != b.dtype or a.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"contract kernel takes two float32 or two bfloat16 "
                f"operands, got {a.dtype} and {b.dtype}"
            )
        if out_dtype not in _KERNEL_DTYPES:
            raise TypeError(f"contract kernel writes float32 or bfloat16, "
                            f"not {out_dtype}")
        if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or (
            a.shape[2] != b.shape[1]
        ):
            raise ValueError(f"contract kernel takes (batch, M, K) and "
                             f"(batch, K, N), got {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
        if min(a.stride()) < 0 or min(b.stride()) < 0:
            raise ValueError("contract kernel takes non-negative strides")
        batch, m, k = a.shape
        n = b.shape[2]
        code = _KERNEL_DTYPES[a.dtype]
        lib = self._fn()
        if code not in self._tiles:
            self._tiles[code] = (lib.contract_tile_m(code),
                                 lib.contract_tile_n(code))
        tile_m, tile_n = self._tiles[code]
        if batch > _MAX_GRID_YZ or -(-m // tile_m) > _MAX_GRID_YZ:
            raise ValueError(f"contract kernel grid too large for batch "
                             f"{batch}, M {m}")
        if max(batch, m, n, k, *a.stride(), *b.stride()) >= 2**31:
            raise ValueError("contract kernel takes extents and strides "
                             "below 2**31")
        p = _Params(A=a.data_ptr(), B=b.data_ptr(), batch=batch, M=m, N=n,
                    K=k, in_dtype=code, out_dtype=_KERNEL_DTYPES[out_dtype])
        p.sAb, p.sAm, p.sAk = a.stride()
        p.sBb, p.sBk, p.sBn = b.stride()
        extents = (batch, m, n, k)
        for field, vec in (("kscale", kscale), ("mul", mul),
                           *(((name, v) for name, v in
                              (vectors or {}).items()))):
            if vec is None:
                continue
            x = vec.tensor
            if x.device != a.device or x.dtype != torch.float32 or (
                x.dim() != 1 or not x.is_contiguous()
            ):
                raise ValueError(f"contract kernel: vector {field} must be a "
                                 f"contiguous 1-D float32 tensor on "
                                 f"{a.device}")
            axes = (3,) if field == "kscale" else (0, 1, 2)
            if vec.axis not in axes or vec.div < 1 or x.numel() < 1 or (
                x.numel() * vec.div > max(extents[vec.axis], 1)
            ):
                raise ValueError(f"contract kernel: vector {field} of "
                                 f"{x.numel()} elements (div {vec.div}) does "
                                 f"not fit axis {vec.axis}")
            setattr(p, field, _Vec(p=x.data_ptr(), div=vec.div,
                                   len=x.numel(), axis=vec.axis))
        if epilogue is not None:
            want = set(epilogue.vector_names)
            if want != set(vectors or {}):
                raise TypeError(f"contract kernel: epilogue vectors "
                                f"{sorted(vectors or {})}, expected "
                                f"{sorted(want)}")
            p.act = ACT_CODES[epilogue.act]
            p.eps = epilogue.eps
        if t is not None:
            if batch != 1 or tuple(t.shape) != (m, n) or t.dtype != a.dtype or (
                t.device != a.device or min(t.stride()) < 0
            ):
                raise ValueError(f"contract kernel: row reduce takes batch 1 "
                                 f"and t ({m}, {n}) {a.dtype} on {a.device}, "
                                 f"got batch {batch}, t {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device}")
            if epilogue is not None or mul is not None or kscale is not None:
                raise ValueError("contract kernel: row reduce takes no "
                                 "epilogue and no vector")
            c = torch.empty((n,), dtype=out_dtype, device=a.device)
            if n == 0:
                return c
            if m == 0:  # no row blocks: an empty sum
                return c.zero_()
            partial = torch.empty((-(-m // tile_m), n), dtype=torch.float32,
                                  device=a.device)
            counter = torch.zeros(-(-n // tile_n), dtype=torch.int32,
                                  device=a.device)
            p.T, p.partial, p.counter = (t.data_ptr(), partial.data_ptr(),
                                         counter.data_ptr())
            p.sTm, p.sTn = t.stride()
            p.sCn = c.stride(0)
        else:
            c = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
            if c.numel() == 0:
                return c
            p.sCb, p.sCm, p.sCn = c.stride()
        p.C = c.data_ptr()
        rc = lib.contract_launch(
            ctypes.byref(p), torch.cuda.current_stream(a.device).cuda_stream
        )
        if rc != 0:
            raise RuntimeError(f"contract kernel launch failed: "
                               f"cudaGetLastError() = {rc}")
        self.launches += 1
        return c


#: the process's one launcher; ``CONTRACT.launches`` is the launch count
CONTRACT = ContractLauncher()


def _fold(ia, ib, out):
    """(batch, m, n, k) index groups of the product of operands with
    indices ``ia`` and ``ib`` into ``out``."""
    batch = [i for i in out if i in ia and i in ib]
    m = [i for i in out if i in ia and i not in ib]
    n = [i for i in out if i in ib and i not in ia]
    k = [i for i in ia if i in ib and i not in out]
    return batch, m, n, k


def _two_sided(ia, ib, out) -> bool:
    """Every reduce index of the pair is shared by both, and every ``out``
    index comes from one of them."""
    return (all(i in ib or i in out for i in ia)
            and all(i in ia or i in out for i in ib)
            and all(i in ia or i in ib for i in out))


@dataclasses.dataclass(frozen=True)
class Fold:
    """How a spec reaches the kernel: ``a`` and ``b`` are the GEMM's
    operands, folded into ``target`` (the spec's output, or T's indices
    for a row reduce); ``extra`` is the vector or T."""

    kind: str                   # "gemm" | "vector" | "row_reduce"
    a: str
    b: str
    target: Tuple[str, ...]
    extra: Optional[str] = None


def _classify(spec: ContractionSpec) -> Fold:
    """Map a root spec onto one of the kernel's modes by its index sets."""
    ops, out = spec.operands, spec.output
    names = list(ops)
    if len(names) == 2:
        return Fold("gemm", names[0], names[1], out)
    if len(names) == 3:
        for z in names:  # a 1-D operand on a group of the others' product
            x, y = [name for name in names if name != z]
            if len(ops[z]) == 1 and _two_sided(ops[x], ops[y], out) and (
                ops[z][0] in ops[x] or ops[z][0] in ops[y]
            ):
                return Fold("vector", x, y, out, z)
        for t in names:  # T holds the product's indices; out is one side
            x, y = [name for name in names if name != t]
            it = ops[t]
            if not set(out) <= set(it) or not _two_sided(ops[x], ops[y], it):
                continue
            batch, m, n, _ = _fold(ops[x], ops[y], it)
            if batch:
                continue
            if tuple(n) == tuple(out):
                return Fold("row_reduce", x, y, it, t)
            if tuple(m) == tuple(out):
                return Fold("row_reduce", y, x, it, t)
    raise NotImplementedError(
        f"{spec.name}: {len(names)}-operand specs outside the weighted "
        f"family (the chain A@B@C, two reductions) come with B1's chain "
        f"mode, ROADMAP.md queue A item 2b"
    )


def _group_of(index, batch, m, n, k, ext) -> Tuple[int, int]:
    """(axis code, div) of ``index`` within the folded groups."""
    for axis, group in enumerate((batch, m, n, k)):
        if index in group:
            pos = group.index(index)
            return axis, math.prod(ext[i] for i in group[pos + 1:])
    raise AssertionError(f"index {index} in no folded group")


def _launch_cuda(spec: ContractionSpec, *operands: torch.Tensor,
                 out_dtype: torch.dtype, epilogue: Optional[Epilogue] = None,
                 vectors: Optional[Dict[str, torch.Tensor]] = None,
                 fold: Optional[Fold] = None) -> torch.Tensor:
    """Fold the spec onto the kernel (``fold``: ``_classify``'s, computed
    here when not given), launch it once and unfold the result."""
    fold = fold or _classify(spec)
    arrays = dict(zip(spec.operands, operands))
    ext = spec.extents
    a, b = arrays[fold.a], arrays[fold.b]
    ia, ib = spec.operands[fold.a], spec.operands[fold.b]
    target = fold.target
    if fold.kind == "gemm":
        a_only = [i for i in ia if i not in ib and i not in target]
        b_only = [i for i in ib if i not in ia and i not in target]
        if a_only or b_only:
            # summed out first, in f32 like the reference's single-operand
            # sum
            a = (a.float().sum(dim=[ia.index(i) for i in a_only])
                 if a_only else a)
            b = (b.float().sum(dim=[ib.index(i) for i in b_only])
                 if b_only else b)
            ia = tuple(i for i in ia if i not in a_only)
            ib = tuple(i for i in ib if i not in b_only)
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    batch, m, n, k = _fold(ia, ib, target)
    size = lambda idx: math.prod(ext[i] for i in idx)  # noqa: E731
    a3 = a.permute([ia.index(i) for i in batch + m + k]).reshape(
        size(batch), size(m), size(k)
    )
    b3 = b.permute([ib.index(i) for i in batch + k + n]).reshape(
        size(batch), size(k), size(n)
    )
    if a3.dtype == torch.bfloat16:
        # the bf16 body loads 16 bytes at a time only where A is k-major
        # and B n-major; a transposed operand (the backward's W of
        # matmul.dA, x of matmul.dB) is copied so once instead of loaded
        # element by element
        if a3.stride(2) != 1:
            a3 = a3.contiguous()
        if b3.stride(2) != 1:
            b3 = b3.contiguous()
    if fold.kind == "row_reduce":
        it = spec.operands[fold.extra]
        t = arrays[fold.extra].to(a3.dtype)
        t2 = t.permute([it.index(i) for i in m + n]).reshape(size(m), size(n))
        return CONTRACT(a3, b3, out_dtype, t=t2).reshape(
            [ext[i] for i in spec.output])
    groups = (batch, m, n, k)
    kw = {}
    if fold.kind == "vector":
        (j,) = spec.operands[fold.extra]
        axis, div = _group_of(j, *groups, ext)
        vec = VecArg(arrays[fold.extra].float().reshape(-1).contiguous(),
                     axis, div)
        kw["kscale" if axis == 3 else "mul"] = vec
    if epilogue is not None and not epilogue.is_identity:
        last = spec.output[-1]
        axis, div = _group_of(last, *groups, ext)
        vecs = {}
        for name in epilogue.vector_names:
            v = vectors[name].float().reshape(-1).contiguous()
            if v.numel() != ext[last]:
                raise ValueError(f"epilogue vector {name}: {v.numel()} "
                                 f"elements for output axis {last!r} of "
                                 f"extent {ext[last]}")
            vecs[name] = VecArg(v, axis, div)
        kw.update(epilogue=epilogue, vectors=vecs)
    c = CONTRACT(a3, b3, out_dtype, **kw).reshape(
        [ext[i] for i in batch + m + n])
    produced = batch + m + n
    perm = [produced.index(i) for i in spec.output]
    if perm != list(range(len(perm))):
        c = c.permute(perm).contiguous()
    return c


@dataclasses.dataclass
class CompiledKernel:
    """A contraction bound to one (spec, schedule) pair.

    Call with the operand tensors in ``spec.operands`` order, shaped as the
    plan's local extents; epilogue vectors (scale/bias/mean/var) go by
    keyword.  CUDA tensors launch ``csrc/contract.cu``; CPU tensors run
    ``contract_ref``.
    """

    spec: ContractionSpec
    schedule: Schedule
    plan: KernelPlan
    out_dtype: Optional[torch.dtype]
    interpret: bool
    epilogue: Optional[Epilogue] = None
    fold: Optional[Fold] = None

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.spec.operands)

    def __call__(self, *arrays: torch.Tensor, **vectors) -> torch.Tensor:
        names = self.names
        if len(arrays) != len(names):
            raise TypeError(
                f"{self.spec.name} takes {len(names)} operands "
                f"{names}, got {len(arrays)}"
            )
        for name, arr in zip(names, arrays):
            want = tuple(
                self.plan.axes[i].local_extent
                for i in self.spec.operands[name]
            )
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"operand {name}: expected local shape {want}, "
                    f"got {tuple(arr.shape)}"
                )
        vec_names = self.epilogue.vector_names if self.epilogue else ()
        missing = set(vec_names) - set(vectors)
        if missing:
            raise TypeError(f"epilogue vectors missing: {sorted(missing)}")
        extra = set(vectors) - set(vec_names)
        if extra:
            raise TypeError(f"unexpected epilogue vectors {sorted(extra)} "
                            f"(the epilogue takes {list(vec_names)})")
        out_dtype = self.out_dtype or arrays[0].dtype
        tensors: List[torch.Tensor] = list(arrays) + [vectors[v]
                                                      for v in vec_names]
        devices = {x.device.type for x in tensors}
        if devices == {"cpu"}:
            return contract_ref(self.spec, *arrays, out_dtype=out_dtype,
                                epilogue=self.epilogue, vectors=vectors)
        if devices == {"cuda"}:
            return _launch_cuda(self.spec, *arrays, out_dtype=out_dtype,
                                epilogue=self.epilogue, vectors=vectors,
                                fold=self.fold)
        raise ValueError(f"{self.spec.name}: operands on {sorted(devices)}; "
                         f"all CPU (plain version) or all CUDA (kernel)")


def compile_kernel(
    spec: ContractionSpec,
    schedule: Schedule,
    *,
    epilogue: Optional[Epilogue] = None,
    out_dtype=None,
    interpret: bool = False,
    mesh=None,
) -> CompiledKernel:
    """Compile a ContractionSpec + Schedule into a kernel.

    ``spec`` may be the root spec or the schedule's own (subdivided) spec;
    they must share a root.  ``interpret`` keeps its reference meaning at
    the ``ops`` level (eligibility off the device rule); the kernel itself
    is chosen by the operands' device.
    """
    root = spec.root()
    if root is not schedule.spec.root() and (
        root.operands != schedule.spec.root().operands
        or root.extents != schedule.spec.root().extents
    ):
        raise ValueError("spec and schedule disagree on the root contraction")
    if getattr(root, "fused_kind", ""):
        from .fused_gen import compile_fused

        return compile_fused(spec, schedule, epilogue=epilogue,
                             out_dtype=out_dtype, interpret=interpret,
                             mesh=mesh)
    if mesh is not None:
        raise NotImplementedError(
            "mesh-bound kernels come with the mesh tier, ROADMAP.md queue A "
            "item 6"
        )
    if epilogue is not None and not isinstance(epilogue, Epilogue):
        raise TypeError(f"epilogue must be a codegen.Epilogue, got "
                        f"{type(epilogue).__name__}")
    if getattr(root, "quant", None) is not None:
        raise NotImplementedError(
            "int8/fp8 specs come with B1's int8/fp8 modes, ROADMAP.md "
            "queue A item 2b"
        )
    if root.reducer != "+":
        raise NotImplementedError(f"reducer {root.reducer!r}: the kernel "
                                  f"is a product-sum")
    fold = _classify(root)
    if fold.kind == "row_reduce" and epilogue is not None and (
        not epilogue.is_identity
    ):
        raise NotImplementedError(
            f"{root.name}: the row-reduce mode sums across CTAs after the "
            f"product and takes no epilogue"
        )
    from ..obs import span

    with span("codegen.compile", spec=root.name, sharded=False):
        plan = build_plan(schedule)
        return CompiledKernel(
            spec=plan.spec,
            schedule=schedule,
            plan=plan,
            out_dtype=None if out_dtype is None else _torch_dtype(out_dtype),
            interpret=interpret,
            epilogue=epilogue,
            fold=fold,
        )


_KERNEL_MEMO: Dict[tuple, CompiledKernel] = {}


def cached_compile(
    spec: ContractionSpec,
    schedule: Schedule,
    *,
    epilogue: Optional[Epilogue] = None,
    out_dtype=None,
    interpret: bool = False,
    mesh=None,
) -> CompiledKernel:
    """compile_kernel memoized on (spec, schedule, epilogue, dtype,
    interpret).

    Hot-path entry for ``ops``: repeated calls with the same contraction
    reuse one ``CompiledKernel``; feeds ``codegen.memo.hit/miss``.
    """
    from ..obs import counter
    from .cache import schedule_to_dict, spec_signature

    if mesh is not None:
        return compile_kernel(spec, schedule, epilogue=epilogue, mesh=mesh,
                              out_dtype=out_dtype, interpret=interpret)
    key = (
        json.dumps(spec_signature(spec), sort_keys=True),
        json.dumps(schedule_to_dict(schedule), sort_keys=True),
        epilogue,
        dtype_name(out_dtype) if out_dtype is not None else None,
        interpret,
    )
    kern = _KERNEL_MEMO.get(key)
    counter(f"codegen.memo.{'miss' if kern is None else 'hit'}").inc()
    if kern is None:
        kern = compile_kernel(spec, schedule, epilogue=epilogue,
                              out_dtype=out_dtype, interpret=interpret)
        _KERNEL_MEMO[key] = kern
    return kern
