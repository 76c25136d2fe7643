"""KernelPlan -> CUDA contraction kernel: the port's ``pallas_gen``.

The reference lowers a (spec, schedule) pair to a Pallas kernel whose grid
and blocks follow the ``KernelPlan``.  The port lowers every two-operand
product-reduce spec onto ONE hand-written Hopper kernel
(``csrc/contract.cu``), the strided batched contraction

    C[b, m, n] = sum_k A[b, m, k] * B[b, k, n]      (f32 accumulation)

by folding the spec's indices into four groups:

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

The plan still decides shapes (operand checks, the memo key), but not the
kernel's grid: the reference tuner scores a TPU and often picks a single
block, while the CUDA kernel tiles the output into its own CTAs (64 x 128
on the tensor cores for bf16 operands, 128 x 64 on the FMA pipes for f32).

Devices: on a CUDA tensor the call launches the kernel (or raises); on a
CPU tensor it runs ``contract_ref``, the plain PyTorch version.  Nothing
falls back from one to the other.  Fused specs (``fused_kind`` set) go to
``fused_gen.compile_fused`` (the grouped matmul, kernel B3).  Three-operand
specs, epilogues, int8/fp8 specs and meshes are later slices and raise
``NotImplementedError`` naming the ``ROADMAP.md`` queue-A item.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
from typing import Dict, Optional, Tuple

import torch

from ..core.enumerate import ContractionSpec, einsum_formula
from ..core.schedule import Schedule
from .cache import dtype_name
from .plan import KernelPlan, build_plan

#: operand / output dtypes the kernel takes, with its dtype codes
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype_name(dtype))


def contract_ref(spec: ContractionSpec, *operands: torch.Tensor,
                 out_dtype) -> torch.Tensor:
    """The plain PyTorch version: einsum over float32 upcasts, then cast."""
    formula = einsum_formula(spec)
    return torch.einsum(formula, *(o.float() for o in operands)).to(
        _torch_dtype(out_dtype)
    )


class ContractLauncher:
    """The ctypes wrapper of ``contract_launch``; counts its launches.

    ``launches`` goes up by one for every kernel launch and for nothing
    else, so a run can show that its GEMMs went through the kernel.
    """

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _fn(self):
        if self._lib is None:
            from .build import load

            lib = load("contract")
            lib.contract_launch.argtypes = (
                [ctypes.c_int, ctypes.c_int]
                + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 9
                + [ctypes.c_void_p]
            )
            lib.contract_launch.restype = ctypes.c_int
            lib.contract_tile_m.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
        """a (batch, M, K) @ b (batch, K, N) -> new (batch, M, N) tensor."""
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
        lib = self._fn()
        if batch > _MAX_GRID_YZ or -(-m // lib.contract_tile_m()) > _MAX_GRID_YZ:
            raise ValueError(f"contract kernel grid too large for batch "
                             f"{batch}, M {m}")
        if max(batch, m, n, k, *a.stride(), *b.stride()) >= 2**31:
            raise ValueError("contract kernel takes extents and strides "
                             "below 2**31")
        c = torch.empty((batch, m, n), dtype=out_dtype, device=a.device)
        if c.numel() == 0:
            return c
        rc = lib.contract_launch(
            _KERNEL_DTYPES[a.dtype], _KERNEL_DTYPES[out_dtype],
            a.data_ptr(), b.data_ptr(), c.data_ptr(),
            batch, m, n, k,
            *a.stride(), *b.stride(), *c.stride(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"contract kernel launch failed: "
                               f"cudaGetLastError() = {rc}")
        self.launches += 1
        return c


#: the process's one launcher; ``CONTRACT.launches`` is the launch count
CONTRACT = ContractLauncher()


def _groups(spec: ContractionSpec):
    (na, ia), (nb, ib) = spec.operands.items()
    out = spec.output
    batch = [i for i in out if i in ia and i in ib]
    m = [i for i in out if i in ia and i not in ib]
    n = [i for i in out if i in ib and i not in ia]
    k = [i for i in ia if i in ib and i not in out]
    return ia, ib, batch, m, n, k


def _launch_cuda(spec: ContractionSpec, a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype) -> torch.Tensor:
    ia, ib, batch, m, n, k = _groups(spec)
    ext = spec.extents
    a_only = [i for i in ia if i not in ib and i not in spec.output]
    b_only = [i for i in ib if i not in ia and i not in spec.output]
    if a_only or b_only:
        # summed out first, in f32 like the reference's single-operand sum
        a = a.float().sum(dim=[ia.index(i) for i in a_only]) if a_only else a
        b = b.float().sum(dim=[ib.index(i) for i in b_only]) if b_only else b
        ia = tuple(i for i in ia if i not in a_only)
        ib = tuple(i for i in ib if i not in b_only)
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
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
    c = CONTRACT(a3, b3, out_dtype).reshape([ext[i] for i in batch + m + n])
    produced = batch + m + n
    perm = [produced.index(i) for i in spec.output]
    if perm != list(range(len(perm))):
        c = c.permute(perm).contiguous()
    return c


@dataclasses.dataclass
class CompiledKernel:
    """A two-operand contraction bound to one (spec, schedule) pair.

    Call with the operand tensors in ``spec.operands`` order, shaped as the
    plan's local extents.  CUDA tensors launch ``csrc/contract.cu``; CPU
    tensors run ``contract_ref``.
    """

    spec: ContractionSpec
    schedule: Schedule
    plan: KernelPlan
    out_dtype: Optional[torch.dtype]
    interpret: bool

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
        if vectors:
            raise TypeError(f"no epilogue: unexpected vectors "
                            f"{sorted(vectors)}")
        out_dtype = self.out_dtype or arrays[0].dtype
        devices = {arr.device.type for arr in arrays}
        if devices == {"cpu"}:
            return contract_ref(self.spec, *arrays, out_dtype=out_dtype)
        if devices == {"cuda"}:
            return _launch_cuda(self.spec, *arrays, out_dtype=out_dtype)
        raise ValueError(f"{self.spec.name}: operands on {sorted(devices)}; "
                         f"all CPU (plain version) or all CUDA (kernel)")


def compile_kernel(
    spec: ContractionSpec,
    schedule: Schedule,
    *,
    epilogue=None,
    out_dtype=None,
    interpret: bool = False,
    mesh=None,
) -> CompiledKernel:
    """Compile a two-operand ContractionSpec + Schedule into a kernel.

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
    if epilogue is not None:
        raise NotImplementedError(
            "epilogues come with B1's remaining modes, ROADMAP.md queue A "
            "item 2"
        )
    if getattr(root, "quant", None) is not None:
        raise NotImplementedError(
            "int8/fp8 specs come with B1's remaining modes, ROADMAP.md "
            "queue A item 2"
        )
    if len(root.operands) != 2:
        raise NotImplementedError(
            f"{root.name}: {len(root.operands)}-operand specs (weighted, "
            f"chain, tensor) come with B1's remaining modes, ROADMAP.md "
            f"queue A item 2"
        )
    if root.reducer != "+":
        raise NotImplementedError(f"reducer {root.reducer!r}: the kernel "
                                  f"is a product-sum")
    from ..obs import span

    with span("codegen.compile", spec=root.name, sharded=False):
        plan = build_plan(schedule)
        return CompiledKernel(
            spec=plan.spec,
            schedule=schedule,
            plan=plan,
            out_dtype=None if out_dtype is None else _torch_dtype(out_dtype),
            interpret=interpret,
        )


_KERNEL_MEMO: Dict[tuple, CompiledKernel] = {}


def cached_compile(
    spec: ContractionSpec,
    schedule: Schedule,
    *,
    epilogue=None,
    out_dtype=None,
    interpret: bool = False,
    mesh=None,
) -> CompiledKernel:
    """compile_kernel memoized on (spec, schedule, dtype, interpret).

    Hot-path entry for ``ops``: repeated calls with the same contraction
    reuse one ``CompiledKernel``; feeds ``codegen.memo.hit/miss``.
    """
    from ..obs import counter
    from .cache import schedule_to_dict, spec_signature

    if epilogue is not None or mesh is not None:
        return compile_kernel(spec, schedule, epilogue=epilogue, mesh=mesh,
                              out_dtype=out_dtype, interpret=interpret)
    key = (
        json.dumps(spec_signature(spec), sort_keys=True),
        json.dumps(schedule_to_dict(schedule), sort_keys=True),
        dtype_name(out_dtype) if out_dtype is not None else None,
        interpret,
    )
    kern = _KERNEL_MEMO.get(key)
    counter(f"codegen.memo.{'miss' if kern is None else 'hit'}").inc()
    if kern is None:
        kern = compile_kernel(spec, schedule, out_dtype=out_dtype,
                              interpret=interpret)
        _KERNEL_MEMO[key] = kern
    return kern
