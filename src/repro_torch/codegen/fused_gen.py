"""Fused-family lowering: the ragged grouped (MoE) matmul, kernel B3.

The reference's ``codegen/fused_gen.py`` lowers the two fused spec
families (``core.enumerate.AttentionSpec`` / ``GroupedSpec``) to Pallas
kernels.  The port lowers the grouped family's row mode, the forward

    out[n, f] = x[n, :] @ w[group(n), :, f]

and its dX orientation (``grouped_matmul.dX``: the shared axis is w's LAST
trailing axis, ``out[n, k] = dout[n, :] @ w[group(n), k, :]``), onto ONE
hand-written CUDA kernel, ``csrc/grouped.cu``: one CTA per (non-empty
group, 128-column block of the output), the group's row range read from a
device table of the non-empty groups, K streamed through shared memory
and the accumulator kept in f32.  The dX orientation is the same kernel
with w's two trailing strides swapped.

Devices decide, as for ``cuda_gen``: CUDA tensors launch the kernel (or
raise), CPU tensors run ``grouped_ref``, the plain per-group loop that
upcasts to f32 and stores in the kernel's dtype.  Group offsets are static:
they live on the spec (``group_sizes``), so the table is built once per
compiled kernel and device.  The plan fixes the operand shapes and the memo
key; the kernel takes its own grid, not the plan's blocks.

Still to port: the flash-attention kind (B2, ``_attention_fn``) and the
grouped dW mode (B4, ``_grouped_dw_fn``) raise ``NotImplementedError``.
``compile_fused`` keeps the reference's refusals of an epilogue and a mesh,
with its messages.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.enumerate import ContractionSpec
from ..core.schedule import Schedule
from .cuda_gen import _torch_dtype
from .plan import KernelPlan, build_plan

#: operand / output dtypes the kernel takes, with its dtype codes
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _group_offsets(group_sizes: Tuple[int, ...]) -> List[int]:
    offs, o = [], 0
    for s in group_sizes:
        offs.append(o)
        o += s
    return offs


def grouped_ref(x: torch.Tensor, w: torch.Tensor,
                group_sizes: Tuple[int, ...], *, out_dtype,
                contract_last: bool = False) -> torch.Tensor:
    """The plain PyTorch version: a per-group loop over f32 upcasts.

    ``x[rows of g] @ w[g]`` (``w[g].T`` with ``contract_last``, the dX
    orientation) for every non-empty group, accumulated in f32 and cast
    once to ``out_dtype``; rows of no group stay zero (there are none when
    the sizes sum to the row count).
    """
    n_out = w.shape[1] if contract_last else w.shape[2]
    out = torch.zeros((x.shape[0], n_out), dtype=torch.float32,
                      device=x.device)
    for g, (o, s) in enumerate(zip(_group_offsets(group_sizes),
                                   group_sizes)):
        if s:
            wg = w[g].float()
            out[o:o + s] = x[o:o + s].float() @ (wg.T if contract_last
                                                 else wg)
    return out.to(out_dtype)


class GroupedLauncher:
    """The ctypes wrapper of ``grouped_launch``; counts its launches.

    ``launches`` goes up by one for every kernel launch and for nothing
    else, so a run can show that its expert products went through B3.
    """

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _fn(self):
        if self._lib is None:
            from .build import load

            lib = load("grouped")
            lib.grouped_launch.argtypes = (
                [ctypes.c_int, ctypes.c_int]
                + [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 7
                + [ctypes.c_void_p]
            )
            lib.grouped_launch.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, x: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
                 max_rows: int, out_dtype: torch.dtype,
                 contract_last: bool = False) -> torch.Tensor:
        """x (rows, K) and w (G, K, N) (``(G, N, K)`` with
        ``contract_last``) -> new (rows, N) tensor.  ``table`` is the int32
        (n_live, 3) table of the non-empty groups (id, first row, rows) on
        x's device; ``max_rows`` its largest row count."""
        if x.device.type != "cuda" or w.device != x.device or (
            table.device != x.device
        ):
            raise ValueError(
                f"grouped kernel takes CUDA tensors on one device, got "
                f"{x.device}, {w.device} and table on {table.device}"
            )
        if x.dtype != w.dtype or x.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"grouped kernel takes two float32 or two bfloat16 "
                f"operands, got {x.dtype} and {w.dtype}"
            )
        if out_dtype not in _KERNEL_DTYPES:
            raise TypeError(f"grouped kernel writes float32 or bfloat16, "
                            f"not {out_dtype}")
        k_ax, n_ax = (2, 1) if contract_last else (1, 2)
        if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[k_ax]:
            raise ValueError(f"grouped kernel takes x (rows, K) and w with K "
                             f"on axis {k_ax}, got {tuple(x.shape)} and "
                             f"{tuple(w.shape)}")
        if table.dtype != torch.int32 or table.dim() != 2 or (
            table.shape[1] != 3 or not table.is_contiguous()
        ):
            raise ValueError("grouped kernel takes a contiguous int32 "
                             "(n_live, 3) group table")
        if min(x.stride()) < 0 or min(w.stride()) < 0:
            raise ValueError("grouped kernel takes non-negative strides")
        rows, k = x.shape
        n = w.shape[n_ax]
        n_live = table.shape[0]
        if n_live > _MAX_GRID_Y:
            raise ValueError(f"grouped kernel grid too large: {n_live} "
                             f"non-empty groups")
        if max(rows, n, k, *x.stride(), *w.stride()) >= 2**31:
            raise ValueError("grouped kernel takes extents and strides "
                             "below 2**31")
        out = torch.zeros((rows, n), dtype=out_dtype, device=x.device)
        if n_live == 0 or n == 0:
            return out
        lib = self._fn()
        rc = lib.grouped_launch(
            _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[out_dtype],
            x.data_ptr(), w.data_ptr(), out.data_ptr(), table.data_ptr(),
            n_live, max_rows, n, k,
            *x.stride(), w.stride(0), w.stride(k_ax), w.stride(n_ax),
            *out.stride(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"grouped kernel launch failed: "
                               f"cudaGetLastError() = {rc}")
        self.launches += 1
        return out


#: the process's one launcher; ``GROUPED.launches`` is the launch count
GROUPED = GroupedLauncher()


def group_table(group_sizes: Tuple[int, ...]) -> List[Tuple[int, int, int]]:
    """(group id, first row, rows) of every non-empty group, in order."""
    return [(g, o, s) for g, (o, s) in
            enumerate(zip(_group_offsets(group_sizes), group_sizes)) if s]


@dataclasses.dataclass
class FusedKernel:
    """A grouped-matmul kernel bound to one (spec, schedule) pair.

    Call with the operand tensors in ``spec.operands`` order, shaped as the
    plan's local extents.  CUDA tensors launch ``csrc/grouped.cu``; CPU
    tensors run ``grouped_ref``.
    """

    spec: ContractionSpec
    schedule: Schedule
    plan: KernelPlan
    out_dtype: Optional[torch.dtype]
    interpret: bool
    kind: str
    _tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        repr=False, default_factory=dict
    )

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.spec.operands)

    @property
    def contract_last(self) -> bool:
        """True for the dX orientation: the shared axis is w's last."""
        xname, wname = self.names
        c_ax = self.spec.operands[xname][1]
        return self.spec.operands[wname].index(c_ax) == 2

    def _table(self, device: torch.device) -> torch.Tensor:
        table = self._tables.get(device)
        if table is None:
            rows = group_table(tuple(self.spec.root().group_sizes))
            table = torch.tensor(rows, dtype=torch.int32,
                                 device=device).reshape(-1, 3)
            self._tables[device] = table
        return table

    def __call__(self, *arrays: torch.Tensor, kv_lengths=None):
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
        if kv_lengths is not None:
            raise TypeError("kv_lengths only applies to attention kernels")
        x, w = arrays
        out_dtype = self.out_dtype or x.dtype
        sizes = tuple(self.spec.root().group_sizes)
        devices = {arr.device.type for arr in arrays}
        if devices == {"cpu"}:
            return grouped_ref(x, w, sizes, out_dtype=out_dtype,
                               contract_last=self.contract_last)
        if devices == {"cuda"}:
            return GROUPED(x, w, self._table(x.device), max(sizes),
                           out_dtype, contract_last=self.contract_last)
        raise ValueError(f"{self.spec.name}: operands on {sorted(devices)}; "
                         f"all CPU (plain version) or all CUDA (kernel)")


def compile_fused(
    spec: ContractionSpec,
    schedule: Schedule,
    *,
    epilogue=None,
    out_dtype=None,
    interpret: bool = False,
    mesh=None,
) -> FusedKernel:
    """Lower a fused-family spec + Schedule; ``cuda_gen.compile_kernel``
    dispatches here whenever ``spec.root().fused_kind`` is set."""
    root = spec.root()
    kind = getattr(root, "fused_kind", "")
    if not kind:
        raise ValueError(f"{root.name} is not a fused spec")
    if epilogue is not None and not getattr(epilogue, "is_identity", False):
        raise NotImplementedError("fused kernels take no epilogue")
    if mesh is not None:
        raise NotImplementedError("fused families have no mesh tier yet")
    if kind == "attention":
        raise NotImplementedError(
            "fused attention (kernel B2, fused_gen._attention_fn) is not "
            "ported yet: ROADMAP.md queue A item 5"
        )
    if "g" in root.output:
        raise NotImplementedError(
            "grouped dW (kernel B4, fused_gen._grouped_dw_fn) is not ported "
            "yet: it comes with MoE training, ROADMAP.md queue A item 5"
        )
    from ..obs import span

    with span("codegen.compile_fused", spec=root.name, kind=kind):
        plan = build_plan(schedule)
        return FusedKernel(
            spec=plan.spec,
            schedule=schedule,
            plan=plan,
            out_dtype=None if out_dtype is None else _torch_dtype(out_dtype),
            interpret=interpret,
            kind=kind,
        )
