"""The ctypes wrapper of ``codegen/csrc/baselines.cu`` (kernels B5-B7).

One library holds the three hand-written kernels; each has its own
``BaselineLauncher`` with its own ``launches`` count (``MATMUL``,
``FUSED_DENSE_ACT``, ``FUSED_RNZ``), which goes up by one for every launch
of that kernel and for nothing else.  A launcher takes CUDA tensors only:
the CPU path is each kernel module's plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..codegen.epilogue import ACT_CODES

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: B6's activations (no silu, as the reference's kernel); baselines.cu
#: shares contract.cu's codes for them
B6_ACTS = ("relu", "gelu", "tanh", "id")
_MAX_GRID_Y = 65535
_lock = threading.Lock()
_lib = None


class _Params(ctypes.Structure):
    """``struct BaselineParams`` of baselines.cu, field for field."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("A", "B", "C", "g", "beta", "mean",
                                        "var")]
        + [(f, ctypes.c_longlong) for f in ("M", "N", "K")]
        + [("eps", ctypes.c_float)]
        + [(f, ctypes.c_int) for f in ("act", "kind", "in_dtype",
                                       "out_dtype", "pad")]
    )


def _library():
    global _lib
    with _lock:
        if _lib is None:
            from ..codegen.build import load

            lib = load("baselines")
            lib.baseline_launch.argtypes = [ctypes.POINTER(_Params),
                                            ctypes.c_void_p]
            lib.baseline_launch.restype = ctypes.c_int
            lib.baseline_tile_m.argtypes = [ctypes.c_int]
            lib.baseline_tile_m.restype = ctypes.c_int
            lib.baseline_params_size.restype = ctypes.c_int
            if lib.baseline_params_size() != ctypes.sizeof(_Params):
                raise RuntimeError(
                    f"baselines.cu's BaselineParams is "
                    f"{lib.baseline_params_size()} bytes, its ctypes mirror "
                    f"{ctypes.sizeof(_Params)}"
                )
            _lib = lib
        return _lib


class BaselineLauncher:
    """One kernel of baselines.cu: ``kind`` 0 matmul (B5), 1
    fused_dense_act (B6), 2 weighted_matmul (B7)."""

    def __init__(self, name: str, kind: int):
        self.name = name
        self.kind = kind
        self.launches = 0

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype, *, g: Optional[torch.Tensor] = None,
                 beta: Optional[torch.Tensor] = None,
                 mean: Optional[torch.Tensor] = None,
                 var: Optional[torch.Tensor] = None, act: str = "id",
                 eps: float = 0.0) -> torch.Tensor:
        """a (M, K) @ b (K, N) -> new (M, N) tensor, with B7's ``g`` (K,)
        prologue or B6's (N,) ``beta``/``mean``/``var`` epilogue."""
        operands = [a, b] + [v for v in (g, beta, mean, var) if v is not None]
        if any(x.device.type != "cuda" or x.device != a.device
               for x in operands):
            raise ValueError(f"{self.name} kernel takes CUDA tensors on one "
                             f"device, got "
                             f"{sorted({str(x.device) for x in operands})}")
        if a.dtype != b.dtype or a.dtype not in _KERNEL_DTYPES or (
            g is not None and g.dtype != a.dtype
        ):
            raise TypeError(
                f"{self.name} kernel takes float32 or bfloat16 operands of "
                f"one dtype, got {a.dtype}, {b.dtype}"
                + ("" if g is None else f" and g {g.dtype}")
            )
        if out_dtype not in _KERNEL_DTYPES:
            raise TypeError(f"{self.name} kernel writes float32 or bfloat16, "
                            f"not {out_dtype}")
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"{self.name} kernel takes (M, K) and (K, N), "
                             f"got {tuple(a.shape)} and {tuple(b.shape)}")
        m, k = a.shape
        n = b.shape[1]
        if (self.kind == 2) != (g is not None) or (self.kind == 1) != (
            beta is not None and mean is not None and var is not None
        ):
            raise TypeError(f"{self.name} kernel: wrong vector operands")
        if g is not None and tuple(g.shape) != (k,):
            raise ValueError(f"{self.name} kernel: g must be ({k},), got "
                             f"{tuple(g.shape)}")
        if max(m, n, k) >= 2**31:
            raise ValueError(f"{self.name} kernel takes extents below 2**31")
        code = _KERNEL_DTYPES[a.dtype]
        lib = _library()
        if -(-m // lib.baseline_tile_m(code)) > _MAX_GRID_Y:
            raise ValueError(f"{self.name} kernel grid too large for M {m}")
        a, b = a.contiguous(), b.contiguous()
        p = _Params(A=a.data_ptr(), B=b.data_ptr(), M=m, N=n, K=k,
                    kind=self.kind, in_dtype=code,
                    out_dtype=_KERNEL_DTYPES[out_dtype])
        if g is not None:
            g = g.contiguous()
            p.g = g.data_ptr()
        if self.kind == 1:
            rows = []
            for name, v in (("beta", beta), ("mean", mean), ("var", var)):
                v = v.float().reshape(-1).contiguous()
                if v.numel() != n:
                    raise ValueError(f"{self.name} kernel: {name} must have "
                                     f"{n} elements, got {v.numel()}")
                rows.append(v)
                setattr(p, name, v.data_ptr())
            if act not in B6_ACTS:
                raise ValueError(f"{self.name} kernel: unknown activation "
                                 f"{act!r}; have {sorted(B6_ACTS)}")
            p.act, p.eps = ACT_CODES[act], eps
        c = torch.empty((m, n), dtype=out_dtype, device=a.device)
        if c.numel() == 0:
            return c
        p.C = c.data_ptr()
        rc = lib.baseline_launch(
            ctypes.byref(p), torch.cuda.current_stream(a.device).cuda_stream
        )
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaGetLastError() = {rc}")
        self.launches += 1
        return c


MATMUL = BaselineLauncher("matmul", 0)
FUSED_DENSE_ACT = BaselineLauncher("fused_dense_act", 1)
FUSED_RNZ = BaselineLauncher("weighted_matmul", 2)
