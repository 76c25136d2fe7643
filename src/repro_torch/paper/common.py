"""Shared helpers of the paper scripts; every script prints
``name,us_per_call,derived`` rows, as the reference's benchmarks do.

A variant runs through one of two executors: ``"execute"``
(``core.execute.execute_variant``: the outer loop levels on the host, one
einsum per innermost tail, ``TAILS.calls`` of them) or ``"lower"``
(``core.lower.contraction_to_torch``: every level a vmap or a sum, one
traced function).  Operands are float64, as in the paper and the
reference's scripts, and live on the device the script was given
(``device.resolve_device``: the card unless the CPU is asked for).
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.enumerate import ContractionSpec
from ..core.execute import TAILS, execute_variant
from ..core.lower import contraction_to_torch
from ..device import resolve_device

EXECUTORS = ("execute", "lower")

#: H100 SXM, dense: the f64 tensor cores' peak and HBM3's rate, for the
#: yardstick's bound
PEAK_F64 = 67e12
PEAK_BYTES = 3.35e12

#: the scripts' correctness check against ``torch.matmul``, as the
#: reference's ``np.allclose(out, ref, rtol=1e-8)``
RTOL, ATOL = 1e-8, 1e-8


def timeit(fn: Callable, device: torch.device, repeats: int = 3,
           warmup: int = 1) -> float:
    """Median seconds of ``fn()`` over ``repeats`` calls after ``warmup``.

    On a CUDA device each call is timed between two CUDA events on the
    current stream, so the time ends when the card finishes the call's
    work; on the CPU it is the host clock.
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def emit(name: str, seconds: float, derived: str = ""):
    print(f"{name},{seconds*1e6:.1f},{derived}", flush=True)


def spearman(a, b) -> float:
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean(); rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def operands(shapes: Dict[str, Tuple[int, ...]], seed: int,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """Standard-normal float64 operands drawn with numpy from ``seed`` in
    ``shapes`` order (the reference scripts' draw), on ``device``."""
    rng = np.random.default_rng(seed)
    return {name: torch.as_tensor(rng.standard_normal(shape)).to(device)
            for name, shape in shapes.items()}


def run_variant(spec: ContractionSpec, order: Sequence[str],
                arrays: Dict[str, torch.Tensor], executor: str
                ) -> torch.Tensor:
    if executor == "execute":
        return execute_variant(spec, order, arrays)
    if executor == "lower":
        names = spec.root().operands
        return contraction_to_torch(spec, order)(*(arrays[n] for n in names))
    raise ValueError(f"executor {executor!r} is not one of {EXECUTORS}")


def measure(spec: ContractionSpec, order: Sequence[str],
            arrays: Dict[str, torch.Tensor], ref: torch.Tensor,
            executor: str, device: torch.device, repeats: int = 3
            ) -> Tuple[float, int]:
    """(median seconds, einsum calls of one run) of a variant.

    The first run is the warm-up: its output is held against ``ref`` and
    its einsum calls counted (0 for the lowered form, which makes none);
    ``repeats`` timed runs follow."""
    TAILS.calls = 0
    out = run_variant(spec, order, arrays, executor)
    calls = TAILS.calls
    if not torch.allclose(out, ref, rtol=RTOL, atol=ATOL):
        err = (out - ref).abs().max().item()
        raise AssertionError(f"{spec.name} {'/'.join(order)} ({executor}) "
                             f"!= torch.matmul: max abs error {err}")
    del out
    seconds = timeit(lambda: run_variant(spec, order, arrays, executor),
                     device, repeats=repeats, warmup=0)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the lowered form's product is n^3
    return seconds, calls


def yardstick(a: torch.Tensor, b: torch.Tensor, device: torch.device
              ) -> Dict[str, float]:
    """``torch.matmul(a, b)``'s median seconds and the bound of the same
    product on an H100 SXM: max(2 x multiply-adds / f64 peak, operand and
    output bytes / HBM rate)."""
    out = torch.matmul(a, b)
    macs = a.numel() * (b.shape[-1] if b.dim() > 1 else 1)
    nbytes = (a.numel() + b.numel() + out.numel()) * a.element_size()
    return dict(matmul_s=timeit(lambda: torch.matmul(a, b), device),
                bound_s=max(2 * macs / PEAK_F64, nbytes / PEAK_BYTES))


def emit_yardstick(table: str, y: Dict[str, float]):
    emit(f"{table}.torch_matmul", y["matmul_s"],
         f"bound_us={y['bound_s'] * 1e6:.3f}")


def parse_args(description: str, **defaults) -> argparse.Namespace:
    """The scripts' shared flags: ``--device`` (``cuda``), ``--executor``
    and each size in ``defaults``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--executor", default="execute", choices=EXECUTORS)
    for name, value in defaults.items():
        ap.add_argument(f"--{name}", type=type(value), default=value)
    return ap.parse_args()
