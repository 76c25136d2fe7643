"""repro_torch.codegen — schedule-driven kernel generation for Hopper.

The reference compiles a ``ContractionSpec`` + ``Schedule`` into a Pallas
kernel.  The port keeps the pure half unchanged (``plan.build_plan``,
``schedules.default_schedule``, the tuner and its persistent cache, with
the reference's key format) and lowers every two-operand contraction onto
one hand-written CUDA kernel, ``csrc/contract.cu`` (``cuda_gen``), which
also runs the epilogue (``epilogue.Epilogue``) and the weighted
three-operand family; the grouped (MoE) fused family lowers onto ``csrc/grouped.cu`` (forward and
dX) and ``csrc/grouped_dw.cu`` (dW) (``fused_gen``).  All are built by
``nvcc`` at first use (``build``).

Entry point::

    from repro_torch import codegen
    kernel = codegen.compile(spec, schedule)
    out = kernel(A, B)      # CUDA tensors: the kernel; CPU: contract_ref
"""

from .cache import (
    AutotuneCache,
    cache_key,
    default_cache,
    dtype_name,
    hardware_fingerprint,
    schedule_from_dict,
    schedule_to_dict,
)
from .cuda_gen import (
    CONTRACT,
    CompiledKernel,
    cached_compile,
    compile_kernel,
    contract_ref,
)
from .epilogue import ACTIVATIONS, Epilogue
from .fused_gen import (
    GROUPED,
    GROUPED_DW,
    FusedKernel,
    compile_fused,
    grouped_dw_ref,
    grouped_ref,
)
from .plan import AxisPlan, KernelPlan, build_plan
from .schedules import (
    batched_matmul_schedule,
    chain_matmul_schedule,
    default_schedule,
    transposed_matmul_schedule,
)
from .tune import tune_schedule

#: public name, as in the reference: ``codegen.compile(spec, schedule)``
compile = compile_kernel

__all__ = [
    "ACTIVATIONS",
    "AutotuneCache",
    "AxisPlan",
    "CONTRACT",
    "CompiledKernel",
    "Epilogue",
    "FusedKernel",
    "GROUPED",
    "GROUPED_DW",
    "KernelPlan",
    "batched_matmul_schedule",
    "build_plan",
    "cache_key",
    "cached_compile",
    "chain_matmul_schedule",
    "compile",
    "compile_fused",
    "compile_kernel",
    "contract_ref",
    "default_cache",
    "default_schedule",
    "grouped_dw_ref",
    "grouped_ref",
    "dtype_name",
    "hardware_fingerprint",
    "schedule_from_dict",
    "schedule_to_dict",
    "transposed_matmul_schedule",
    "tune_schedule",
]
