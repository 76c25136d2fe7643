"""repro_torch.codegen — schedule-driven kernel generation for Hopper.

The reference compiles a ``ContractionSpec`` + ``Schedule`` into a Pallas
kernel.  The port keeps the pure half unchanged (``plan.build_plan``,
``schedules.default_schedule``, the tuner and its persistent cache, with
the reference's key format) and lowers every product-reduce contraction
onto B1's hand-written CUDA kernels (``cuda_gen``): ``csrc/contract.cu``
for f32/bf16 operands, with the epilogue (``epilogue.Epilogue``) and the
weighted three-operand family; ``csrc/contract_q8.cu`` for int8/fp8 specs
and ``csrc/contract_chain.cu`` for the chain (their launchers in
``modes``); the fused families lower onto ``csrc/attention.cu`` (flash
attention, B2), ``csrc/grouped.cu`` (the grouped MoE forward and dX) and
``csrc/grouped_dw.cu`` (dW) (``fused_gen``).  All are built by
``nvcc`` at first use (``build``).  A schedule's ``mesh:*`` levels bind
the kernel to a mesh of ranks (``mesh_gen.bind_mesh``, ``compile(...,
mesh=)``): each rank launches the kernel on its shard, and sharded reduce
indices finish with a ``torch.distributed`` collective (``collectives``).

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
from .collectives import (
    all_reduce,
    naive_gather_matmul,
    ring_gather_matmul,
    ring_psum,
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
    ATTENTION,
    GROUPED,
    GROUPED_DW,
    FusedKernel,
    attention_mask,
    attention_ref,
    compile_fused,
    grouped_dw_ref,
    grouped_ref,
)
from .mesh_gen import (
    MeshBoundKernel,
    Placements,
    bind_mesh,
    operand_partition_spec,
    output_partition_spec,
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
    "ATTENTION",
    "AutotuneCache",
    "AxisPlan",
    "CONTRACT",
    "CompiledKernel",
    "Epilogue",
    "FusedKernel",
    "GROUPED",
    "GROUPED_DW",
    "KernelPlan",
    "MeshBoundKernel",
    "Placements",
    "all_reduce",
    "attention_mask",
    "attention_ref",
    "batched_matmul_schedule",
    "bind_mesh",
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
    "naive_gather_matmul",
    "operand_partition_spec",
    "output_partition_spec",
    "ring_gather_matmul",
    "ring_psum",
    "schedule_from_dict",
    "schedule_to_dict",
    "transposed_matmul_schedule",
    "tune_schedule",
]
