"""repro_torch.grad — differentiable generated kernels.

A port of the reference's ``repro.grad``:

  ``derive``   backward ContractionSpecs by index calculus (a copy of the
               reference's): for each operand ``W`` of a forward spec,
               ``dW`` is itself a contraction named ``<spec>.d<W>`` with
               its own plan-DB/autotune-cache keys; the grouped family's
               ``grouped_matmul.dX/.dW`` are hand-derived ragged specs.
  ``vjp``      ``torch.autograd.Function`` wrappers pairing every ``ops``
               primal with a backward whose cotangent GEMMs compile
               through the same ``ContractionSpec -> plan DB -> codegen``
               pipeline as the forward kernels.

``ops`` routes through these wrappers by default (``differentiable=True``)
wherever a call dispatches to a kernel, so autograd through a model on the
card runs hand-written kernels on both sides of the tape
(``launch.steps.make_train_step``).
"""

from .derive import COTANGENT, derived_spec, derived_specs
from .vjp import (
    apply_spec,
    attention_vjp,
    batched_dense_vjp,
    chain_dense_vjp,
    dense_act_vjp,
    dense_transposed_vjp,
    dense_vjp,
    grouped_vjp,
    weighted_dense_vjp,
)

__all__ = [
    "COTANGENT",
    "apply_spec",
    "attention_vjp",
    "batched_dense_vjp",
    "chain_dense_vjp",
    "dense_act_vjp",
    "dense_transposed_vjp",
    "dense_vjp",
    "derived_spec",
    "derived_specs",
    "grouped_vjp",
    "weighted_dense_vjp",
]
