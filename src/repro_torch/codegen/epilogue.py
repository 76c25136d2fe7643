"""Epilogue hook: fused tail computation on the accumulator tile.

A port of the reference's ``codegen/epilogue.py``.  The paper's NN
motivating example (eqs 3-5) is a dense layer whose normalization +
nonlinearity stages are low arithmetic density: fusing them into the
matmul epilogue saves the device-memory round trips of materializing ``y``
and ``z``.  The contraction kernel (``csrc/contract.cu``) runs the epilogue
on its float32 accumulator right before the store:

    a = f32(acc) * qscale             (dequant: int8/fp8 accumulators)
    y = a * scale + bias              (vectors broadcast over the last
    z = (y - mean) * rsqrt(var+eps)    output axis, each optional)
    r = act(z)

Vector operands (qscale/scale/bias/mean/var) are passed to the kernel by
keyword and indexed along the last output axis.  ``apply`` is the plain
PyTorch version of the same tail; the card's kernels and the CPU path share
its arithmetic (gelu is the tanh approximation, ``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "tanh": torch.tanh,
    "silu": F.silu,
    "id": lambda z: z,
}

#: the kernel's activation codes (``ContractParams.act`` in contract.cu)
ACT_CODES = {"id": 0, "relu": 1, "gelu": 2, "tanh": 3, "silu": 4}


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Which fused tail stages the generated kernel applies."""

    act: str = "id"
    bias: bool = False
    scale: bool = False
    norm: bool = False          # normalize with given (mean, var) stats
    eps: float = 1e-5
    #: dequantize first: cast the (possibly int32) accumulator to f32 and
    #: multiply by the ``qscale`` row (combined input scales, one per
    #: output column; a constant row for per-tensor scales)
    dequant: bool = False

    def __post_init__(self):
        if self.act not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation {self.act!r}; have {sorted(ACTIVATIONS)}"
            )

    @property
    def vector_names(self) -> Tuple[str, ...]:
        """Extra kernel operands, in argument order."""
        names = []
        if self.dequant:
            names.append("qscale")
        if self.scale:
            names.append("scale")
        if self.bias:
            names.append("bias")
        if self.norm:
            names.extend(["mean", "var"])
        return tuple(names)

    @property
    def kind(self) -> str:
        """The stages the kernel runs, as a plan-DB key names them (an
        epilogue ladder's, ``search.search_schedule(epilogue=)``): its
        vectors and activation, e.g. ``"bias+mean+var:gelu"``; ``eps``
        changes no launch."""
        return f"{'+'.join(self.vector_names) or 'none'}:{self.act}"

    @property
    def is_identity(self) -> bool:
        return not self.vector_names and self.act == "id"

    def apply(self, acc: torch.Tensor,
              vectors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Run the tail on the accumulator; vectors are f32 rows
        broadcastable against ``acc``."""
        y = acc
        if self.dequant:
            # scales come first: everything downstream (bias/act/norm)
            # sees real-valued activations, as on the bf16/f32 path
            y = y.to(torch.float32) * vectors["qscale"]
        if self.scale:
            y = y * vectors["scale"]
        if self.bias:
            y = y + vectors["bias"]
        if self.norm:
            y = (y - vectors["mean"]) * torch.rsqrt(vectors["var"] + self.eps)
        return ACTIVATIONS[self.act](y)
