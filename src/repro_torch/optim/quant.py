"""Block-wise 8-bit quantization (8-bit-Adam style) and GEMM operands.

The port of the reference's ``optim/quant.py``, bit for bit: the same f32
division, round-half-to-even, clip to +-127 and cast to
``torch.float8_e4m3fn``.

* Blocks: tensors are flattened and quantized in blocks of ``BLOCK`` with
  a per-block absmax scale (``quantize``/``dequantize``).  ``optim.adamw``
  keeps its moments this way with ``moments_dtype='int8'``.
* GEMM operands: ``quantize_tensor`` (one scale) and ``quantize_channels``
  (one scale per slice of the last axis) give the int8/fp8 operands of
  ``ops.dense(quant=)``, whose kernel applies ``qscale = sx * sw`` in its
  dequant epilogue.
* Weight-only serving: ``quantize_tree`` turns the large float leaves of a
  parameter tree (nested dicts, lists and tuples of tensors) into
  ``Quantized`` blocks once at load, ``tree_quant_bytes`` counts what
  stays live (``launch.serve --quant int8``).  ``dequantize_tree``
  expands a tree; ``QuantizedLayers`` expands a stacked leaf one layer at
  a time, which is how the model's layer loop takes it.  Quantizing works
  in chunks of whole blocks, so a 7 GB stacked leaf never has an f32 copy
  of itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

BLOCK = 256


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE f32 division.  On a CUDA tensor PyTorch turns
    a division by a host scalar into a multiplication by its reciprocal,
    which can differ in the last bit; a divisor on the tensor's device
    keeps the division, and the reference's bits."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


@dataclasses.dataclass
class Quantized:
    """int8 payload + per-block f32 scales + original shape/dtype."""

    q: torch.Tensor       # (nblocks, BLOCK) int8
    scale: torch.Tensor   # (nblocks, 1) f32
    shape: Tuple[int, ...]
    dtype: torch.dtype


def block_placements(device_mesh, nblocks: int) -> list:
    """The DTensor placements of a ``Quantized`` moment's (nblocks, ...)
    tensors on ``device_mesh``: the block axis sharded over the mesh's
    ``data`` and ``model`` dims together where their product divides it,
    else replicated -- ``launch.sharding.quantized_sharding``'s layout."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names
    dims = [i for i, n in enumerate(names) if n in ("data", "model")]
    ranks = math.prod(device_mesh.size(i) for i in dims)
    if not dims or nblocks % ranks:
        return [Replicate()] * device_mesh.ndim
    return [Shard(0) if i in dims else Replicate()
            for i in range(device_mesh.ndim)]


def quantize_blocks(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scale) of a 1-D tensor, zero-padded to whole blocks."""
    flat = flat.to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, _div(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      n: int) -> torch.Tensor:
    """The first ``n`` values of the f32 blocks ``q * scale``, flat."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


#: elements per pass of ``quantize`` (a whole number of blocks): 64 MiB of
#: f32 temporaries at a time
CHUNK = 1 << 24


def quantize(x: torch.Tensor) -> Quantized:
    """Blocks of the flattened ``x``, quantized ``CHUNK`` elements at a
    time (every block lies in one chunk, so the bits are a whole-tensor
    pass's)."""
    flat = x.reshape(-1)
    nblocks = -(-flat.numel() // BLOCK)
    q = torch.empty((nblocks, BLOCK), dtype=torch.int8, device=x.device)
    scale = torch.empty((nblocks, 1), dtype=torch.float32, device=x.device)
    per = CHUNK // BLOCK
    for b in range(0, nblocks, per):
        q[b:b + per], scale[b:b + per] = quantize_blocks(
            flat[b * BLOCK:(b + per) * BLOCK])
    return Quantized(q, scale, tuple(x.shape), x.dtype)


def dequantize(qv: Quantized) -> torch.Tensor:
    """``q * scale`` in f32, rounded once to the leaf's dtype, as the
    reference computes it: the whole blocks in two passes over the output
    (an exact copy of the int8 payload, then an in-place multiply whose
    arithmetic is f32), the last partial block apart; no f32 copy."""
    n = 1
    for d in qv.shape:
        n *= d
    out = torch.empty(n, dtype=qv.dtype, device=qv.q.device)
    full = n // BLOCK
    body = out[:full * BLOCK].view(full, BLOCK)
    body.copy_(qv.q[:full])
    body.mul_(qv.scale[:full])
    if n > full * BLOCK:
        out[full * BLOCK:] = dequantize_blocks(
            qv.q[full:], qv.scale[full:], n - full * BLOCK).to(qv.dtype)
    return out.reshape(qv.shape)


def dequantize_layer(qv: Quantized, i: int) -> torch.Tensor:
    """``dequantize(qv)[i]`` of a stacked leaf, expanding only the blocks
    that hold slice ``i`` of its leading axis: the same values, one
    layer's memory."""
    per = 1
    for d in qv.shape[1:]:
        per *= d
    start = i * per
    b0, b1 = start // BLOCK, -(-(start + per) // BLOCK)
    part = Quantized(qv.q[b0:b1], qv.scale[b0:b1], ((b1 - b0) * BLOCK,),
                     qv.dtype)
    off = start - b0 * BLOCK
    return dequantize(part)[off:off + per].reshape(qv.shape[1:])


class QuantizedLayers:
    """The slices of a stacked ``Quantized`` leaf along its layers axis,
    each expanded (``dequantize_layer``) when it is taken: what
    ``tensor.unbind(0)`` gives a full-precision leaf."""

    def __init__(self, qv: Quantized):
        self.qv = qv

    def __len__(self) -> int:
        return self.qv.shape[0]

    def __getitem__(self, i: int) -> torch.Tensor:
        if not 0 <= i < len(self):
            raise IndexError(i)
        return dequantize_layer(self.qv, i)


def quantization_bytes(qv: Quantized) -> int:
    return qv.q.numel() + qv.scale.numel() * 4


# ---------------------------------------------------------------------------
# GEMM-operand quantization (B1's int8/fp8 modes)
#
# The kernel-facing layout: operands stored at int8/fp8 with a per-tensor
# scalar or per-output-channel scale row that the contraction kernel's
# dequant epilogue applies to its accumulator
# (``codegen.Epilogue(dequant=True)``, qscale = sx * sw).
# ---------------------------------------------------------------------------

#: absmax maps to the largest exactly-representable magnitude per format
_QMAX = {"int8": 127.0, "fp8": 448.0, "float8_e4m3fn": 448.0}


def _storage_dtype(fmt: str) -> torch.dtype:
    if fmt in ("fp8", "float8_e4m3fn"):
        return torch.float8_e4m3fn
    if fmt == "int8":
        return torch.int8
    raise ValueError(f"unknown quant format {fmt!r}; have {sorted(_QMAX)}")


def _cast(x: torch.Tensor, fmt: str, scale: torch.Tensor) -> torch.Tensor:
    y = x.to(torch.float32) / scale
    if fmt == "int8":
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.to(_storage_dtype(fmt))


def quantize_tensor(x: torch.Tensor, fmt: str = "int8"):
    """(q, scale): whole-tensor absmax quantization; scale is a 0-d f32.

    Empty tensors (any zero extent) quantize with scale 1.0: there is
    nothing to round, but the shape and dtype round trip must still hold.
    """
    qmax = _QMAX[fmt]
    if x.numel() == 0:
        scale = torch.tensor(1.0, dtype=torch.float32, device=x.device)
        return _cast(x, fmt, scale), scale
    absmax = x.to(torch.float32).abs().max()
    scale = torch.where(absmax > 0, _div(absmax, qmax),
                        torch.ones_like(absmax))
    return _cast(x, fmt, scale), scale


def channel_scales(w: torch.Tensor, fmt: str = "int8") -> torch.Tensor:
    """The f32 scale of each slice of ``w``'s last axis, as
    ``quantize_channels`` computes it."""
    qmax = _QMAX[fmt]
    if any(d == 0 for d in w.shape[:-1]):
        return torch.ones((w.shape[-1],), dtype=torch.float32,
                          device=w.device)
    absmax = w.to(torch.float32).abs().amax(dim=tuple(range(w.dim() - 1)))
    return torch.where(absmax > 0, _div(absmax, qmax),
                       torch.ones_like(absmax))


def quantize_channels(w: torch.Tensor, fmt: str = "int8"):
    """(q, scales): per-output-channel quantization of a (..., F) weight.

    One scale per slice of the LAST axis: the output-column granularity
    the dequant epilogue broadcasts over the accumulator tile.
    """
    scale = channel_scales(w, fmt)
    return _cast(w, fmt, scale), scale


def quantize_channels_kmajor(w: torch.Tensor, fmt: str = "int8"):
    """(qt, scales) of a 2-D (D, F) weight: ``qt`` is (F, D) contiguous and
    ``qt.T`` holds exactly ``quantize_channels(w)[0]``'s values.  The 8-bit
    kernel reads W's k axis contiguous; writing the quantized copy in that
    order costs the same pass as writing it (D, F)."""
    scale = channel_scales(w, fmt)
    y = torch.empty((w.shape[1], w.shape[0]), dtype=torch.float32,
                    device=w.device)
    y.copy_(w.t())
    y /= scale[:, None]
    if fmt == "int8":
        return torch.clamp_(torch.round_(y), -127, 127).to(torch.int8), scale
    return y.to(_storage_dtype(fmt)), scale


#: weight leaves smaller than this stay full-precision in quantize_tree:
#: biases and norm gains are tiny and precision-critical
MIN_QUANT_SIZE = 4096


def _tree_map(fn, tree, is_leaf=lambda x: False):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantize_tree(params, fmt: str = "int8", min_size: int = MIN_QUANT_SIZE):
    """Weight-only quantization of a parameter tree, once at load.

    Float tensors with >= 2 dims and >= ``min_size`` elements become
    ``Quantized`` leaves (block-wise int8 + scales); everything else passes
    through.  Pair with ``dequantize_tree`` before each model call: the
    live weights stay 8-bit + scales (``launch.serve --quant int8``).
    """
    if fmt != "int8":
        raise NotImplementedError(
            f"weight-only serving quantization supports 'int8', got {fmt!r}"
        )

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 2 and (
            x.is_floating_point()
        ) and x.numel() >= min_size:
            return quantize(x)
        return x

    return _tree_map(leaf, params)


def dequantize_tree(params):
    """Inverse of ``quantize_tree``: expand Quantized leaves, pass the rest."""
    return _tree_map(
        lambda x: dequantize(x) if isinstance(x, Quantized) else x, params,
        is_leaf=lambda x: isinstance(x, Quantized))


def tree_quant_bytes(params) -> int:
    """Bytes of the quantized leaves (payload + scales): the memory the
    weight-only tier actually holds live."""
    return sum(quantization_bytes(x) for x in _leaves(params)
               if isinstance(x, Quantized))
