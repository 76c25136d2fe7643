"""Semi-vectorized executor for contraction variants, on tensors — the
wall-clock half of the paper's Tables 1/2.

The paper's C++ codegen turns each HoF ordering into a distinct loop nest and
measures it.  Python cannot time scalar loops, so the executor runs the
*outer* loop levels as real Python loops (preserving the traversal order the
variant prescribes) and delegates the innermost ``vector_levels`` dims to one
``torch.einsum`` call over the current operand slices.  Slices of
transposed/subdivided operands are tensor *views* with the strides the
variant implies, so the memory-access-pattern differences between variants
are real and measurable — the same signal the paper measures, at block
granularity.

This is the port of the reference's numpy executor, on the operands'
device (a CUDA tensor runs the einsums on the card, a CPU tensor on the
host).  ``_prepare`` splits an axis with ``view``, never ``reshape``: a
split that would need a copy, which the reference's reshape of a fresh
array never makes, raises instead of changing the access pattern behind
the variant's back.  On the card each einsum is one launch and the loops
above it run on the host, so ``TAILS.calls`` (the einsums a call made)
says how far the host bounds a variant's time.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .enumerate import ContractionSpec


class TailCounter:
    """Counts the executor's innermost einsum calls."""

    def __init__(self):
        self.calls = 0


#: the process's one counter; set ``TAILS.calls = 0`` before a run to count it
TAILS = TailCounter()


def _prepare(spec: ContractionSpec, name: str, arr: torch.Tensor):
    root = spec.root()
    axes = list(root.operands[name])
    for index, b in spec.split_chain():
        if index not in axes:
            continue
        p = axes.index(index)
        e = arr.shape[p]
        arr = arr.view(arr.shape[:p] + (e // b, b) + arr.shape[p + 1 :])
        axes[p : p + 1] = [index + "o", index + "i"]
    return arr, axes


def execute_variant(
    spec: ContractionSpec,
    order: Sequence[str],
    arrays: Dict[str, torch.Tensor],
    vector_levels: int = 2,
) -> torch.Tensor:
    order = tuple(order)
    letters = {idx: chr(ord("a") + i) for i, idx in enumerate(spec.indices)}
    names = list(spec.operands)
    prepped = {}
    for n in names:
        arr, axes = _prepare(spec, n, torch.as_tensor(arrays[n]))
        target = sorted(axes, key=order.index)
        arr = arr.permute(tuple(axes.index(t) for t in target))  # a view
        prepped[n] = (arr, target)

    cut = max(len(order) - vector_levels, 0)
    tail = order[cut:]
    tail_maps = [i for i in tail if spec.kind(i) == "map"]

    def einsum_tail(vals: Dict[str, torch.Tensor], axlists) -> torch.Tensor:
        subs = ",".join("".join(letters[i] for i in axlists[n]) for n in names)
        out = "".join(letters[i] for i in tail_maps)
        TAILS.calls += 1
        return torch.einsum(f"{subs}->{out}", *(vals[n] for n in names))

    def exec_level(k: int, vals, axlists):
        if k == cut:
            return einsum_tail(vals, axlists)
        idx = order[k]
        involved = [n for n in names if axlists[n] and axlists[n][0] == idx]
        if not involved:
            return exec_level(k + 1, vals, axlists)
        sub_ax = {
            n: (axlists[n][1:] if n in involved else axlists[n]) for n in names
        }
        extent = vals[involved[0]].shape[0]
        if spec.kind(idx) == "map":
            parts = []
            for t in range(extent):
                v2 = dict(vals)
                for n in involved:
                    v2[n] = vals[n][t]
                parts.append(exec_level(k + 1, v2, sub_ax))
            return torch.stack(parts)
        acc = None
        for t in range(extent):
            v2 = dict(vals)
            for n in involved:
                v2[n] = vals[n][t]
            y = exec_level(k + 1, v2, sub_ax)
            acc = y if acc is None else acc + y
        return acc

    vals = {n: prepped[n][0] for n in names}
    axlists = {n: list(prepped[n][1]) for n in names}
    out = exec_level(0, vals, axlists)

    # canonicalize: produced axes are map dims in loop order
    produced = [i for i in order[:cut] if spec.kind(i) == "map"] + tail_maps
    perm = tuple(produced.index(i) for i in spec.output)
    out = out.permute(perm)
    root = spec.root()
    return out.reshape(tuple(root.extents[i] for i in root.output))


def flops_of(spec: ContractionSpec) -> int:
    return spec.flops()
