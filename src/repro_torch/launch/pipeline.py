"""GPipe-style pipeline parallelism over a mesh axis (the multi-pod
mesh's ``pod`` axis, switchable from hierarchical data parallelism).

A port of the reference's ``launch/pipeline.py`` onto ranks:
``pipeline_apply`` runs a stage function over P = |axis| stages and M
microbatches, one stage a rank: in each of the M + P - 1 ticks every
stage applies its layer block to the activation it holds, then a ring
shift (``collectives.ppermute``, point to point to the next stage) moves
activations downstream -- the classic bubble schedule (bubble fraction
(P-1)/(M+P-1)).  Stage s holds the s-th slice of the stacked parameter
tree.

The schedule is the paper's subdiv/flip vocabulary once more: the layer
stack is ``subdiv``-ed into P stages bound to a mesh axis, and the
exchange that makes it work is a rotation instead of a transposition.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..codegen.collectives import all_reduce, axis_index, axis_size, ppermute


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(
    stage_fn: Callable,          # (stage_params, x) -> y   (same shape)
    stage_params,                # leaves lead with the LOCAL stage dim (=1)
    microbatches: torch.Tensor,  # (M, mb, ...) -- the same on every stage
    axis_name: str,
    mesh=None,
) -> torch.Tensor:
    """Run on every rank of ``axis_name``'s ring (each passing its stage's
    slice of the parameters, as the reference's ``shard_map`` hands each
    device its block).  Returns the (M, mb, ...) outputs on every rank,
    broadcast from the last stage by a final sum."""
    p = axis_size(axis_name, mesh)
    stage = axis_index(axis_name, mesh)
    m = microbatches.shape[0]
    params_local = _tree_map(lambda w: w[0], stage_params)
    state = torch.zeros_like(microbatches[0])
    outbuf = torch.zeros_like(microbatches)
    for t in range(m + p - 1):
        # stage 0 ingests microbatch t (while available)
        x = (microbatches[t].to(state.dtype) if stage == 0 and t < m
             else state)
        y = stage_fn(params_local, x)
        # the last stage emits microbatch t - (p - 1)
        if stage == p - 1 and t >= p - 1:
            outbuf[t - (p - 1)] = y.to(outbuf.dtype)
        # shift downstream (a ring; stage 0 receives what it overwrites)
        state = ppermute(y, axis_name, mesh)
    # everyone but the last stage holds zeros: the sum broadcasts its buffer
    keep = 1.0 if stage == p - 1 else 0.0
    return all_reduce(outbuf * keep, (axis_name,), "psum", mesh)


def bubble_fraction(p: int, m: int) -> float:
    return (p - 1) / (m + p - 1)


__all__ = ["bubble_fraction", "pipeline_apply"]
