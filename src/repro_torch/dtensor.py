"""DTensor helpers shared by the models, the optimizer and the launchers.

A step whose parameters are DTensors (``launch.steps.shard_tree``) runs
sharded; these name the layouts it takes explicitly where DTensor's own
propagation has no rule or would pick another layout than the reference's
sharding rules imply.  ``torch.distributed.tensor`` is imported inside
each function, so importing this module costs nothing.
"""

from __future__ import annotations

import contextlib

import torch

_DTENSOR = None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    global _DTENSOR
    if _DTENSOR is None:
        if type(x).__name__ != "DTensor":
            return False
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def any_dtensor(tree) -> bool:
    """Whether any leaf of a nested dict (or a tensor) is a DTensor."""
    if isinstance(tree, dict):
        return any(any_dtensor(v) for v in tree.values())
    return is_dtensor(tree)


def sharded_ops(*trees):
    """A context in which plain tensors meet DTensors as replicated ones
    (DTensor's implicit replication, a flag of the calling thread), where
    any leaf of ``trees`` is a DTensor; otherwise no change.  Unlike
    ``implicit_replication`` it nests: leaving it restores the flag as it
    found it."""
    if not any(any_dtensor(t) for t in trees):
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def replicate(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def batch_placements(mesh, batch: int, heads=None) -> list:
    """Placements of a (batch, seq, heads, ...) activation that gives each
    rank whole sequences: the batch over the mesh's ``pod`` / ``data``
    dims that divide it, and ``heads`` (extents the ``model`` dim must all
    divide) over ``model`` at dim 2; the rest replicated."""
    from torch.distributed.tensor import Replicate, Shard

    out, used = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if name in ("pod", "data") and batch % (used * n) == 0:
            out.append(Shard(0))
            used *= n
        elif name == "model" and heads and all(h % n == 0 for h in heads):
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return out


def whole_heads(x, dim: int, heads: int):
    """``x`` (a DTensor whose dim ``dim`` holds ``heads`` heads, or
    flattens them with what follows) gathered along ``dim`` where that dim
    is sharded over more ranks than divide ``heads``: a reshape that
    splits or groups the heads needs whole ones on each rank."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    n = 1
    for i in on:
        n *= mesh.size(i)
    if on and heads % n:
        x = x.redistribute(mesh, [Replicate() if i in on else p
                                  for i, p in enumerate(x.placements)])
    return x


class _MergeHeads(torch.autograd.Function):
    """(..., heads, hd) -> (..., heads * hd); the backward's split gathers
    the gradient first where its layout does not hold whole heads."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            g = whole_heads(g, g.ndim - 1, ctx.shape[-2])
        return g.reshape(ctx.shape)


def merge_heads(x):
    """``x.reshape(*x.shape[:-2], -1)`` whose backward works for every
    layout of the gradient (``split_last``'s concern, in reverse)."""
    if is_dtensor(x):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def split_last(x, *shape):
    """``x.reshape(*shape)`` where ``shape`` splits ``x``'s last dim into
    (heads, head dim): a DTensor whose last dim is sharded over more ranks
    than divide the heads is first gathered along it (the reference's
    rules shard the flattened heads x head dim by divisibility; the split
    then needs whole heads on each rank)."""
    if is_dtensor(x):
        x = whole_heads(x, x.ndim - 1, shape[-2])
    return x.reshape(*shape)


def to_placements(x, mesh, placements):
    """``x`` (a DTensor, or a plain tensor taken as replicated) brought to
    ``placements`` on ``mesh``."""
    from torch.distributed.tensor import DTensor

    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, replicate(mesh), run_check=False)
    return x.redistribute(mesh, placements)


def from_local(x: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` from this rank's block ``x``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        x, mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(tuple(shape), device="meta").stride())


def local(x):
    """The local tensor of a DTensor; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_block(x, grad_placements=None):
    """This rank's block of the DTensor ``x`` as a plain tensor to compute
    on, whose gradient reaches ``x`` contiguous (a DTensor view of its
    gradient then reads the local block as the global strides say);
    ``grad_placements`` as in ``DTensor.to_local``."""
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad_placements))


def offset(mesh, placements, n: int) -> int:
    """The first index of this rank's block of a length-``n`` axis 0 that
    ``placements`` shard evenly (over the mesh dims in order, as DTensor
    nests them); from the rank's coordinates alone, no tensor op."""
    coords = mesh.get_coordinate()
    block, count = 0, 1
    for i, p in enumerate(placements):
        if p.is_shard(0):
            block = block * mesh.size(i) + coords[i]
            count *= mesh.size(i)
    if n % count:
        raise ValueError(f"{n} rows do not split evenly over {count} ranks")
    return block * (n // count)


def copies(x) -> int:
    """How many ranks hold each element of a DTensor's shards (the mesh
    dims it is not sharded over)."""
    import math

    mesh = x.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                     if not p.is_shard())


def reduced(x):
    """The DTensor ``x`` with its ``Partial`` mesh dims reduced (to
    ``Replicate``); ``x`` itself where it has none."""
    if not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])
