"""Mesh tiers over ranks: the cluster/device half of the hierarchy.

A port of the reference's ``codegen/mesh_gen.py``.  A ``mesh:*`` level
shards its root index over the named mesh axis:

  * map (output) indices -> the operand and output axes are partitioned
    over the mesh axis;
  * reduce indices -> operands are partitioned, each rank computes a
    partial contraction, and a collective over the axis completes the
    reduction: ``all_reduce(..., collective)`` with the plan's strategy,
    ``"psum"`` or ``"ring"`` (``collectives``).

The reference's ``PartitionSpec`` of an operand (one entry per tensor
dimension: None, an axis name, or a tuple of them) becomes a
``Placements``: the DTensor placement of each *mesh* dimension
(``Shard(d)`` where the mesh axis partitions tensor dimension ``d``, else
``Replicate()``), keeping the reference's entries as ``.spec``, so the two
compare entry for entry.

``bind_mesh`` wraps a ``CompiledKernel`` (which always works on the local,
per-shard extents) into a ``MeshBoundKernel`` called on GLOBAL tensors:

  * plain tensors are taken as replicated on every rank: each rank cuts
    its shard of every operand, launches the local kernel (on CUDA
    tensors: one launch of B1), finishes mesh-sharded reduce indices with
    the collective, and gathers the map-sharded output axes (counted in
    ``obs``'s ``mesh.gathers`` / ``mesh.gather_bytes``), so every rank
    returns the full output;
  * a ``DTensor`` operand sends the call through
    ``torch.distributed.tensor.experimental.local_map``: the operands are
    redistributed to the plan's placements and the result comes back as a
    DTensor with the plan's output placements (no gather).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .collectives import STRATEGIES, all_gather, all_reduce, axis_index
from .collectives import axis_size as _axis_size
from .collectives import mesh_scope
from .plan import KernelPlan

Entry = Optional[object]  # None, an axis name, or a tuple of axis names


class Placements(tuple):
    """One DTensor placement per mesh dimension, with ``.spec``: the
    reference's ``PartitionSpec`` entries (per tensor dimension)."""

    spec: Tuple[Entry, ...]

    def __new__(cls, spec: Sequence[Entry], axis_names: Sequence[str]):
        from torch.distributed.tensor import Replicate, Shard

        spec = tuple(spec)
        out = []
        for name in axis_names:
            dims = [d for d, e in enumerate(spec) if name in _names(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        used = {a for e in spec for a in _names(e)}
        missing = used - set(axis_names)
        if missing:
            raise ValueError(f"spec {spec} names mesh axes {sorted(missing)} "
                             f"the mesh {tuple(axis_names)} lacks")
        obj = super().__new__(cls, out)
        obj.spec = spec
        return obj

    def __repr__(self) -> str:
        return f"Placements({list(self)}, spec={self.spec})"


def _names(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_entry(plan: KernelPlan, index: str) -> Entry:
    axes = plan.axes[index].mesh_axes
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def operand_entries(plan: KernelPlan, name: str) -> Tuple[Entry, ...]:
    """The reference's ``PartitionSpec`` entries of operand ``name``."""
    return tuple(_axis_entry(plan, i) for i in plan.spec.operands[name])


def output_entries(plan: KernelPlan) -> Tuple[Entry, ...]:
    return tuple(_axis_entry(plan, i) for i in plan.spec.output)


def operand_partition_spec(plan: KernelPlan, name: str,
                           axis_names: Sequence[str]) -> Placements:
    """Operand ``name``'s placements on a mesh of ``axis_names``."""
    return Placements(operand_entries(plan, name), axis_names)


def output_partition_spec(plan: KernelPlan,
                          axis_names: Sequence[str]) -> Placements:
    """The output's placements on a mesh of ``axis_names`` (a sharded
    reduce index leaves it replicated over its axis once finished)."""
    return Placements(output_entries(plan), axis_names)


def reduce_mesh_axes(plan: KernelPlan) -> Tuple[str, ...]:
    """Mesh axes carrying a reduce index (need a collective to finish)."""
    out = []
    for r in plan.spec.reduce_indices:
        out.extend(plan.axes[r].mesh_axes)
    return tuple(out)


def _shard(x: torch.Tensor, entries: Sequence[Entry], mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``entries``."""
    for d, e in enumerate(entries):
        if e is None:
            continue
        n = _axis_size(e, mesh)
        step = x.shape[d] // n
        x = x.narrow(d, axis_index(e, mesh) * step, step)
    return x.contiguous()


def _gather(x: torch.Tensor, entries: Sequence[Entry], mesh) -> torch.Tensor:
    """The global output from this rank's block: every map-sharded output
    axis gathered over its mesh axes."""
    from ..obs import counter

    for d, e in enumerate(entries):
        if e is None or _axis_size(e, mesh) == 1:
            continue
        x = all_gather(x, e, dim=d, mesh=mesh)
        counter("mesh.gathers").inc()
        counter("mesh.gather_bytes").inc(x.numel() * x.element_size())
    return x


@dataclasses.dataclass
class MeshBoundKernel:
    """A kernel bound to a mesh of ranks.

    Call with GLOBAL tensors (operands in spec order, epilogue vectors by
    keyword); carries the inner ``CompiledKernel`` so callers that
    introspect ``.schedule`` / ``.plan`` (tests, ``ops._tuned_kernel``) see
    the same surface as the single-rank object.  Each call counts
    ``obs``'s ``mesh.calls.<spec name>``.
    """

    kernel: object            # the local-shape CompiledKernel
    mesh: object
    collective: str
    _call: object = dataclasses.field(repr=False, default=None)

    @property
    def spec(self):
        return self.kernel.spec

    @property
    def schedule(self):
        return self.kernel.schedule

    @property
    def plan(self) -> KernelPlan:
        return self.kernel.plan

    @property
    def names(self):
        return self.kernel.names

    @property
    def epilogue(self):
        return self.kernel.epilogue

    def __call__(self, *arrays, **vectors):
        return self._call(*arrays, **vectors)


def _check_mesh(plan: KernelPlan, mesh) -> None:
    for i, ax in plan.axes.items():
        if not ax.mesh_axes:
            continue
        for a in ax.mesh_axes:
            if a not in mesh.axis_names:
                raise ValueError(f"index {i!r} is sharded over mesh axis "
                                 f"{a!r}, which the mesh "
                                 f"{tuple(mesh.axis_names)} lacks")
        have = _axis_size(ax.mesh_axes, mesh)
        if have != ax.shards:
            raise ValueError(f"index {i!r} takes {ax.shards} shards over "
                             f"{ax.mesh_axes}, the mesh has {have}")


def bind_mesh(kernel, mesh, collective: str = "psum") -> MeshBoundKernel:
    """Bind a ``CompiledKernel`` to ``mesh`` (a ``launch.mesh.Mesh``).

    Returns a ``MeshBoundKernel`` called on GLOBAL tensors.  Epilogue
    vectors are sharded like the last output axis.  ``collective`` picks
    the finishing-reduction lowering for mesh-sharded reduce indices
    (``"psum"`` or ``"ring"``, see ``collectives``).

    Ordering with sharded reductions: the epilogue must see the FULL sum,
    not per-rank partials -- act(psum(partial) + bias), never
    psum(act(partial + bias)).  When a reduce index is mesh-sharded the
    kernel's epilogue is disabled (it writes its f32 accumulator) and
    re-applied here after the collective.
    """
    from ..obs import counter
    from .cuda_gen import _default_out_dtype

    if collective not in STRATEGIES:
        raise ValueError(
            f"unknown collective {collective!r}; choose from {STRATEGIES}"
        )
    plan = kernel.plan
    _check_mesh(plan, mesh)
    names = kernel.names
    epilogue = kernel.epilogue
    vec_names = epilogue.vector_names if epilogue else ()
    in_entries = [operand_entries(plan, n) for n in names]
    vec_entry = (_axis_entry(plan, plan.spec.output[-1]),)
    psum_axes = reduce_mesh_axes(plan)
    out_entries = output_entries(plan)
    defer_epilogue = bool(psum_axes) and epilogue is not None and (
        not epilogue.is_identity
    )
    # each rank launches on its shard: the local kernel's spec carries the
    # plan's local extents (what B1's launcher folds the operands by)
    root = kernel.spec.root()
    local = dataclasses.replace(
        root, parent=None, split=None,
        extents={i: plan.axes[i].local_extent for i in root.indices})
    inner = dataclasses.replace(kernel, spec=local)
    if defer_epilogue:
        inner = dataclasses.replace(inner, epilogue=None,
                                    out_dtype=torch.float32)
    out_rank = len(plan.spec.output)

    def local_fn(ops, vecs):
        if defer_epilogue:
            out = inner(*ops)
        else:
            out = inner(*ops, **dict(zip(vec_names, vecs)))
        if psum_axes:
            out = all_reduce(out, psum_axes, collective, mesh)
        if defer_epilogue:
            vectors = {
                nm: v.to(torch.float32).reshape((1,) * (out_rank - 1) + (-1,))
                for nm, v in zip(vec_names, vecs)
            }
            out_dtype = kernel.out_dtype or _default_out_dtype(
                kernel.spec, epilogue, ops[0].dtype)
            out = epilogue.apply(out, vectors).to(out_dtype)
        return out

    def call(*arrays, **vectors):
        missing = set(vec_names) - set(vectors)
        if missing:
            raise TypeError(f"epilogue vectors missing: {sorted(missing)}")
        if len(arrays) != len(names):
            raise TypeError(f"{kernel.spec.name} takes {len(names)} operands "
                            f"{names}, got {len(arrays)}")
        vecs = [vectors[v] for v in vec_names]
        counter(f"mesh.calls.{kernel.spec.name}").inc()
        with mesh_scope(mesh):
            if any(_is_dtensor(a) for a in (*arrays, *vecs)):
                return _dtensor_call(local_fn, mesh, arrays, vecs,
                                     in_entries, vec_entry, out_entries)
            ops = [_shard(a, e, mesh) for a, e in zip(arrays, in_entries)]
            loc = [_shard(v, vec_entry, mesh) for v in vecs]
            return _gather(local_fn(ops, loc), out_entries, mesh)

    return MeshBoundKernel(kernel=kernel, mesh=mesh, collective=collective,
                           _call=call)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _dtensor_call(local_fn, mesh, arrays, vecs, in_entries, vec_entry,
                  out_entries):
    """The DTensor form: ``local_map`` over the plan's placements; plain
    tensors among the arguments are taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    dm = mesh.device_mesh
    n = len(arrays)
    in_pl = [Placements(e, mesh.axis_names) for e in in_entries]
    in_pl += [Placements(vec_entry, mesh.axis_names)] * len(vecs)
    out_pl = Placements(out_entries, mesh.axis_names)

    def as_dtensor(x):
        if _is_dtensor(x):
            return x
        return DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                                  run_check=False)

    fn = local_map(lambda *a: local_fn(list(a[:n]), list(a[n:])),
                   out_placements=list(out_pl),  # one output
                   in_placements=tuple(tuple(p) for p in in_pl),
                   device_mesh=dm, redistribute_inputs=True)
    return fn(*(as_dtensor(x) for x in (*arrays, *vecs)))


__all__ = [
    "MeshBoundKernel",
    "Placements",
    "bind_mesh",
    "operand_entries",
    "operand_partition_spec",
    "output_entries",
    "output_partition_spec",
    "reduce_mesh_axes",
]
