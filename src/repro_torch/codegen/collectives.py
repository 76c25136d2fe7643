"""Collective lowerings for mesh-tier schedules, on ``torch.distributed``.

A port of the reference's ``codegen/collectives.py``.  A schedule that
shards a *reduce* index over a mesh axis leaves every rank with a partial
local output; ``bind_mesh`` finishes it with one of two strategies, chosen
per plan by the search (``search.space.COLLECTIVES``):

  * ``"psum"`` -- one blocking ``all_reduce`` over the axis's process group
    after the local kernel;
  * ``"ring"`` -- ``ring_psum``: an explicit ring of point-to-point hops
    (``batch_isend_irecv`` to the ring neighbour, the reference's
    ``ppermute``), a reduce-scatter of ``p - 1`` hops and then an
    all-gather.  The two are tested equal.

``ring_gather_matmul`` / ``naive_gather_matmul`` are the ring-pipelined
tensor-parallel gather-matmul pair; ``launch.overlap`` re-exports them.
Their products are ``torch.matmul`` with f32 accumulation, as the
reference's are ``jnp.dot``s outside any kernel.

The reference runs these inside ``shard_map``, where an axis name is
enough; here the rank's mesh says which process group an axis name means.
Every function takes ``mesh=``, by default the innermost active one
(``mesh_scope``, which ``launch.mesh.set_mesh`` and a ``MeshBoundKernel``
call enter).  A mesh is any object with ``axis_names``, ``shape`` (axis ->
size), ``transport``, ``group(axis)``, ``coordinate(axis)`` and
``group_ranks(axis)`` (``launch.mesh.Mesh``).

The payload transport is fixed when the mesh is made, never probed:
``"device"`` hands the tensors to the backend as they are (NCCL takes CUDA
tensors); ``"host"`` copies each CUDA payload to pinned host memory, runs
the collective there and copies the result back, because gloo cannot carry
CUDA tensors for most collectives.  The bytes copied each way are counted
in ``obs``'s ``mesh.host_staged_bytes``; a CPU payload is never staged.
A mesh of CUDA ranks made with ``"host"`` stages DTensor's functional
collectives on its process groups the same way
(``stage_functional_collectives``); other groups keep the stock path.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence, Tuple, Union

import torch

#: strategies ``bind_mesh(collective=...)`` accepts
STRATEGIES = ("psum", "ring")
#: payload transports a mesh is made with
TRANSPORTS = ("device", "host")

#: the process's active meshes, innermost last (a process-wide stack, not
#: a thread-local one: autograd's device threads run backward passes that
#: must see the mesh their forward ran under)
_ACTIVE: List[object] = []

Axes = Union[str, Sequence[str]]


def current_mesh():
    """The innermost active mesh, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def mesh_scope(mesh):
    """Make ``mesh`` the active one for the body (None: no change)."""
    if mesh is None:
        yield None
        return
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


class _OneRank:
    """The active mesh inside ``single_rank``: one rank, so none is
    (``launch.mesh.active_mesh``)."""

    size = 1


def single_rank():
    """A context in which no mesh is active, whatever the caller's: a
    capture trace records the model's products on fake tensors, where a
    mesh-bound kernel's collectives must not run (the replayed graph's
    ``ops`` sites find the mesh plans again when they run)."""
    return mesh_scope(_OneRank())


def _mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: pass mesh= or run under "
                           "launch.mesh.set_mesh(mesh)")
    return mesh


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: Axes, mesh=None) -> int:
    """Ranks along ``axis`` (the product over a tuple of axes)."""
    mesh = _mesh(mesh)
    return math.prod(int(mesh.shape[a]) for a in _axes(axis))


def axis_index(axis: Axes, mesh=None) -> int:
    """This rank's coordinate along ``axis``; over a tuple of axes the
    row-major flattening (the first axis outermost), as a ``PartitionSpec``
    entry ``("data", "model")`` lays shards out."""
    mesh = _mesh(mesh)
    idx = 0
    for a in _axes(axis):
        idx = idx * int(mesh.shape[a]) + int(mesh.coordinate(a))
    return idx


def _count_staged(nbytes: int) -> None:
    from ..obs import counter

    counter("mesh.host_staged_bytes").inc(int(nbytes))


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA ``x`` (its bytes counted), else ``x``
    itself: a CPU payload is never staged."""
    if not x.is_cuda:
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    _count_staged(x.numel() * x.element_size())
    return h


def _to_host(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` where the collective runs: a pinned host copy of a CUDA
    payload under the ``host`` transport, else ``x`` itself."""
    return _pinned(x) if mesh.transport == "host" else x


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A staged result back on ``like``'s device."""
    if y.device == like.device:
        return y
    _count_staged(y.numel() * y.element_size())
    return y.to(like.device)


#: names of the process groups whose functional collectives are staged
#: (``stage_functional_collectives``)
_HOST_GROUPS: set = set()
#: dispatch key -> the ``_c10d_functional`` kernels installed for it
_STAGED_LIBS: dict = {}

_REDUCE_OPS = {"sum": "SUM", "avg": "AVG", "max": "MAX", "min": "MIN",
               "product": "PRODUCT"}


def _group_name(group) -> str:
    return group if isinstance(group, str) else group.group_name


def stage_functional_collectives(groups, key: str = "CUDA") -> None:
    """Run the functional collectives (the ``_c10d_functional`` ops DTensor
    redistributes with) of the process groups ``groups`` through the host:
    the ``host`` transport for DTensors, whose CUDA payloads gloo's
    functional path cannot carry (it crashes waiting on them, PyTorch
    2.11).  Each such op copies a CUDA payload to pinned host memory, runs
    the blocking ``torch.distributed`` call there, copies the result back
    (``mesh.host_staged_bytes`` counts both ways, ``mesh.staged_calls``
    the calls) and is complete on return, so no work is left for
    ``wait_tensor`` to wait on.  The kernels are installed once per
    dispatch ``key`` (the tensors' device type); a collective of any other
    group passes through to the stock kernel, so a ``device`` mesh in the
    same process keeps its backend's own path."""
    _HOST_GROUPS.update(_group_name(g) for g in groups)
    if key in _STAGED_LIBS:
        return
    import torch.distributed as dist
    from torch._C import DispatchKey
    from torch.distributed.distributed_c10d import _resolve_process_group

    from ..obs import counter

    dk = getattr(DispatchKey, key)
    functional = torch.ops._c10d_functional

    def op(name):
        return getattr(dist.ReduceOp, _REDUCE_OPS[name])

    def all_gather_into_tensor(x, group_size, group):
        h = _pinned(x.contiguous())
        out = torch.empty((group_size * h.shape[0], *h.shape[1:]),
                          dtype=h.dtype, device=h.device)
        dist.all_gather_into_tensor(out, h, group=group)
        return _back(out, x)

    def all_reduce(x, reduce_op, group):
        h = _pinned(x.contiguous())
        if h is x:
            h = x.clone()  # the functional op leaves its input as it was
        dist.all_reduce(h, op=op(reduce_op), group=group)
        return _back(h, x)

    def all_reduce_(x, reduce_op, group):
        return x.copy_(all_reduce(x, reduce_op, group))

    def reduce_scatter_tensor(x, reduce_op, group_size, group):
        h = _pinned(x.contiguous())
        out = torch.empty((h.shape[0] // group_size, *h.shape[1:]),
                          dtype=h.dtype, device=h.device)
        dist.reduce_scatter_tensor(out, h, op=op(reduce_op), group=group)
        return _back(out, x)

    def all_to_all_single(x, output_split_sizes, input_split_sizes, group):
        h = _pinned(x.contiguous())
        rows = (sum(output_split_sizes) if output_split_sizes
                else h.shape[0])
        out = torch.empty((rows, *h.shape[1:]), dtype=h.dtype,
                          device=h.device)
        dist.all_to_all_single(out, h, output_split_sizes or None,
                               input_split_sizes or None, group=group)
        return _back(out, x)

    def broadcast(x, src, group):
        h = _pinned(x.contiguous())
        if h is x:
            h = x.clone()
        dist.broadcast(h, src=src, group=group)
        return _back(h, x)

    def staged(fn):
        stock = getattr(functional, fn.__name__).default

        def impl(keyset, *args):
            name = _group_name(args[-1])
            if name not in _HOST_GROUPS:
                return stock.redispatch(keyset.remove(dk), *args)
            counter("mesh.staged_calls").inc()
            return fn(*args[:-1], _resolve_process_group(name))

        return impl

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in (all_gather_into_tensor, all_reduce, all_reduce_,
               reduce_scatter_tensor, all_to_all_single, broadcast):
        lib.impl(fn.__name__, staged(fn), key, with_keyset=True)
    _STAGED_LIBS[key] = lib


def _all_reduce_axis(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    import torch.distributed as dist

    if int(mesh.shape[axis]) == 1:
        return x  # cut path: a single shard needs no collective
    h = _to_host(x, mesh)
    if h is x:
        h = x.clone()  # all_reduce works in place; the caller keeps x
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return _back(h, x)


def all_gather(x: torch.Tensor, axis: Axes, dim: int = 0,
               mesh=None) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in
    coordinate order (the reference's ``all_gather(..., tiled=True)``);
    over a tuple of axes, the first outermost."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    for a in reversed(_axes(axis)):
        p = int(mesh.shape[a])
        if p == 1:
            continue
        h = _to_host(x.contiguous(), mesh)
        parts = [torch.empty_like(h) for _ in range(p)]
        dist.all_gather(parts, h, group=mesh.group(a))
        x = _back(torch.cat(parts, dim=dim), x)
    return x


def ppermute(x: torch.Tensor, axis: str, mesh=None,
             shift: int = 1) -> torch.Tensor:
    """Each rank sends ``x`` to the rank ``shift`` ahead on ``axis``'s ring
    and returns what the rank ``shift`` behind sent: the reference's
    ``lax.ppermute`` over ``[(i, (i + shift) % p)]``, as one
    ``batch_isend_irecv``, staged through the transport (a payload
    already on the host, as ``ring_psum``'s is, is not staged again)."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    p = int(mesh.shape[axis])
    if p == 1:
        return x
    ranks = mesh.group_ranks(axis)
    c = int(mesh.coordinate(axis))
    send = _to_host(x.contiguous(), mesh)
    recv = torch.empty_like(send)
    group = mesh.group(axis)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ranks[(c + shift) % p], group),
        dist.P2POp(dist.irecv, recv, ranks[(c - shift) % p], group),
    ])
    for r in reqs:
        r.wait()
    return _back(recv, x)


def ring_psum(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """All-reduce of ``x`` over ``axis_name`` as an explicit ring.

    Equivalent to a ``psum``: a ring reduce-scatter (``p - 1`` hops, each
    accumulating one payload chunk) followed by a ring all-gather of the
    completed chunks.  The payload is flattened and split into ``p``
    chunks; one that does not divide evenly is zero-padded, so the last
    chunk is a remainder shard.  ``p == 1`` is the cut path: the partial
    *is* the sum.  The reference's all-gather scan makes a ``p``-th hop
    whose result it discards; this one stops after the ``p - 1`` hops that
    deliver a chunk.  Under the ``host`` transport the payload is staged
    once around the whole ring.
    """
    mesh = _mesh(mesh)
    p = int(mesh.shape[axis_name])
    if p == 1:
        return x  # cut path: a single shard needs no collective
    idx = int(mesh.coordinate(axis_name))
    h = _to_host(x, mesh)
    flat = h.reshape(-1)
    n = flat.shape[0]
    chunk = -(-n // p)  # ceil division; the pad covers the remainder shard
    pad = chunk * p - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(p, chunk)
    # reduce-scatter: after p - 1 hops rank d holds the FULL sum of chunk
    # (d + 1) % p; each hop sends the running partial to the neighbour,
    # which folds in its own copy of that chunk
    carry = chunks[idx % p].clone()
    for s in range(p - 1):
        recv = ppermute(carry, axis_name, mesh)
        carry = recv + chunks[(idx - s - 1) % p]
    # all-gather: rotate the completed chunks around the ring; the chunk
    # received at hop s is the one rank idx - s - 1 completed
    out = torch.empty_like(chunks)
    out[(idx + 1) % p] = carry
    val = carry
    for s in range(p - 1):
        val = ppermute(val, axis_name, mesh)
        out[(idx - s) % p] = val
    return _back(out.reshape(p * chunk)[:n].reshape(x.shape), x)


def all_reduce(x: torch.Tensor, axis_names, collective: str = "psum",
               mesh=None) -> torch.Tensor:
    """Finish a sharded reduction over ``axis_names`` with ``collective``."""
    if collective not in STRATEGIES:
        raise ValueError(
            f"unknown collective {collective!r}; choose from {STRATEGIES}"
        )
    axes = _axes(axis_names) if axis_names else ()
    if not axes:
        return x
    mesh = _mesh(mesh)
    for ax in axes:
        x = (ring_psum(x, ax, mesh) if collective == "ring"
             else _all_reduce_axis(x, ax, mesh))
    return x


def ring_gather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                       axis_name: str, mesh=None) -> torch.Tensor:
    """x_shard (m_loc, k), w (k, n) -> the rows of ALL shards, (P * m_loc,
    n), equal to all_gather(x) @ w.

    The ring exposes the overlap: each hop's product runs while the shard
    travels to the neighbour; the naive form must finish the all-gather
    before the first flop.
    """
    mesh = _mesh(mesh)
    p = int(mesh.shape[axis_name])
    src = int(mesh.coordinate(axis_name))
    parts = [None] * p
    x_cur = x_shard
    for hop in range(p):
        parts[src] = torch.matmul(x_cur.float(), w.float())
        if hop < p - 1:
            x_cur = ppermute(x_cur, axis_name, mesh)
            src = (src - 1) % p
    return torch.cat(parts, dim=0).to(x_shard.dtype)


def naive_gather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                        axis_name: str, mesh=None) -> torch.Tensor:
    """Reference: blocking all-gather then one big product."""
    x_full = all_gather(x_shard, axis_name, dim=0, mesh=mesh)
    return torch.matmul(x_full.float(), w.float()).to(x_shard.dtype)


def world_max(values: Sequence[float]) -> List[float]:
    """The elementwise maximum of ``values`` over every rank of the
    default process group (one ``all_reduce(MAX)``), or ``values`` itself
    where no group of more than one rank is initialized.  The search's
    ranks agree on measured times through this, so that they make the
    same decision.  The tensor lives where the backend takes it: on the
    host for gloo, on the rank's card for NCCL."""
    import torch.distributed as dist

    vals = [float(v) for v in values]
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1) or not vals:
        return vals
    dev = "cpu"
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor(vals, dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [float(v) for v in t.cpu()]


__all__ = [
    "STRATEGIES",
    "TRANSPORTS",
    "all_gather",
    "all_reduce",
    "axis_index",
    "axis_size",
    "current_mesh",
    "mesh_scope",
    "naive_gather_matmul",
    "ppermute",
    "ring_gather_matmul",
    "ring_psum",
    "world_max",
]
