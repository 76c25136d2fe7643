"""Device meshes over the ranks of a ``torch.distributed`` world.

A port of the reference's ``launch/mesh.py``.  Where the reference's mesh
is a grid of a host's devices, the port's is a grid of *ranks*: one process
each, joined by ``torch.distributed``.  ``Mesh`` wraps
``torch.distributed.device_mesh.DeviceMesh`` and keeps the reference's
surface (``axis_names``, ``shape`` as axis -> size, ``devices`` as the
grid of global ranks, ``size``), so the sharding rules and the plan-key
qualifier read it as they read a ``jax.sharding.Mesh``.  Each axis is a
process group (``group``), along which this rank has a ``coordinate``.

The world comes from the caller or from ``torchrun``-style variables:
``init_world`` joins the default process group from ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (or an ``init_method``
the caller gives), always with a ``timeout``; ``spawn_ranks`` starts a
world of spawned processes that meet on a ``FileStore`` (the tests, and
the card smoke's ranks that share one card).

The payload ``transport`` is fixed when the mesh is made, never probed:
``"device"`` (the default) hands tensors to the backend as they are, as
NCCL takes CUDA tensors; ``"host"`` stages CUDA payloads through pinned
host memory around each collective, for gloo (``codegen.collectives``),
DTensor's redistributions on a CUDA mesh included.

``make_production_mesh`` gives the reference's production shapes --
(data 16, model 16) and (pod 2, data 16, model 16) -- as a real ``Mesh``
where a world of that size is up, as ``fake_world`` makes one in a single
process for the dry-run, and otherwise as shapes only (``MeshShape``: no
process group), which the sharding rules read.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import math
import os
import pickle
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..codegen.collectives import TRANSPORTS, current_mesh, mesh_scope

#: seconds a process group's collectives wait before they raise
DEFAULT_TIMEOUT_S = 300.0


class MeshShape:
    """A mesh's shape without ranks: ``axis_names``, ``shape`` (axis ->
    size), ``devices`` (a grid of positions) and ``size``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             f"in rank")
        self.axis_names = axes
        self.shape = collections.OrderedDict(zip(axes, shape))
        self.devices = np.arange(math.prod(shape)).reshape(shape)
        self.size = int(math.prod(shape))

    def __repr__(self) -> str:
        return (f"{type(self).__name__}("
                f"{dict(self.shape)})")


class Mesh(MeshShape):
    """A mesh over the ranks of the default process group: rank r sits at
    the position of r in the row-major grid ``devices``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 transport: str = "device", device=None):
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        super().__init__(shape, axes)
        if transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                             f"{transport!r}")
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs the default process group: "
                               "call launch.mesh.init_world first")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"a {mesh_shape_descriptor(self)} mesh needs "
                             f"{self.size} ranks, the world has {world}")
        self.transport = transport
        self.rank = dist.get_rank()
        if device is None:
            device = "cpu"
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the rank's card: the one named, else LOCAL_RANK's (torchrun),
            # else the current one; made current before the mesh's groups
            index = self.device.index
            if index is None:
                index = int(os.environ.get("LOCAL_RANK",
                                           torch.cuda.current_device()))
            self.device = torch.device("cuda", index)
            torch.cuda.set_device(self.device)
        self.device_mesh = DeviceMesh(
            self.device.type, torch.as_tensor(self.devices),
            mesh_dim_names=self.axis_names)
        if self.device.type == "cuda" and transport == "host":
            # DTensors on this mesh redistribute through the host too: its
            # axes' groups and the world (the optimizer's norm)
            from ..codegen.collectives import stage_functional_collectives

            stage_functional_collectives(
                [self.group(a) for a in self.axis_names]
                + [dist.group.WORLD])
        self._coords = tuple(int(c) for c in
                             np.argwhere(self.devices == self.rank)[0])

    def group(self, axis: str):
        """The process group of the ranks that share every coordinate but
        ``axis``'s with this one."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis: str) -> int:
        return self._coords[self.axis_names.index(axis)]

    def group_ranks(self, axis: str) -> Tuple[int, ...]:
        """The global ranks of ``group(axis)``, by coordinate."""
        idx = list(self._coords)
        idx[self.axis_names.index(axis)] = slice(None)
        return tuple(int(r) for r in self.devices[tuple(idx)])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, rank={self.rank}, "
                f"transport={self.transport!r}, device={self.device})")


def init_world(backend: Optional[str] = None, *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[int, int]:
    """Join the default process group if the process is not in one yet;
    returns (rank, world size).

    ``rank`` / ``world_size`` come from the arguments or from ``RANK`` /
    ``WORLD_SIZE``; ``init_method`` defaults to ``env://`` (``MASTER_ADDR``
    and ``MASTER_PORT``).  Where neither names a world, the process is a
    world of one, joined on an in-memory store.  ``backend`` defaults to
    gloo.  Every group is made with ``timeout_s``, so a rank that never
    arrives fails its peers instead of hanging them.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    timeout = datetime.timedelta(seconds=timeout_s)
    backend = backend or "gloo"
    if rank is None and world_size is None and init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank or 0, world_size=world_size or 1,
                                timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    """Ranks in the default process group (1 where there is none)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


_MESHES: Dict[tuple, Mesh] = {}


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), *,
                    backend: Optional[str] = None, transport: str = "device",
                    device=None) -> Mesh:
    """A mesh of ``shape`` over the world's ranks (which must number
    ``prod(shape)``; ``init_world`` joins one with ``backend`` first where
    the process is in none).  ``transport`` as in ``Mesh``; ``device`` is
    this rank's compute device (default the CPU).  One mesh is kept per
    (shape, axes, transport, device): making it creates a process group
    per axis, which every rank must do in the same order."""
    init_world(backend)
    key = (tuple(int(s) for s in shape), tuple(axes), transport, str(device))
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = Mesh(shape, axes, transport=transport,
                                   device=device)
    return mesh


def world_mesh(mesh_shape, *, transport: str = "device", device=None,
                 what: str = "serve"):
    """The mesh of ``mesh_shape`` (data x model; a leading pod axis for
    three) over the world's ranks when the world holds exactly that many,
    else None with a log line: the caller (``serve``, ``sweep``) then
    sweeps mesh plans for the fleet and runs single-rank, as the
    reference does with too few devices.  A process launched by
    ``torchrun`` (``WORLD_SIZE`` set) joins its world first."""
    from ..obs import log
    from ..search.space import mesh_axis_names

    shape = tuple(int(s) for s in mesh_shape)
    if "WORLD_SIZE" in os.environ:
        init_world()
    world = world_size()
    if world == math.prod(shape):
        return make_debug_mesh(shape, mesh_axis_names(len(shape)),
                               transport=transport, device=device)
    then = ("serving single-rank" if what == "serve"
            else "sharded candidates keep their analytic rank")
    log.info(what, f"--mesh {'x'.join(map(str, shape))}: {world} rank(s) "
             f"in the world; sweeping mesh plans for the fleet, {then}")
    return None


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production shapes: (data 16, model 16), 256 chips,
    or (pod 2, data 16, model 16), 512.  A real ``Mesh`` over the world
    where one of that size is up (``fake_world`` for a dry-run; ``device``
    as in ``Mesh``), else shapes only (``MeshShape``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if world_size() == math.prod(shape):
        return make_debug_mesh(shape, axes, device=device)
    return MeshShape(shape, axes)


@contextlib.contextmanager
def fake_world(n: int):
    """A world of ``n`` ranks in which this process is rank 0 and every
    collective returns at once without moving data: PyTorch's ``fake``
    process group (``FakeStore``).  A dry-run traces one rank's share of a
    step over a pod this way, on fake tensors.  The group, and every mesh
    made over it, is destroyed on exit, so no default group outlives the
    context."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a default "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        _MESHES.clear()
        dist.destroy_process_group()


def batch_axes(mesh) -> tuple:
    """Mesh axes that carve the global batch (pod+data when present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def set_mesh(mesh):
    """Context manager making ``mesh`` the active one for its body
    (``None``: no change): ``ops`` then consults the mesh-qualified plans
    (``active_mesh``)."""
    return mesh_scope(mesh)


def axis_size(axis_name: str, mesh=None) -> int:
    """Ranks along ``axis_name`` of ``mesh`` (default the active one)."""
    from ..codegen.collectives import axis_size as _axis_size

    return _axis_size(axis_name, mesh)


def active_mesh():
    """The mesh the caller runs under (``set_mesh``), or None -- also for
    a mesh of one rank, as the reference's lookup of a set global mesh
    returns only one of size > 1.  ``ops._tuned_kernel`` consults this to
    decide whether a mesh-qualified plan lookup applies."""
    mesh = current_mesh()
    if mesh is None or getattr(mesh, "size", 0) <= 1:
        return None
    return mesh


def mesh_shape_descriptor(mesh) -> str:
    """'2x4'-style descriptor of a mesh (the plan-key qualifier)."""
    return "x".join(str(int(s)) for s in mesh.devices.shape)


# ---------------------------------------------------------------------------
# spawned worlds
# ---------------------------------------------------------------------------


def _rank_main(rank, fn, world, store, backend, timeout_s, out_dir,
               threads, args):
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    init_world(backend, rank=rank, world_size=world,
               init_method=f"file://{store}", timeout_s=timeout_s)
    try:
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: tuple = (), *,
                store_dir: Optional[str] = None, backend: str = "gloo",
                timeout_s: float = DEFAULT_TIMEOUT_S,
                threads: Optional[int] = None) -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned processes joined in one
    process group; returns each rank's (picklable) result, by rank.

    The ranks meet on a ``FileStore`` in a fresh directory under
    ``store_dir`` (no TCP port, so several worlds can run at once).  A rank
    that raises fails the call with its traceback, and one that has not
    finished within ``timeout_s`` fails it with ``TimeoutError``; either
    way every process is stopped before this returns.  ``fn`` must be a
    module-level function (``spawn`` imports it by name); ``threads`` sets
    each rank's intra-op threads.
    """
    import torch.multiprocessing as mp

    root = tempfile.mkdtemp(prefix="ranks-", dir=store_dir)
    store = os.path.join(root, "store")
    ctx = mp.start_processes(
        _rank_main,
        args=(fn, world, store, backend, timeout_s, root, threads, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} did not "
                                   f"finish within {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


__all__ = [
    "DEFAULT_TIMEOUT_S",
    "Mesh",
    "MeshShape",
    "active_mesh",
    "axis_size",
    "batch_axes",
    "fake_world",
    "init_world",
    "make_debug_mesh",
    "make_production_mesh",
    "world_mesh",
    "mesh_shape_descriptor",
    "set_mesh",
    "spawn_ranks",
    "world_size",
]
