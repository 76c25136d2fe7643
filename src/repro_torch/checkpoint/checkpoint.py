"""Checkpointing: atomic, async, layout-free.

A port of the reference's ``checkpoint/checkpoint.py``.

Layout:  <dir>/step_<N>/{manifest.json, arrays.npz}
  * atomic: written to ``step_<N>.tmp`` then renamed — a crash mid-write can
    never corrupt the latest checkpoint (restart picks the previous one);
  * async: ``CheckpointManager.save_async`` copies the tree to host numpy
    arrays at once (so a training step that then updates the parameters in
    place cannot reach the copy) and hands it to a writer thread, so the
    train loop never blocks on disk;
  * layout-free: leaves are saved whole, keyed by their path in the tree
    (nested dicts, tuples and named tuples such as ``AdamWState``, and the
    ``q``/``scale`` of a ``Quantized`` moment).

npz has no bfloat16, so a bf16 leaf is stored as its bits (a ``uint16``
view) with its dtype in the manifest, and ``restore`` gives back the same
bits.  ``restore`` loads into the structure, dtypes and devices of a
template tree.

Sharded trees (DTensor leaves, ``launch.steps.shard_tree``): saving
gathers each leaf whole in the caller's thread (``full_tensor``, a
collective every rank joins), and only rank 0 writes, behind a barrier,
so the files are the same as for a tree of one device and the writer
thread issues no collective.  ``restore(shardings=, mesh=)`` is the
elastic path: each leaf is placed by its ``Placements`` on the given mesh,
whatever mesh saved it, every rank slicing its own shard from the loaded
array (no collective).
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..dtensor import is_dtensor
from ..optim.quant import Quantized

_SEP = "\x1f"


def _items(tree, prefix: Tuple[str, ...] = ()):
    """(key path, leaf) pairs of a tree of dicts, tuples, named tuples and
    ``Quantized``; a ``Quantized`` contributes its ``q`` and ``scale``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, Quantized):
        yield prefix + ("q",), tree.q
        yield prefix + ("scale",), tree.scale
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (f"#{i}",))
    else:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot reach (a
    DTensor gathered whole first)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


class HostTree(dict):
    """{key: (host array, dtype name)}: a tree flattened to host copies."""


def to_host(tree) -> HostTree:
    """Every leaf of ``tree`` as a host copy, keyed by its path."""
    return HostTree((_SEP.join(path), (_host(leaf), _dtype_name(leaf)))
                    for path, leaf in _items(tree))


def _sharded(tree) -> bool:
    return any(is_dtensor(leaf) for _, leaf in _items(tree))


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a world, or a
    process in none."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or (
        dist.get_rank() == 0)


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def save(directory: str, step: int, tree, extra: Optional[dict] = None):
    """Blocking atomic save of a tree of tensors (or a ``HostTree``).  A
    tree with DTensor leaves is gathered by every rank and written by rank
    0; every rank returns once it is on disk."""
    if not isinstance(tree, HostTree) and _sharded(tree):
        host = to_host(tree)
        final = save(directory, step, host, extra) if _writer() else None
        _barrier()
        return final or os.path.join(directory, f"step_{step}")
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    host = tree if isinstance(tree, HostTree) else to_host(tree)
    arrays = {k: (a.view(np.uint16) if dt == "bfloat16" else a)
              for k, (a, dt) in host.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {
            k: {"shape": list(a.shape), "dtype": dt}
            for k, (a, dt) in host.items()
        },
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_", 1)[1]))
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, dtype_name: str, tmpl, placement=None):
    dt = getattr(torch, dtype_name)
    if dt == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(tmpl, torch.Tensor):
        device = tmpl.device
        if placement is not None:
            device = placement[0].device_type
        t = t.to(device=device, dtype=tmpl.dtype)
    if placement is not None:
        from torch.distributed.tensor import distribute_tensor

        mesh, pl = placement
        # every rank holds the loaded array: each slices its own shard
        t = distribute_tensor(t, mesh, list(pl), src_data_rank=None)
    return t


def _rebuild(tmpl, flat: Dict[str, Any], prefix: Tuple[str, ...] = (),
             shardings=None, mesh=None):
    def leaf(path, t, pl):
        key = _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr, dtype_name = flat[key]
        return _restore_leaf(arr, dtype_name, t,
                             None if pl is None else (mesh, pl))

    def sub(s, k):
        if s is None:
            return None
        if isinstance(s, dict) or (isinstance(s, (tuple, list))
                                   and not hasattr(s, "_fields")):
            return s[k]
        return getattr(s, k)

    if isinstance(tmpl, dict):
        return {k: _rebuild(v, flat, prefix + (str(k),), sub(shardings, k),
                            mesh)
                for k, v in tmpl.items()}
    if isinstance(tmpl, Quantized):
        return Quantized(
            q=leaf(prefix + ("q",), tmpl.q, sub(shardings, "q")),
            scale=leaf(prefix + ("scale",), tmpl.scale,
                       sub(shardings, "scale")),
            shape=tmpl.shape, dtype=tmpl.dtype)
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
        return type(tmpl)(*(_rebuild(getattr(tmpl, n), flat, prefix + (n,),
                                     sub(shardings, n), mesh)
                            for n in tmpl._fields))
    if isinstance(tmpl, (tuple, list)):
        return type(tmpl)(_rebuild(v, flat, prefix + (f"#{i}",),
                                   sub(shardings, i), mesh)
                          for i, v in enumerate(tmpl))
    return leaf(prefix, tmpl, shardings)


def restore(directory: str, template, step: Optional[int] = None,
            shardings=None, mesh=None) -> Tuple[Any, dict]:
    """Restore into the structure (and dtypes, devices) of ``template``.

    ``shardings`` (a matching tree of ``Placements``, ``launch.sharding``)
    with ``mesh`` (a ``launch.mesh.Mesh``) re-shards: every leaf becomes a
    DTensor placed on ``mesh`` -- whatever mesh, or none, saved it -- with
    each rank slicing its shard from the loaded array, on the mesh's
    device.  Without them the leaves are plain tensors on the template's
    devices."""
    if (shardings is None) != (mesh is None):
        raise ValueError("restore takes shardings and mesh together")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: (z[k], manifest["leaves"][k]["dtype"]) for k in z.files}
    dm = None if mesh is None else mesh.device_mesh
    return _rebuild(template, flat, shardings=shardings, mesh=dm), manifest


class CheckpointManager:
    """Async writer with keep-last-K retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._errors: list = []
        self._saw_sharded = False  # a DTensor tree was saved

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        """Copy ``tree`` to the host now (a sharded tree is gathered here,
        in the caller's thread, by every rank) and write it in the
        background: on rank 0 only where the tree is sharded, which the
        other ranks skip."""
        sharded = _sharded(tree)
        self._saw_sharded |= sharded
        host = to_host(tree)
        if sharded and not _writer():
            return
        self._q.put((step, host, extra))

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, host, extra = item
                save(self.directory, step, host, extra)
                self._gc()
            except Exception as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(n.split("_", 1)[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s}"), ignore_errors=True
            )

    def wait(self):
        """Block until every queued save is on disk; after a sharded save,
        every rank waits for rank 0's writer (a barrier), so any rank may
        read the checkpoint then."""
        self._q.join()
        if self._saw_sharded:
            _barrier()
        if self._errors:
            raise self._errors[0]

    def close(self):
        self.wait()
        self._q.put(None)
