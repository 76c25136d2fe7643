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
    """A host copy of ``leaf`` that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
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


def save(directory: str, step: int, tree, extra: Optional[dict] = None):
    """Blocking atomic save of a tree of tensors (or a ``HostTree``)."""
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


def _restore_leaf(arr: np.ndarray, dtype_name: str, tmpl):
    dt = getattr(torch, dtype_name)
    if dt == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(tmpl, torch.Tensor):
        t = t.to(device=tmpl.device, dtype=tmpl.dtype)
    return t


def _rebuild(tmpl, flat: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    def leaf(path, t):
        key = _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr, dtype_name = flat[key]
        return _restore_leaf(arr, dtype_name, t)

    if isinstance(tmpl, dict):
        return {k: _rebuild(v, flat, prefix + (str(k),))
                for k, v in tmpl.items()}
    if isinstance(tmpl, Quantized):
        return Quantized(q=leaf(prefix + ("q",), tmpl.q),
                         scale=leaf(prefix + ("scale",), tmpl.scale),
                         shape=tmpl.shape, dtype=tmpl.dtype)
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
        return type(tmpl)(*(_rebuild(getattr(tmpl, n), flat, prefix + (n,))
                            for n in tmpl._fields))
    if isinstance(tmpl, (tuple, list)):
        return type(tmpl)(_rebuild(v, flat, prefix + (f"#{i}",))
                          for i, v in enumerate(tmpl))
    return leaf(prefix, tmpl)


def restore(directory: str, template,
            step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore into the structure (and dtypes, devices) of ``template``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: (z[k], manifest["leaves"][k]["dtype"]) for k in z.files}
    return _rebuild(template, flat), manifest


class CheckpointManager:
    """Async writer with keep-last-K retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._errors: list = []

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        self._q.put((step, to_host(tree), extra))

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
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self):
        self.wait()
        self._q.put(None)
