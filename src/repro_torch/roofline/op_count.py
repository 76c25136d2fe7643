"""Op-level cost of one traced step: the counterpart of the reference's
``roofline/hlo_parse.py``.

The reference lowers a step to HLO and parses the compiled text, finding
each ``while`` loop's trip count to multiply its body.  The port has no
HLO: it runs the step function eagerly, on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage on a device,
no kernel), under a ``TorchDispatchMode`` that sees every op the step
dispatches and a ``FlopCounterMode`` that prices the products.  A Python
loop is counted as it runs, so no trip count needs finding.

``count_step(fn, *args)`` returns the keys of the reference's
``analyze_hlo``:

* ``dot_flops``: the products' flops (``torch.utils.flop_counter``:
  ``aten.mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` and the kernels' ops of
  ``ops.library``, each with its registered formula);
* ``dot_bytes``: operands and output of each product;
* ``out_bytes_proxy``: the outputs of every other op, leaving out views,
  ``detach`` and the allocations that write nothing (``empty``);
* ``collective_bytes``: 0 on one card;
* ``n_ops``: ops dispatched;

and two of its own:

* ``saved_bytes``: the bytes live when the backward starts (its first
  autograd node runs) above those live at the step's start: the
  activations and products a train step holds for its backward, whoever
  holds them (autograd's saved tensors, a checkpoint's inputs, a
  selective checkpoint's saved products); 0 for a step with no backward;
* ``peak_live_bytes``: the highest sum of live storages over the step,
  the step's arguments included;
* ``argument_bytes``: the storages of the step's arguments.

Storages are tracked by weak reference: one is live from the op that
first returns it until Python drops its last tensor.  A storage freed
between two ops is seen freed when the next peak is taken, so the peak is
exact; the running sum may lag behind it.

A loop of identical iterations may run once for many: code that walks
equal chunks (``optim.adamw``'s 64 MiB chunks, 61 k of them for
kimi-k2's 1 T parameters) asks ``repeats(n)`` whether a count is running,
runs one chunk for ``n`` under ``repeated(n)``, and each op in it counts
``n`` times (ops, flops, bytes); the live bytes, which the iterations free
in turn, count once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..ops.library import product_batched

#: the counter of the step being counted, if any
_ACTIVE: Optional["OpCounter"] = None


def repeats(n: int) -> int:
    """How many of ``n`` identical iterations to run: 1 while a step is
    being counted (the one run then stands for all ``n``, under
    ``repeated(n)``), else ``n``."""
    return 1 if _ACTIVE is not None and n > 1 else n


@contextlib.contextmanager
def repeated(n: int):
    """Count every op inside ``n`` times (see ``repeats``)."""
    if _ACTIVE is None or n == 1:
        yield
        return
    old = _ACTIVE.times
    _ACTIVE.times = old * n
    try:
        yield
    finally:
        _ACTIVE.times = old

#: ops whose outputs write nothing the proxy should count
_NO_TRAFFIC = {
    "aten.detach", "aten.alias", "aten.lift_fresh", "aten.empty",
    "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten._local_scalar_dense",
}


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (x for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


def _is_view(func) -> bool:
    """True when every output of ``func`` aliases an input without
    writing it (a view), as the schema says."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


class OpCounter(TorchDispatchMode):
    """The dispatch mode ``count_step`` runs a step under."""

    def __init__(self):
        super().__init__()
        self.n_ops = 0
        self.dot_bytes = 0
        self.out_bytes = 0
        self._live: Dict[int, tuple] = {}  # storage cdata -> (ref, bytes)
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.base_bytes = 0
        self.saved_bytes = 0
        self._in_backward = False
        self.times = 1  # how many iterations the ops now dispatched stand for
        self.extra_flops = 0  # the repeated products' other iterations

    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count the storages of ``tensors`` live, once each."""
        for x in tensors:
            st = x.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = (StorageWeakRef(st), nbytes)
            self.live_bytes += nbytes
        if self.live_bytes > self.peak_live_bytes:
            self._sweep()
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self._live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._in_backward and torch._C._current_autograd_node() \
                is not None:
            self._in_backward = True
            self._sweep()
            self.saved_bytes = max(self.live_bytes - self.base_bytes, 0)
        out = func(*args, **kwargs)
        n = self.times
        self.n_ops += n
        name = str(func.overloadpacket)
        if product_batched(func, args) is not None:
            self.dot_bytes += n * (_bytes((args, kwargs)) + _bytes(out))
            formula = flop_registry.get(func.overloadpacket)
            if n > 1 and formula is not None:
                self.extra_flops += (n - 1) * formula(*args, **kwargs,
                                                      out_val=out)
        elif name not in _NO_TRAFFIC and not _is_view(func):
            self.out_bytes += n * _bytes(out)
        self.track(_tensors(out))
        return out


def count_step(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` under the op counter and a flop counter
    and return the counts (the module docstring's keys), with the step's
    output under ``"output"``.  Call it under a ``FakeTensorMode`` with
    fake arguments for a dry run: nothing then touches a device."""
    global _ACTIVE
    counter = OpCounter()
    counter.track(_tensors((args, kwargs)))
    counter.base_bytes = counter.live_bytes
    flops = FlopCounterMode(display=False)
    _ACTIVE = counter
    try:
        with flops, counter:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE = None
    counter._sweep()
    return {
        "dot_flops": float(flops.get_total_flops() + counter.extra_flops),
        "dot_bytes": float(counter.dot_bytes),
        "out_bytes_proxy": float(counter.out_bytes),
        "collective_bytes": 0.0,
        "n_ops": float(counter.n_ops),
        "saved_bytes": float(counter.saved_bytes),
        "peak_live_bytes": float(counter.peak_live_bytes),
        "argument_bytes": float(counter.base_bytes),
        "output": out,
    }
