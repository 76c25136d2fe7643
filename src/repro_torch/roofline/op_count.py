"""Op-level cost of one traced step: the counterpart of the reference's
``roofline/hlo_parse.py``.

The reference lowers a step to HLO and parses the compiled text, finding
each ``while`` loop's trip count to multiply its body.  The port has no
HLO: it runs the step function eagerly, on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage on a device,
no kernel), under a ``TorchDispatchMode`` that sees every op the step
dispatches and prices the products with ``torch.utils.flop_counter``'s
formulas.  A Python loop is counted as it runs, so no trip count needs
finding.

A step on DTensors (a sharded step, ``launch.steps.shard_tree``) is
counted per device, as the reference's partitioned HLO is: the mode
passes each op on DTensors on (``NotImplemented``), so DTensor turns it
into the rank's local ops and collectives, which the mode then sees.
Each ``_c10d_functional`` collective is recorded under the reference's
kinds by the bytes of its output (``COLLECTIVES``; ``count`` the number
of collectives); ``CollectiveRecorder`` records them alone, on a real
world too.

``count_step(fn, *args)`` returns the keys of the reference's
``analyze_hlo``:

* ``dot_flops``: the products' flops (``torch.utils.flop_counter``'s
  registered formula of each op that has one: ``aten.mm`` / ``addmm`` /
  ``bmm`` / ``baddbmm``, convolutions, and the kernels' ops of
  ``ops.library``);
* ``dot_bytes``: operands and output of each product;
* ``out_bytes_proxy``: the outputs of every other op, leaving out views,
  ``detach``, the allocations that write nothing (``empty``) and the
  collectives;
* ``collective_bytes``: the collectives' bytes (0 on one card), and
  ``collectives``: those bytes by kind, with ``count``;
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
from torch.utils.flop_counter import flop_registry

from ..dtensor import is_dtensor
from ..ops.library import product_batched

#: the reference's collective kinds, by the ``_c10d_functional`` ops that
#: carry them
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a ``_c10d_functional`` op, or None."""
    if func.namespace != "_c10d_functional":
        return None
    return _COLLECTIVE_KIND.get(func._schema.name.split("::")[-1])


def _on_dtensors(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


@contextlib.contextmanager
def _propagation_flagged(mode):
    """While this context is open, ``mode.propagating`` is true inside
    DTensor's sharding propagation, which runs each new op once on
    global-shaped fake tensors to learn its output's shape: work no rank
    does, so the counts leave it out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    plain = getattr(ShardingPropagator, name)

    def flagged(self, *args, **kwargs):
        mode.propagating += 1
        try:
            return plain(self, *args, **kwargs)
        finally:
            mode.propagating -= 1

    setattr(ShardingPropagator, name, flagged)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, plain)


class CollectiveRecorder(TorchDispatchMode):
    """A dispatch mode that records each collective a rank runs: bytes by
    the reference's kind (``COLLECTIVES``) and ``count``, in
    ``collectives``.  Ops on DTensors pass to DTensor, whose local ops and
    collectives the mode then sees."""

    def __init__(self):
        super().__init__()
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collectives["count"] = 0.0
        self.times = 1
        self.propagating = 0

    def __enter__(self):
        self._flag = _propagation_flagged(self)
        self._flag.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._flag.__exit__(*exc)

    def record(self, func, out) -> bool:
        kind = collective_kind(func)
        if kind is None:
            return False
        self.collectives[kind] += self.times * _bytes(out)
        self.collectives["count"] += self.times
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _on_dtensors(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not self.propagating:
            self.record(func, out)
        return out

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
    """The tensors of ``tree``; a DTensor's local shard for a DTensor."""
    return (x.to_local() if is_dtensor(x) else x for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor))


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


def _is_view(func) -> bool:
    """True when every output of ``func`` aliases an input without
    writing it (a view), as the schema says."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


class OpCounter(CollectiveRecorder):
    """The dispatch mode ``count_step`` runs a step under."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.n_ops = 0
        self.dot_bytes = 0
        self.out_bytes = 0
        self._live: Dict[int, tuple] = {}  # storage cdata -> (ref, bytes)
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.base_bytes = 0
        self.saved_bytes = 0
        self._in_backward = False

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
        if _on_dtensors(types):
            return NotImplemented
        kwargs = kwargs or {}
        if self.propagating:
            return func(*args, **kwargs)
        if not self._in_backward and torch._C._current_autograd_node() \
                is not None:
            self._in_backward = True
            self._sweep()
            self.saved_bytes = max(self.live_bytes - self.base_bytes, 0)
        out = func(*args, **kwargs)
        n = self.times
        self.n_ops += n
        name = str(func.overloadpacket)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += n * formula(*args, **kwargs, out_val=out)
        if product_batched(func, args) is not None:
            self.dot_bytes += n * (_bytes((args, kwargs)) + _bytes(out))
        elif self.record(func, out):
            pass
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
    _ACTIVE = counter
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE = None
    counter._sweep()
    colls = counter.collectives
    return {
        "dot_flops": float(counter.flops),
        "dot_bytes": float(counter.dot_bytes),
        "out_bytes_proxy": float(counter.out_bytes),
        "collective_bytes": float(sum(colls[k] for k in COLLECTIVES)),
        "collectives": dict(colls),
        "n_ops": float(counter.n_ops),
        "saved_bytes": float(counter.saved_bytes),
        "peak_live_bytes": float(counter.peak_live_bytes),
        "argument_bytes": float(counter.base_bytes),
        "output": out,
    }
