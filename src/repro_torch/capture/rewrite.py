"""Replay a traced function with eligible products dispatched through ops.

A port of the reference's ``capture/rewrite.py``.  ``optimize(fn)`` traces
``fn`` once per input signature (shapes, dtypes, devices, and the values
of its non-tensor arguments) into an aten graph (``harvest.trace``), then
replays it on every call: the graph is rewritten once
(``replay_module``) so that each product ``harvest.classify_dot_general``
marks dispatchable calls its ``ops`` entry point (``dense`` /
``dense_transposed`` / ``batched_dense`` / ``grouped_dense``), a matched
attention motif one ``ops.attention``, and every other node runs as
traced; the rewritten ``torch.fx.GraphModule``'s generated code runs it
(not an interpreter walking the nodes: a decode step replays thousands of
aten ops a call, so the host time a node costs matters; the generated
code drops each value after its last use).  The entry
points route through the ranked plan DB and the tuner, and their
``repro_torch.grad`` wrappers make ``loss.backward()`` of a captured loss
run the derived-spec kernels, as ``jax.grad`` does in the reference.

Higher-order structure, as the reference re-emits it:

  ==========================  ==========================================
  traced                      replay
  ==========================  ==========================================
  a layer-loop body           inline; under remat, the body's nodes run
  (``layers.scan_body``)      under ``torch.utils.checkpoint`` with the
                              policy the trace saw (the reference's
                              ``remat2`` rebuilt with ``jax.checkpoint``)
  a kernel launch             run as traced: the ``repro_torch`` op, whose
  (``repro_torch::*``)        autograd formula (``ops.library``) is the
                              wrapper's derived-spec backward (the
                              reference re-binds its ``custom_vjp``)
  ==========================  ==========================================

Numerics: a dispatched site accumulates in float32 and casts to the
product's output dtype, like every ``ops`` entry point.
"""

from __future__ import annotations

import operator
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.fx.node import map_arg
from torch.utils import _pytree as pytree

from .harvest import CaptureReport, Harvest, Traced, harvest_graph, trace


def _interpret_default() -> bool:
    """Kernel dispatch off the card needs the plain versions' interpret
    mode; ``REPRO_INTERPRET=1`` turns it on for CPU CI."""
    return os.environ.get("REPRO_INTERPRET", "") == "1"


def _register_pytrees() -> None:
    """The weight-only tier's ``Quantized`` leaves flatten to their
    tensors, so a quantized tree passes through a captured function."""
    from ..optim.quant import Quantized

    if Quantized in pytree.SUPPORTED_NODES:
        return
    pytree.register_pytree_node(
        Quantized,
        lambda q: ([q.q, q.scale], (q.shape, q.dtype)),
        lambda leaves, ctx: Quantized(leaves[0], leaves[1], *ctx),
    )


def _apply_site(site, lhs, rhs, interpret: bool, quant: Optional[str] = None):
    """Evaluate a dispatched site through its ``ops`` entry point.

    ``quant`` threads the capture-level quantization policy into the
    ``dense`` entry point only — projections are the weight-heavy sites
    the int8/fp8 tier targets; the other entry points stay full-precision
    (the quant tier is inference-oriented and has no gradient).
    """
    from .. import ops

    out_dtype = getattr(torch, site.out_dtype)
    if site.op == "dense":
        x = lhs.reshape(-1, lhs.shape[-1]) if lhs.dim() > 2 else lhs
        return ops.dense(x, rhs, out_dtype=out_dtype, interpret=interpret,
                         quant=quant)
    if site.op == "dense_transposed":
        return ops.dense_transposed(lhs, rhs, out_dtype=out_dtype,
                                    interpret=interpret)
    if site.op == "batched_dense":
        return ops.batched_dense(lhs, rhs, out_dtype=out_dtype,
                                 interpret=interpret)
    if site.op == "grouped_dense":
        b, m, d = site.lhs_shape
        return ops.grouped_dense(lhs.reshape(b * m, d), rhs, (m,) * b,
                                 out_dtype=out_dtype, interpret=interpret)
    raise AssertionError(f"unhandled capture op {site.op!r}")


def _prepare(x: torch.Tensor, summed, squeezed) -> torch.Tensor:
    """An einsum operand as its dot_general sees it: size-1 axes squeezed,
    then the axes only it holds summed out (``harvest.einsum_dot``)."""
    if squeezed:
        x = x.squeeze(squeezed)
    if summed:
        x = x.sum(dim=summed)
    return x


class _Site(torch.nn.Module):
    """A dispatched product: its operands as the dot_general sees them,
    the ``ops`` entry point, and the product's own output layout."""

    def __init__(self, prod, site, shape, interpret: bool,
                 quant: Optional[str]):
        super().__init__()
        self.form, self.site, self.shape = prod.form, site, tuple(shape)
        self.interpret, self.quant = interpret, quant

    def forward(self, lhs, rhs):
        f = self.form
        if f.swapped:
            lhs, rhs = rhs, lhs
        lhs = _prepare(lhs, f.lhs_sum, f.lhs_squeeze)
        rhs = _prepare(rhs, f.rhs_sum, f.rhs_squeeze)
        out = _apply_site(self.site, lhs, rhs, self.interpret, self.quant)
        out = out.reshape(f.out_shape)
        if f.perm is not None:
            out = out.permute(f.perm)
        return out.reshape(self.shape)


class _Motif(torch.nn.Module):
    """A matched attention chain: one ``ops.attention`` call."""

    def __init__(self, motif, interpret: bool):
        super().__init__()
        self.causal = motif.causal
        self.out_dtype = getattr(torch, motif.site.out_dtype)
        self.interpret = interpret

    def forward(self, q, k, v):
        from .. import ops

        return ops.attention(q, k, v, causal=self.causal,
                             out_dtype=self.out_dtype,
                             interpret=self.interpret)


class _Remat(torch.nn.Module):
    """A layer body's nodes, run under ``layers.remat`` with the policy
    the trace saw."""

    def __init__(self, body: torch.fx.GraphModule, policy: str):
        super().__init__()
        self.body, self.policy = body, policy

    def forward(self, *args):
        from ..models.layers import remat

        return remat(self.body, self.policy)(*args)


def replay_module(traced: Traced, h: Harvest, *, dispatch: bool,
                  interpret: bool,
                  quant: Optional[str]) -> torch.fx.GraphModule:
    """The traced graph rewritten for replay, as a ``GraphModule`` whose
    generated code runs it: each dispatched product's output node becomes
    a ``_Site`` call on the product's operands (the other nodes of its
    decomposition dropped), each dispatched attention terminal a ``_Motif``
    call on the chain's q, k and v (its interior dropped), each remat
    region a ``_Remat`` call of its nodes' own ``GraphModule``; every other
    node is copied as traced.  ``dispatch=False`` copies every node."""
    skip: set = set()
    modules: Dict[Any, torch.nn.Module] = {}
    if dispatch:
        for node, motif in h.motifs.items():
            if motif.site.dispatched:
                skip |= motif.interior
                modules[node] = _Motif(motif, interpret)
        for node, (prod, site) in h.products.items():
            if site.dispatched and node not in skip:
                skip |= prod.interior - {node}
                modules[node] = _Site(prod, site, node.meta["val"].shape,
                                      interpret, quant)
    root = torch.nn.Module()
    for node in traced.gm.graph.nodes:
        if node.op == "get_attr":
            setattr(root, node.target, getattr(traced.gm, node.target))
    count = [0]

    def inputs(node):
        if node in modules:
            m = h.motifs.get(node)
            return [m.q, m.k, m.v] if m is not None else list(
                h.products[node][0].operands)
        return list(node.all_input_nodes)

    def emit(graph, node, env):
        module = modules.get(node)
        if module is None:
            return graph.node_copy(node, lambda n: env[n])
        name = f"site{count[0]}"
        count[0] += 1
        root.add_module(name, module)
        return graph.call_module(name, tuple(env[n] for n in inputs(node)))

    starts = {r.nodes[0]: r for r in traced.regions
              if r.policy and r.nodes}
    graph = torch.fx.Graph()
    env: Dict[Any, Any] = {}
    nodes = list(traced.gm.graph.nodes)
    i = 0
    while i < len(nodes):
        node = nodes[i]
        region = starts.get(node)
        if region is None:
            i += 1
            if node in skip:
                continue
            if node.op == "output":
                graph.output(map_arg(node.args[0], lambda n: env[n]))
            else:
                env[node] = emit(graph, node, env)
            continue
        # a remat region: its nodes become one GraphModule, called under
        # the checkpoint; its inputs are what it reads from outside
        i += len(region.nodes)
        inside = set(region.nodes)
        body = [n for n in region.nodes if n not in skip]
        ins = list(dict.fromkeys(a for n in body for a in inputs(n)
                                 if a not in inside))
        outs = [n for n in body if any(u not in inside for u in n.users)]
        sub = torch.fx.Graph()
        senv = {a: sub.placeholder(a.name) for a in ins}
        for n in body:
            senv[n] = emit(sub, n, senv)
        sub.output(tuple(senv[n] for n in outs))
        name = f"region{count[0]}"
        count[0] += 1
        root.add_module(name, _Remat(torch.fx.GraphModule(root, sub),
                                     region.policy))
        call = graph.call_module(name, tuple(env[a] for a in ins))
        for k, n in enumerate(outs):
            env[n] = graph.call_function(operator.getitem, (call, k))
    return torch.fx.GraphModule(root, graph)


# ---------------------------------------------------------------------------
# the user-facing wrapper
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = ("traced", "harvest", "replays")

    def __init__(self, traced: Traced, h: Harvest):
        self.traced, self.harvest = traced, h
        self.replays: Dict[Tuple, torch.fx.GraphModule] = {}

    @property
    def report(self) -> CaptureReport:
        return self.harvest.report


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


class CapturedFunction:
    """``optimize(fn)`` result: trace-once, dispatch-per-call wrapper.

    Shape-specialized like the reference's (and ``jit``'s): the first call
    for an input signature traces ``fn`` on fake tensors and harvests its
    sites; later calls replay the rewritten graph.  The signature is the
    tree of the arguments, each tensor's shape, dtype and device (and
    whether it is fake), and the value of every other leaf, which the
    trace keeps as a constant.  Differentiable: the replay runs aten ops
    and ``ops`` entry points, each with its gradient.
    """

    def __init__(
        self, fn: Callable, *,
        interpret: Optional[bool] = None,
        dispatch: bool = True,
        label: str = "",
        quant: Optional[str] = None,
    ):
        self._fn = fn
        self._interpret = (
            _interpret_default() if interpret is None else bool(interpret)
        )
        self._dispatch = dispatch
        self._quant = quant
        self._label = label or getattr(fn, "__name__", "captured")
        self._entries: Dict[Tuple, _Entry] = {}

    # -- tracing ------------------------------------------------------------

    @staticmethod
    def _signature(leaves) -> Tuple:
        sig = []
        for a in leaves:
            if isinstance(a, torch.Tensor):
                sig.append((tuple(a.shape), str(a.dtype), str(a.device),
                            _is_fake(a)))
            else:
                try:
                    hash(a)
                    sig.append(("const", type(a).__name__, a))
                except TypeError:
                    sig.append(("const", type(a).__name__, id(a)))
        return tuple(sig)

    def _entry_for(self, args, kwargs) -> Tuple[_Entry, List[Any]]:
        _register_pytrees()
        leaves, in_tree = pytree.tree_flatten((args, kwargs))
        key = (str(in_tree), self._signature(leaves))
        entry = self._entries.get(key)
        tensors = [a for a in leaves if isinstance(a, torch.Tensor)]
        if entry is None:
            slots = [isinstance(a, torch.Tensor) for a in leaves]

            def flat_fn(*flat_in):
                it = iter(flat_in)
                full = [next(it) if s else a for s, a in zip(slots, leaves)]
                a, k = pytree.tree_unflatten(full, in_tree)
                return self._fn(*a, **k)

            from ..obs import counter, span

            with span("capture.trace", label=self._label):
                traced = trace(flat_fn, tensors)
            with span("capture.harvest", label=self._label):
                h = harvest_graph(traced, interpret=self._interpret,
                            label=self._label)
            report = h.report
            if not self._dispatch:
                for s in report.sites:
                    if s.dispatched and not s.path.endswith("@launch"):
                        s.status = "fallback"
                        s.reason = "dispatch disabled (harvest-only capture)"
            # per-signature dispatch telemetry: aggregate counts plus a
            # per-op breakdown (capture.dispatched.dense etc.)
            counter("capture.harvested").inc(report.harvested)
            counter("capture.dispatched").inc(report.dispatched)
            counter("capture.fallback").inc(report.fallback)
            for s in report.sites:
                if s.dispatched:
                    counter(f"capture.dispatched.{s.op}").inc()
            entry = _Entry(traced, h)
            self._entries[key] = entry
        return entry, tensors

    # -- calling ------------------------------------------------------------

    def __call__(self, *args, **kwargs):
        entry, tensors = self._entry_for(args, kwargs)
        key = (self._dispatch, self._interpret, self._quant)
        replay = entry.replays.get(key)
        if replay is None:
            replay = replay_module(entry.traced, entry.harvest,
                                   dispatch=self._dispatch,
                                   interpret=self._interpret,
                                   quant=self._quant)
            entry.replays[key] = replay
        outs = replay(*tensors)
        return pytree.tree_unflatten(outs, entry.traced.out_spec)

    # -- reporting ----------------------------------------------------------

    def report_for(self, *args, **kwargs) -> CaptureReport:
        """The harvest report for this input signature (traces if needed).

        Accepts real or fake tensors (``FakeTensorMode``): the trace runs
        on fake tensors either way, so nothing is allocated or launched.
        """
        return self._entry_for(args, kwargs)[0].report

    @property
    def reports(self) -> List[CaptureReport]:
        """Reports of every input signature traced so far."""
        return [e.report for e in self._entries.values()]

    @property
    def interpret(self) -> bool:
        return self._interpret


def optimize(
    fn: Callable, *,
    interpret: Optional[bool] = None,
    dispatch: bool = True,
    label: str = "",
    quant: Optional[str] = None,
) -> CapturedFunction:
    """Capture ``fn`` and dispatch its eligible products through ``ops``.

    ``interpret=None`` (default) reads ``$REPRO_INTERPRET``: on CUDA
    tensors the flag is irrelevant (every non-empty product launches its
    kernel); on the CPU it makes the reference's aligned sites reach the
    kernels' plain versions (CI/conformance mode).  ``dispatch=False``
    degrades to a pure harvest: the function replays bit for bit (every
    node run as traced) but the report still says what *would* dispatch.
    ``quant`` ('int8' | 'fp8') routes dispatched ``dense`` sites through
    the dynamic-quantized tier (``ops.dense(..., quant=...)``) — an
    inference-only policy: its kernel path has no gradient.
    """
    return CapturedFunction(
        fn, interpret=interpret, dispatch=dispatch, label=label, quant=quant
    )


def capture_report(
    fn: Callable, *args, interpret: Optional[bool] = None, label: str = "",
    **kwargs,
) -> CaptureReport:
    """One-shot harvest of ``fn`` at the given (possibly fake) inputs."""
    return CapturedFunction(
        fn, interpret=interpret, label=label
    ).report_for(*args, **kwargs)
