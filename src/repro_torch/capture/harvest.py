"""Graph-level GEMM harvest: every product of a traced function becomes a
ContractionSpec.

A port of the reference's ``capture/harvest.py``.  The reference walks a
jaxpr; here a function is traced into an aten graph with
``torch.fx.experimental.proxy_tensor.make_fx`` (on fake tensors: no
storage, no kernel), and the trace records three things beside the graph:

* every *product* the function calls at the torch level (``torch.einsum``,
  ``torch.matmul`` / ``@``, ``torch.mm``, ``torch.bmm``): its operands'
  nodes, the nodes its aten decomposition made (permutes, views and one
  ``mm`` / ``bmm``) and its output node.  A product stands for one
  ``dot_general`` of the reference: ``einsum_dot`` and ``matmul_dot``
  give its operands and dimension numbers exactly as ``jnp.einsum`` /
  ``jnp.dot`` lower them, so the classifier sees what the reference's
  does;
* every *region*, one call of a layer loop's body (``models.layers.
  scan_body``, the reference's ``lax.scan`` body), so the report lists a
  body's sites once, as the reference's walk of a scan body does;
* every launch already made by a kernel (``repro_torch::contract`` /
  ``attention`` / ``grouped`` / ``grouped_dw``, ``ops.library``), the
  counterpart of the reference's ``custom_vjp`` sites: already kernels,
  reported as dispatched and replayed as they are.

``classify_dot_general`` applies the reference's layout rules, verdicts
and reason strings, with the port's own kernel predicates
(``ops._dense_kernel_ok`` and the rest): "dispatched" means the ``ops``
entry point launches its kernel for those shapes on that device (any
non-empty dense product on a CUDA tensor; off the card with
``interpret``, the reference's 128-alignment gate).  The attention motif
(fold heads, QK^T, scale, optional iota causal mask, max-shift, exp, P.V,
divide by the row sum) becomes one ``attention`` site, and a batched
product whose lhs a scatter-family op wrote (``index_put_``,
``index_add_``, ``scatter*``: the MoE dispatch) a ``grouped_dense`` one.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

from ..core.enumerate import (
    ContractionSpec,
    attention_spec,
    batched_matmul_spec,
    grouped_matmul_spec,
    matmul_spec,
    transposed_matmul_spec,
)

#: dtypes the generated-kernel pipeline stores/accumulates correctly
SUPPORTED_DTYPES = ("float32", "bfloat16")

#: the torch-level calls a trace records as products
PRODUCT_FUNCS = frozenset({"einsum", "matmul", "__matmul__", "mm", "bmm"})


@dataclasses.dataclass
class CaptureSite:
    """One product of the traced function."""

    site_id: int
    path: str                  # node trail, e.g. "seg0/remat/node12"
    lhs_shape: Tuple[int, ...]
    rhs_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    dtype: str
    out_dtype: str
    dimension_numbers: Any
    op: Optional[str] = None   # dense | dense_transposed | batched_dense | ...
    spec: Optional[ContractionSpec] = None
    status: str = "fallback"   # dispatched | fallback
    reason: str = ""           # why a fallback site fell back

    @property
    def dispatched(self) -> bool:
        return self.status == "dispatched"

    def as_dict(self) -> Dict[str, Any]:
        return {
            "site_id": self.site_id,
            "path": self.path,
            "lhs_shape": list(self.lhs_shape),
            "rhs_shape": list(self.rhs_shape),
            "out_shape": list(self.out_shape),
            "dtype": self.dtype,
            "out_dtype": self.out_dtype,
            "op": self.op,
            "spec": None if self.spec is None else self.spec.name,
            "extents": None if self.spec is None else dict(self.spec.extents),
            "status": self.status,
            "reason": self.reason,
        }


def spec_key(spec: ContractionSpec, dtype: str) -> Tuple:
    """Plan-key granularity for deduplicating harvested GEMM sites — the
    single home of this tuple (report dedup, model sweeps, serve warmup
    all key on it)."""
    return (spec.name, tuple(sorted(spec.extents.items())), str(dtype))


@dataclasses.dataclass
class CaptureReport:
    """Per-site accounting for one captured function."""

    label: str = ""
    sites: List[CaptureSite] = dataclasses.field(default_factory=list)

    @property
    def harvested(self) -> int:
        return len(self.sites)

    @property
    def dispatched(self) -> int:
        return sum(1 for s in self.sites if s.dispatched)

    @property
    def fallback(self) -> int:
        return self.harvested - self.dispatched

    def dispatched_sites(self) -> List[CaptureSite]:
        return [s for s in self.sites if s.dispatched]

    def unique_specs(self) -> List[Tuple[ContractionSpec, str]]:
        """Deduplicated (spec, dtype) pairs of the dispatched sites — the
        sweepable GEMM set of this function (plan-DB key granularity)."""
        seen: Dict[Tuple, Tuple[ContractionSpec, str]] = {}
        for s in self.sites:
            if s.spec is None or not s.dispatched:
                continue
            seen.setdefault(spec_key(s.spec, s.dtype), (s.spec, s.dtype))
        return list(seen.values())

    def summary(self) -> str:
        return (
            f"capture[{self.label or '?'}]: {self.harvested} site(s) "
            f"harvested, {self.dispatched} dispatched, "
            f"{self.fallback} fallback"
        )

    def as_dict(self) -> Dict[str, Any]:
        return {
            "label": self.label,
            "harvested": self.harvested,
            "dispatched": self.dispatched,
            "fallback": self.fallback,
            "sites": [s.as_dict() for s in self.sites],
        }

    def to_json(self, **kwargs) -> str:
        kwargs.setdefault("indent", 2)
        kwargs.setdefault("sort_keys", True)
        return json.dumps(self.as_dict(), **kwargs)


# ---------------------------------------------------------------------------
# classification — shared with capture.rewrite
# ---------------------------------------------------------------------------


def dtype_name(dtype) -> str:
    """numpy's spelling of a torch or numpy dtype ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return getattr(dtype, "name", None) or str(dtype)


class _Shaped:
    """What the ``ops`` dispatch predicates read of a tensor: its shape,
    rank, size and whether it lies on the card."""

    __slots__ = ("shape", "ndim", "is_cuda")

    def __init__(self, shape, device="cpu"):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)
        self.is_cuda = torch.device(device).type == "cuda"

    def dim(self) -> int:
        return self.ndim

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _device(aval) -> str:
    return str(getattr(aval, "device", "cpu"))


def classify_dot_general(
    lhs_aval, rhs_aval, out_aval, params: Dict[str, Any], *,
    interpret: bool, site_id: int = 0, path: str = "",
    grouped_lhs: bool = False,
) -> CaptureSite:
    """Map one product to a ContractionSpec + dispatch verdict.

    The avals carry ``shape`` and ``dtype`` (and ``device``, the CPU when
    absent); ``params["dimension_numbers"]`` is the reference's
    ``((lhs_contract, rhs_contract), (lhs_batch, rhs_batch))``.  Eligible
    layouts (everything else falls back untouched):

      * ``(..., M, D) @ (D, F)`` contracting the last lhs axis with the
        first rhs axis, no batch dims -> ``matmul`` (leading lhs axes are
        flattened into M);
      * ``(D, M) @ (D, F)`` contracting axis 0 with axis 0 ->
        ``transposed_matmul`` (the weight-gradient layout);
      * ``(B, M, D) @ (B, D, F)`` batched on axis 0 -> ``batched_matmul``,
        or ``grouped_matmul`` with uniform groups where a scatter wrote
        the lhs (``grouped_lhs``).

    The verdict then applies the ``ops`` kernel predicates, so
    "dispatched" means "the equivalent ops entry point launches its
    kernel here" — device, alignment and dtype included.
    """
    from .. import ops

    (lc, rc), (lb, rb) = params["dimension_numbers"]
    device = _device(lhs_aval)
    on_card = torch.device(device).type == "cuda"
    site = CaptureSite(
        site_id=site_id,
        path=path,
        lhs_shape=tuple(lhs_aval.shape),
        rhs_shape=tuple(rhs_aval.shape),
        out_shape=tuple(out_aval.shape),
        dtype=dtype_name(lhs_aval.dtype),
        out_dtype=dtype_name(out_aval.dtype),
        dimension_numbers=params["dimension_numbers"],
    )
    no_kernel = "cpu backend without interpret mode"

    if dtype_name(lhs_aval.dtype) != dtype_name(rhs_aval.dtype):
        site.reason = (
            f"mixed operand dtypes {dtype_name(lhs_aval.dtype)}/"
            f"{dtype_name(rhs_aval.dtype)}"
        )
        return site
    if site.dtype not in SUPPORTED_DTYPES:
        site.reason = f"unsupported dtype {site.dtype}"
        return site

    ln, rn = len(site.lhs_shape), len(site.rhs_shape)
    lc, rc, lb, rb = tuple(lc), tuple(rc), tuple(lb), tuple(rb)

    if not lb and rn == 2 and rc == (0,) and ln >= 2 and lc == (ln - 1,):
        # (..., M, D) @ (D, F): the workhorse dense layout
        d = site.lhs_shape[-1]
        m = 1
        for s in site.lhs_shape[:-1]:
            m *= s
        f = site.rhs_shape[1]
        site.op = "dense"
        site.spec = matmul_spec(m, d, f)
        if ops._dense_kernel_ok(_Shaped((m, d), device),
                                _Shaped((d, f), device), interpret):
            site.status = "dispatched"
        elif not (on_card or interpret):
            site.reason = no_kernel
        elif on_card:
            site.reason = f"empty dense product (M,D,F)=({m},{d},{f})"
        else:
            site.reason = (
                f"dense kernel needs 128-aligned (M,D,F)=({m},{d},{f})"
            )
        return site

    if not lb and ln == 2 and rn == 2 and lc == (0,) and rc == (0,):
        # (D, M) @ (D, F) -> (M, F): stored-transposed contraction
        d, m = site.lhs_shape
        f = site.rhs_shape[1]
        site.op = "dense_transposed"
        site.spec = transposed_matmul_spec(m, d, f)
        if ops._generic_kernel_ok(_Shaped((d, m), device), interpret):
            site.status = "dispatched"
        else:
            site.reason = no_kernel
        return site

    if (
        lb == (0,) and rb == (0,) and ln == 3 and rn == 3
        and lc == (2,) and rc == (1,)
    ):
        b, m, d = site.lhs_shape
        f = site.rhs_shape[2]
        if grouped_lhs:
            # the lhs rows were routed here by a scatter (MoE dispatch):
            # expert slab b of the rhs multiplies only its row block, the
            # uniform-group case of the ragged grouped GEMM
            site.op = "grouped_dense"
            site.spec = grouped_matmul_spec((m,) * b, d, f)
            if ops._grouped_kernel_ok(_Shaped((b * m, d), device),
                                      interpret):
                site.status = "dispatched"
            else:
                site.reason = no_kernel
            return site
        site.op = "batched_dense"
        site.spec = batched_matmul_spec(b, m, d, f)
        if ops._batched_kernel_ok(_Shaped((b, m, d), device),
                                  _Shaped((b, d, f), device), interpret):
            site.status = "dispatched"
        else:
            site.reason = no_kernel
        return site

    site.reason = (
        f"unsupported contraction layout ndim=({ln},{rn}) "
        f"contract=({lc},{rc}) batch=({lb},{rb})"
    )
    return site


# ---------------------------------------------------------------------------
# a torch-level product as the reference's dot_general
# ---------------------------------------------------------------------------


class Unsupported(ValueError):
    """A product no ``dot_general`` of the reference's stands for."""


@dataclasses.dataclass
class DotForm:
    """One product as a ``dot_general``: which operand is its lhs, what
    each operand undergoes first (``jnp.einsum``'s squeeze of size-1 axes
    and sum of axes only it holds), the dimension numbers, and the
    permutation from the dot's output axes to the product's (``perm``,
    before the final reshape to the product's output shape)."""

    swapped: bool
    lhs_sum: Tuple[int, ...]
    lhs_squeeze: Tuple[int, ...]
    rhs_sum: Tuple[int, ...]
    rhs_squeeze: Tuple[int, ...]
    lhs_shape: Tuple[int, ...]
    rhs_shape: Tuple[int, ...]
    dimension_numbers: Any
    out_shape: Tuple[int, ...]
    perm: Optional[Tuple[int, ...]] = None
    broadcast: str = ""


def _remove(names: str, drop) -> str:
    return "".join(c for c in names if c not in drop)


def einsum_dot(equation: str, lhs_shape: Sequence[int],
               rhs_shape: Sequence[int]) -> DotForm:
    """The ``dot_general`` ``jnp.einsum`` emits for a two-operand einsum
    (``jax/_src/numpy/einsum.py``'s ``_einsum``, after ``opt_einsum``'s
    path, which pops the second operand first): size-1 axes whose name the
    other operand holds at another size are squeezed, names only one
    operand holds and the output lacks are summed out of it, batch names
    are taken in output order and contracted names sorted, and the dot
    takes the first operand first where that order needs no transpose of
    its output, else the second first (``swapped``)."""
    eq = equation.replace(" ", "")
    if "..." in eq:
        raise Unsupported(f"einsum with an ellipsis ({equation})")
    if "->" in eq:
        ins, result = eq.split("->")
    else:
        ins = eq
        letters = ins.replace(",", "")
        result = "".join(sorted(c for c in set(letters)
                                if letters.count(c) == 1))
    names = ins.split(",")
    if len(names) != 2:
        raise Unsupported(f"einsum of {len(names)} operands ({equation})")
    for n, shp in zip(names, (lhs_shape, rhs_shape)):
        if len(set(n)) != len(n) or len(n) != len(shp):
            raise Unsupported(f"einsum with a repeated or missing index "
                              f"({equation})")
    contracted = sorted(set(names[0] + names[1]) - set(result))

    def squeeze(shape, names_, other_shape, other_names):
        sq = [i for i, c in enumerate(names_)
              if shape[i] == 1 and other_names.find(c) != -1
              and other_shape[other_names.find(c)] != 1]
        keep = [i for i in range(len(names_)) if i not in sq]
        return (tuple(sq), tuple(shape[i] for i in keep),
                "".join(names_[i] for i in keep))

    # jnp.einsum's lhs is the second operand (b), its rhs the first (a)
    bsq, bshape, bnames = squeeze(tuple(rhs_shape), names[1],
                                  tuple(lhs_shape), names[0])
    asq, ashape, anames = squeeze(tuple(lhs_shape), names[0], bshape, bnames)
    asum = tuple(anames.index(c) for c in contracted
                 if c in anames and c not in bnames)
    bsum = tuple(bnames.index(c) for c in contracted
                 if c in bnames and c not in anames)
    ashape = tuple(x for i, x in enumerate(ashape) if i not in asum)
    anames = _remove(anames, [anames[i] for i in asum])
    bshape = tuple(x for i, x in enumerate(bshape) if i not in bsum)
    bnames = _remove(bnames, [bnames[i] for i in bsum])

    both = set(anames) & set(bnames)
    contracted = [c for c in contracted if c in both]
    batch = "".join(c for c in result if c in both)
    deleted = batch + "".join(contracted)
    rem_a, rem_b = _remove(anames, deleted), _remove(bnames, deleted)
    size = dict(zip(anames, ashape))
    size.update(zip(bnames, bshape))

    def dims(xn, yn):
        return ((tuple(xn.index(c) for c in contracted),
                 tuple(yn.index(c) for c in contracted)),
                (tuple(xn.index(c) for c in batch),
                 tuple(yn.index(c) for c in batch)))

    swapped = batch + rem_a + rem_b != result
    if not swapped:
        out_names = batch + rem_a + rem_b
        form = DotForm(False, asum, asq, bsum, bsq, ashape, bshape,
                       dims(anames, bnames),
                       tuple(size[c] for c in out_names))
    else:
        out_names = batch + rem_b + rem_a
        form = DotForm(True, bsum, bsq, asum, asq, bshape, ashape,
                       dims(bnames, anames),
                       tuple(size[c] for c in out_names))
    order = [c for c in result if c in out_names]
    perm = tuple(out_names.index(c) for c in order)
    form.perm = None if perm == tuple(range(len(perm))) else perm
    return form


def matmul_dot(kind: str, lhs_shape: Sequence[int],
               rhs_shape: Sequence[int]) -> DotForm:
    """The ``dot_general`` of ``torch.matmul`` / ``mm`` / ``bmm``, as
    ``jnp.dot`` / ``jnp.matmul`` emit it: a 2-D rhs contracts the lhs's
    last axis with its first and no batch axes; equal-rank operands of
    rank three or more are batched over their leading axes."""
    ls, rs = tuple(lhs_shape), tuple(rhs_shape)
    ln, rn = len(ls), len(rs)
    broadcast = ""
    if kind == "mm" or (ln >= 1 and rn == 2):
        dims = (((ln - 1,), (0,)), ((), ()))
        out = ls[:-1] + rs[1:]
    elif rn == 1:
        dims = (((ln - 1,), (0,)), ((), ()))
        out = ls[:-1]
    elif ln == 1:
        dims = (((0,), (rn - 2,)), ((), ()))
        out = rs[:-2] + rs[-1:]
    else:
        nb = min(ln, rn) - 2
        lb = tuple(range(ln - 2 - nb, ln - 2))
        rb = tuple(range(rn - 2 - nb, rn - 2))
        dims = (((ln - 1,), (rn - 2,)), (lb, rb))
        if ln != rn or any(ls[i] != rs[j] for i, j in zip(lb, rb)):
            broadcast = f"broadcast batch dims {ls[:-2]}/{rs[:-2]}"
        batch = tuple(max(ls[i], rs[j]) for i, j in zip(lb, rb))
        out = batch + ls[-2:-1] + rs[-1:]
    return DotForm(False, (), (), (), (), ls, rs, dims, out,
                   broadcast=broadcast)


# ---------------------------------------------------------------------------
# the trace: graph + products + regions
# ---------------------------------------------------------------------------

#: the ``repro_torch`` ops (``ops.library``): a launch already on a kernel,
#: by op name -> the ``ops`` entry its spec's family goes through
_LAUNCH_OPS = {"contract", "attention", "grouped", "grouped_dw"}
_FAMILY_OP = {"matmul": "dense", "transposed_matmul": "dense_transposed",
              "batched_matmul": "batched_dense",
              "grouped_matmul": "grouped_dense", "attention": "attention"}


@dataclasses.dataclass(eq=False)
class Product:
    """One torch-level product call of the trace."""

    kind: str                       # einsum | matmul | mm | bmm
    operands: Tuple[Any, Any]       # the operands' nodes
    out: Any                        # the output's node
    interior: frozenset             # nodes its decomposition made (out too)
    form: Optional[DotForm] = None
    unsupported: str = ""


@dataclasses.dataclass(eq=False)
class Region:
    """One call of a layer loop's body (``layers.scan_body``)."""

    name: str
    policy: Optional[str]           # the remat policy, None if unchecked
    nodes: List[Any]
    instance: int                   # 0 for the first call of this body


def _last_node(graph):
    return next(iter(reversed(graph.nodes)), None)


def _nodes_after(graph, before) -> List[Any]:
    out = []
    n = graph._root.next if before is None else before.next
    while n is not graph._root:
        out.append(n)
        n = n.next
    return out


class _Recorder(TorchFunctionMode):
    """Records the products and regions of a ``make_fx`` trace."""

    def __init__(self):
        super().__init__()
        self.products: List[Product] = []
        self.regions: List[Region] = []
        self._calls: Dict[int, int] = {}

    @staticmethod
    def _tracer():
        from torch.fx.experimental.proxy_tensor import get_proxy_mode

        mode = get_proxy_mode()
        return None if mode is None else mode.tracer

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        tracer = self._tracer() if name in PRODUCT_FUNCS else None
        if tracer is None:
            return func(*args, **kwargs)
        before = _last_node(tracer.graph)
        out = func(*args, **kwargs)
        if name == "einsum":
            eq, ops_ = args[0], args[1:]
            if len(ops_) == 1 and isinstance(ops_[0], (list, tuple)):
                ops_ = tuple(ops_[0])
        else:
            eq, ops_ = None, tuple(args[:2])
        kind = "matmul" if name == "__matmul__" else name
        self._record(tracer, kind, eq, ops_, out, before)
        return out

    def _record(self, tracer, kind, eq, operands, out, before):
        from torch.fx.experimental.proxy_tensor import get_proxy_slot

        if len(operands) != 2 or not all(
                isinstance(t, torch.Tensor) for t in (*operands, out)):
            return
        slots = [get_proxy_slot(t, tracer, None) for t in (*operands, out)]
        if any(s is None for s in slots):
            return
        lhs, rhs, o = (s.proxy.node for s in slots)
        prod = Product(kind, (lhs, rhs), o,
                       frozenset(_nodes_after(tracer.graph, before)))
        try:
            if kind == "einsum":
                prod.form = einsum_dot(eq, operands[0].shape,
                                       operands[1].shape)
            else:
                prod.form = matmul_dot(kind, operands[0].shape,
                                       operands[1].shape)
        except Unsupported as e:
            prod.unsupported = str(e)
        self.products.append(prod)

    def region(self, name, key_fn, policy, fn, args, kwargs):
        tracer = self._tracer()
        if tracer is None:
            return fn(*args, **kwargs)
        before = _last_node(tracer.graph)
        out = fn(*args, **kwargs)
        key = id(key_fn)
        instance = self._calls.get(key, 0)
        self._calls[key] = instance + 1
        self.regions.append(Region(name, policy,
                                   _nodes_after(tracer.graph, before),
                                   instance))
        return out


@dataclasses.dataclass
class Traced:
    """A traced function: its graph and what the trace recorded."""

    gm: Any                         # torch.fx.GraphModule
    products: List[Product]
    regions: List[Region]
    out_spec: Any                   # the output's pytree spec
    region_of: Dict[Any, Region] = dataclasses.field(default_factory=dict)
    index: Dict[Any, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.index = {n: i for i, n in enumerate(self.gm.graph.nodes)}
        for r in self.regions:
            for n in r.nodes:
                self.region_of[n] = r


def trace(fn, flat_args: Sequence[torch.Tensor]) -> Traced:
    """``fn(*flat_args)`` (a function of tensors returning a pytree of
    tensors) traced into an aten graph on fake tensors, under
    ``torch.no_grad()`` and no mesh (``codegen.collectives.single_rank``),
    with its products and regions recorded."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils import _pytree as pytree

    from ..codegen.collectives import single_rank
    from ..models import layers

    rec = _Recorder()
    store: Dict[str, Any] = {}

    def flat_fn(*args):
        outs, store["spec"] = pytree.tree_flatten(fn(*args))
        return outs

    def recorded(*args):
        with rec:
            return flat_fn(*args)

    if layers._CAPTURE is not None:
        raise RuntimeError("capture traces do not nest")
    layers._CAPTURE = rec
    try:
        with torch.no_grad(), single_rank():
            gm = make_fx(recorded, tracing_mode="fake")(*flat_args)
    finally:
        layers._CAPTURE = None
    return Traced(gm, rec.products, rec.regions, store["spec"])


# ---------------------------------------------------------------------------
# fused-pattern analysis: attention motif + scatter-tainted grouped GEMMs
# ---------------------------------------------------------------------------

#: mask fills below this count as "minus infinity" for motif purposes
_MASK_FLOOR = -1e20

#: producers the motif matcher looks through (layout/dtype plumbing): the
#: aten ops of the reference's reshape, broadcast_in_dim,
#: convert_element_type, squeeze and expand_dims
_TRANSPARENT = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "_to_copy", "clone",
    "squeeze", "unsqueeze", "alias",
})

#: aten ops that write rows into a tensor by index (the grouped taint)
_SCATTER = frozenset({"index_put", "index_put_", "_index_put_impl_",
                      "index_add", "index_add_", "index_copy",
                      "index_copy_"})


def _opname(node) -> str:
    if node.op != "call_function":
        return ""
    return getattr(node.target, "_opname", "") or getattr(
        node.target, "__name__", "")


def _val(node):
    return node.meta.get("val")


@dataclasses.dataclass(eq=False)
class AttentionMotif:
    """One matched einsum-softmax-einsum chain, rewritable as one fused op.

    ``terminal`` is the closing ``div`` node (its value is the attention
    output); ``interior`` holds every node whose value exists only to feed
    it — the replay skips them and evaluates ``ops.attention(q, k, v)`` at
    the terminal instead."""

    terminal: Any
    interior: frozenset
    q: Any
    k: Any
    v: Any
    causal: bool
    site: CaptureSite


class _Matcher:
    def __init__(self, traced: Traced, by_out: Dict[Any, Product]):
        self.t = traced
        self.by_out = by_out

    def peel(self, node, chain):
        """Follow layout-only producers back, stopping at a product's
        output; returns the first other node."""
        while (isinstance(node, torch.fx.Node) and node not in self.by_out
               and _opname(node) in _TRANSPARENT):
            if _opname(node) == "_to_copy" and set(node.kwargs) - {"dtype"}:
                break  # a device or layout copy, not a dtype conversion
            chain.append(node)
            node = node.args[0]
        return node if isinstance(node, torch.fx.Node) else None

    @staticmethod
    def _axes(node) -> Optional[Tuple[int, ...]]:
        """A reduction's axes, normalized to its input's rank."""
        if len(node.args) < 2:
            return None
        dims = node.args[1]
        dims = [dims] if isinstance(dims, int) else list(dims)
        rank = len(_val(node.args[0]).shape)
        return tuple(sorted(d % rank for d in dims))

    def _iota_axis(self, node) -> Optional[int]:
        """The axis (counted from the right) along which ``node``, an
        ``arange`` seen through unsqueezes and expands, varies."""
        steps = []
        while _opname(node) in ("unsqueeze", "expand", "_to_copy", "alias"):
            steps.append(node)
            node = node.args[0]
        if _opname(node) != "arange":
            return None
        args = list(node.args)
        if node.target.__name__.endswith("start_step") and args[2:3] != [1]:
            return None
        if len(args) >= 2 and args[0] != 0:
            return None
        pos, rank = 0, 1
        for s in reversed(steps):
            if _opname(s) == "unsqueeze":
                d = s.args[1] % (rank + 1)
                if d <= pos:
                    pos += 1
                rank += 1
            elif _opname(s) == "expand":
                new = len(s.args[1])
                pos += new - rank
                rank = new
        return pos - rank

    def _is_causal_pred(self, pred) -> bool:
        """pred == (col_iota <= row_iota), structurally — no constant
        masks."""
        if _opname(pred) not in ("le", "ge") or len(pred.args) != 2:
            return False
        if not all(isinstance(a, torch.fx.Node) for a in pred.args):
            return False
        axes = tuple(self._iota_axis(a) for a in pred.args)
        want = (-1, -2) if _opname(pred) == "le" else (-2, -1)
        return axes == want

    def _fill(self, node) -> Optional[float]:
        if isinstance(node, (int, float)):
            return float(node)
        node = self.peel(node, [])
        if node is None:
            return None
        if _opname(node) == "scalar_tensor":
            return float(node.args[0])
        if _opname(node) == "full":
            return float(node.args[1])
        if node.op == "get_attr":
            t = getattr(self.t.gm, node.target)
            return float(t) if t.numel() == 1 else None
        if _opname(node) == "lift_fresh_copy":
            return self._fill(node.args[0])
        return None

    def match(self, div, interpret) -> Optional[AttentionMotif]:
        """Match the plain-path attention chain ending at ``div``.

        Expected (walking backwards, through layout-only ops):

            div(num, rowsum)  <- num = product(exp_p, V)  b(0,0) c(2,1)
                                 rowsum = sum(exp_p, dim=2)
            exp_p = exp(scores_masked - amax(scores_masked, dim=2))
            scores_masked = [where(col<=row, ., -big)] (mul(dot1, d**-0.5))
            dot1 = product(Q, K)  b(0,0) c(2,2)

        Every interior value must be consumed only inside the chain.
        """
        from .. import ops

        if len(div.args) != 2 or not all(
                isinstance(a, torch.fx.Node) for a in div.args):
            return None
        chain: List[Any] = []
        dot2 = self.by_out.get(self.peel(div.args[0], chain))
        if dot2 is None or dot2.form is None or dot2.form.swapped or (
            dot2.form.dimension_numbers != (((2,), (1,)), ((0,), (0,)))
        ) or dot2.form.lhs_sum or dot2.form.lhs_squeeze:
            return None
        rsum = self.peel(div.args[1], chain)
        if rsum is None or _opname(rsum) != "sum" or self._axes(rsum) != (2,):
            return None
        chain.append(rsum)
        exp_a = self.peel(rsum.args[0], chain)
        exp_b = self.peel(dot2.operands[0], chain)
        if exp_a is None or exp_a is not exp_b or _opname(exp_a) != "exp":
            return None
        chain.append(exp_a)
        sub = self.peel(exp_a.args[0], chain)
        if sub is None or _opname(sub) != "sub" or sub.kwargs.get(
                "alpha", 1) != 1 or len(sub.args) != 2:
            return None
        chain.append(sub)
        rmax = self.peel(sub.args[1], chain)
        if rmax is None or _opname(rmax) != "amax" or (
                self._axes(rmax) != (2,)):
            return None
        chain.append(rmax)
        masked = self.peel(sub.args[0], chain)
        if masked is None or masked is not self.peel(rmax.args[0], chain):
            return None
        causal = False
        if _opname(masked) == "where" and len(masked.args) == 3:
            pred, scores_in, fill = masked.args
            value = self._fill(fill)
            if value is None or value > _MASK_FLOOR:
                return None
            if not self._is_causal_pred(pred):
                return None
            causal = True
            chain.append(masked)
            mul = self.peel(scores_in, chain)
        else:
            mul = masked
        if mul is None or _opname(mul) != "mul" or len(mul.args) != 2:
            return None
        chain.append(mul)
        scale = dot1 = None
        for a, b in (mul.args, tuple(reversed(mul.args))):
            if isinstance(b, (int, float)):
                dot1 = self.by_out.get(self.peel(a, chain))
                scale = float(b)
                break
        if dot1 is None or dot1.form is None or dot1.form.swapped or (
            dot1.form.dimension_numbers != (((2,), (2,)), ((0,), (0,)))
        ) or dot1.form.lhs_sum or dot1.form.rhs_sum or (
                dot1.form.lhs_squeeze or dot1.form.rhs_squeeze):
            return None

        q_node, k_node = dot1.operands
        v_node = dot2.operands[1]
        qa, ka, va = (_val(n) for n in (q_node, k_node, v_node))
        if qa.dim() != 3 or ka.dim() != 3 or va.dim() != 3:
            return None
        h, s, d = qa.shape
        t = ka.shape[1]
        e = va.shape[2]
        if tuple(ka.shape) != (h, t, d) or tuple(va.shape[:2]) != (h, t):
            return None
        if abs(scale - d ** -0.5) > 1e-6 * d ** -0.5:
            return None  # non-standard scaling: not the op we generate

        # the fused call replaces the whole region — nothing outside it may
        # observe an interior value, and it all lives at div's level
        interior = set(chain) | dot1.interior | dot2.interior
        level = self.t.region_of.get(div)
        for n in interior:
            if self.t.region_of.get(n) is not level:
                return None
            for user in n.users:
                if user not in interior and user is not div:
                    return None

        out = _val(div)
        site = CaptureSite(
            site_id=0, path="",
            lhs_shape=tuple(qa.shape), rhs_shape=tuple(ka.shape),
            out_shape=tuple(out.shape), dtype=dtype_name(qa.dtype),
            out_dtype=dtype_name(out.dtype),
            dimension_numbers=dot1.form.dimension_numbers,
            op="attention",
            spec=attention_spec(h, s, t, d, e=e, causal=causal),
        )
        if not qa.dtype == ka.dtype == va.dtype:
            site.reason = "mixed attention operand dtypes"
        elif site.dtype not in SUPPORTED_DTYPES:
            site.reason = f"unsupported dtype {site.dtype}"
        elif ops._attention_kernel_ok(_Shaped((h, s, d), qa.device),
                                      interpret):
            site.status = "dispatched"
        else:
            site.reason = "cpu backend without interpret mode"
        return AttentionMotif(div, frozenset(interior), q_node, k_node,
                              v_node, causal, site)


def _grouped_taint(traced: Traced) -> set:
    """Products whose lhs a scatter-family op wrote, at the same level
    (region instance or the outer graph): values written by ``index_put``
    and kin taint everything downstream at their level, an in-place write
    its target too; taint does not cross a region's boundary, as the
    reference's does not cross a higher-order primitive's."""
    tainted: set = set()
    for node in traced.gm.graph.nodes:
        level = traced.region_of.get(node)
        ins = [a for a in node.all_input_nodes
               if traced.region_of.get(a) is level]
        name = _opname(node)
        if name in _SCATTER or name.startswith("scatter"):
            tainted.add(node)
            if name.endswith("_") and node.args and isinstance(
                    node.args[0], torch.fx.Node):
                tainted.add(node.args[0])
        elif any(a in tainted for a in ins):
            tainted.add(node)
    return tainted


@dataclasses.dataclass
class Harvest:
    """Everything the replay and the report need of one trace."""

    report: CaptureReport
    #: product output node -> (Product, its site)
    products: Dict[Any, Tuple[Product, CaptureSite]]
    #: attention terminal (div) node -> its motif
    motifs: Dict[Any, AttentionMotif]


def _site_path(traced: Traced, node) -> str:
    region = traced.region_of.get(node)
    if region is None:
        return f"node{traced.index[node]}"
    at = region.nodes.index(node)
    mid = "/remat" if region.policy else ""
    return f"{region.name}{mid}/node{at}"


def _reported(traced: Traced, node) -> bool:
    region = traced.region_of.get(node)
    return region is None or region.instance == 0


def _launch_site(node) -> CaptureSite:
    """A launch the function already makes on a kernel: dispatched."""
    from ..ops.library import kernel_of

    kernel = kernel_of(node.args[0])
    spec = kernel.spec.root()
    operands = [a for a in node.args[1:] if isinstance(a, torch.fx.Node)]
    if _opname(node) == "contract":
        operands = list(node.args[1])
    shapes = [tuple(_val(a).shape) for a in operands] + [(), ()]
    out = _val(node)
    return CaptureSite(
        site_id=0, path="", lhs_shape=shapes[0], rhs_shape=shapes[1],
        out_shape=tuple(out.shape), dtype=dtype_name(_val(operands[0]).dtype),
        out_dtype=dtype_name(out.dtype), dimension_numbers=None,
        op=_FAMILY_OP.get(spec.name, spec.name), spec=spec,
        status="dispatched")


def harvest_graph(traced: Traced, *, interpret: bool,
                  label: str = "") -> Harvest:
    """Classify every product of a trace; the report lists the sites of
    the outer graph and of each body's first call, in graph order."""
    by_out = {p.out: p for p in traced.products}
    matcher = _Matcher(traced, by_out)
    motifs: Dict[Any, AttentionMotif] = {}
    folded: set = set()
    for node in traced.gm.graph.nodes:
        if _opname(node) != "div":
            continue
        motif = matcher.match(node, interpret)
        if motif is None or motif.interior & folded:
            continue  # no match, or overlapping a match: first one wins
        motifs[node] = motif
        folded |= motif.interior
    tainted = _grouped_taint(traced)

    products: Dict[Any, Tuple[Product, CaptureSite]] = {}
    for p in traced.products:
        if p.out in folded:
            continue  # folded into an attention site
        lhs, rhs = p.operands
        if p.form is not None and p.form.swapped:
            lhs, rhs = rhs, lhs
        lv, rv, ov = _val(lhs), _val(rhs), _val(p.out)
        if p.form is None:
            site = CaptureSite(0, "", tuple(lv.shape), tuple(rv.shape),
                               tuple(ov.shape), dtype_name(lv.dtype),
                               dtype_name(ov.dtype), None,
                               reason=p.unsupported)
        else:
            f = p.form
            lhs_aval = _Aval(f.lhs_shape, lv.dtype, lv.device)
            rhs_aval = _Aval(f.rhs_shape, rv.dtype, rv.device)
            site = classify_dot_general(
                lhs_aval, rhs_aval, _Aval(f.out_shape, ov.dtype, ov.device),
                {"dimension_numbers": f.dimension_numbers},
                interpret=interpret, grouped_lhs=lhs in tainted)
            if f.broadcast and site.dispatched:
                site.status, site.reason = "fallback", f.broadcast
        products[p.out] = (p, site)

    report = CaptureReport(label=label)
    launches = {n for n in traced.gm.graph.nodes
                if _opname(n) in _LAUNCH_OPS and n.target.namespace
                == "repro_torch"}
    for node in traced.gm.graph.nodes:
        if node in motifs:
            site = motifs[node].site
        elif node in products:
            site = products[node][1]
        elif node in launches:
            site = _launch_site(node)
        else:
            continue
        if not _reported(traced, node):
            continue
        site.site_id = len(report.sites)
        site.path = _site_path(traced, node) + (
            "@launch" if node in launches else "")
        report.sites.append(site)
    return Harvest(report, products, motifs)


@dataclasses.dataclass
class _Aval:
    shape: Tuple[int, ...]
    dtype: Any
    device: Any = "cpu"
