"""Enumeration of HoF-nest rearrangements — paper §4.

A dense contraction (matmul, matvec, the weighted variants of eqs 1-2, 6-7)
is described by a ``ContractionSpec``: operands with named indices, output
indices (map dims), and reduced indices (rnz dims).  A *variant* is an
ordering of the loop indices (the paper's "HoF order from left to right is
the nesting from top down") plus optional subdivisions of indices.

``sjt`` enumerates orderings by adjacent transpositions
(Steinhaus–Johnson–Trotter, refs [16][17] of the paper) — each neighbouring
variant differs by exactly one application of an exchange rule from
``rules.py`` (map/map, map/rnz, or rnz/rnz), which is how the paper justifies
the walk.  ``nest_to_expr`` emits the DSL expression for a variant, with the
operand ``Subdiv``/``Flip`` prefix required by the exchange rules ("exchanging
two nested higher order functions must be done with an appropriate flip in
the subdivision structure").

This is the port's copy of the reference's spec layer, pure Python and
numpy: the same specs, the same index names and the same SJT walk, so the
schedules, plans and cache keys the port derives from them equal the
reference's (``tests/test_torch_foundation.py``).  ``evaluate_variant``
interprets a variant with the port's copy of the reference interpreter
(``core.interp``), the oracle the lowered and executed forms are held to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from . import expr as E
from .expr import App, Flip, Lam, MapN, Prim, RNZ, Subdiv, Var, fresh


# ---------------------------------------------------------------------------
# Steinhaus–Johnson–Trotter
# ---------------------------------------------------------------------------


def sjt(n: int) -> Iterator[Tuple[int, ...]]:
    """All permutations of range(n) by adjacent transpositions."""
    perm = list(range(n))
    dirs = [-1] * n  # all point left initially
    yield tuple(perm)
    while True:
        # largest mobile element
        mobile_idx = -1
        for i in range(n):
            j = i + dirs[i]
            if 0 <= j < n and perm[i] > perm[j]:
                if mobile_idx == -1 or perm[i] > perm[mobile_idx]:
                    mobile_idx = i
        if mobile_idx == -1:
            return
        j = mobile_idx + dirs[mobile_idx]
        perm[mobile_idx], perm[j] = perm[j], perm[mobile_idx]
        dirs[mobile_idx], dirs[j] = dirs[j], dirs[mobile_idx]
        moved = perm[j]
        for i in range(n):
            if perm[i] > moved:
                dirs[i] = -dirs[i]
        yield tuple(perm)


# ---------------------------------------------------------------------------
# contraction specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantMeta:
    """Low-precision storage format of a contraction's operands.

    ``dtype`` is the operand storage dtype, ``accum`` the accumulator the
    generated kernel carries in VMEM (int8 products must accumulate in
    int32 to stay exact; fp8 accumulates in f32), and ``scale`` the
    granularity of the dequantization scales applied by the epilogue
    (``per_channel`` = one scale per output column, ``per_tensor`` = one
    scale broadcast over the whole output).  The scales themselves are
    runtime epilogue vectors, not spec data — the spec only records *that*
    the kernel's inputs are quantized and how to undo it.
    """

    dtype: str            # "int8" | "float8_e4m3fn"
    accum: str            # "int32" | "float32"
    scale: str = "per_channel"  # "per_channel" | "per_tensor" | "per_block"

    def __post_init__(self):
        if self.dtype not in ("int8", "float8_e4m3fn"):
            raise ValueError(f"unsupported quant dtype {self.dtype!r}")
        if self.accum not in ("int32", "float32"):
            raise ValueError(f"unsupported quant accumulator {self.accum!r}")
        if self.scale not in ("per_channel", "per_tensor", "per_block"):
            raise ValueError(f"unsupported scale granularity {self.scale!r}")


#: canonical quant formats; keys are what ``ops.dense(quant=...)``,
#: ``--quant`` and the search ladder accept
QUANT_FORMATS: Dict[str, QuantMeta] = {
    "int8": QuantMeta(dtype="int8", accum="int32"),
    "fp8": QuantMeta(dtype="float8_e4m3fn", accum="float32"),
}


@dataclasses.dataclass(frozen=True)
class ContractionSpec:
    """An einsum-like dense contraction expressed over named indices."""

    name: str
    operands: Dict[str, Tuple[str, ...]]  # operand -> indices, outermost-first
    output: Tuple[str, ...]
    extents: Dict[str, int]
    reducer: str = "+"
    #: builds the innermost scalar expr from {operand: scalar Expr}
    scalar: Callable[[Dict[str, E.Expr]], E.Expr] = None  # type: ignore
    #: subdivision provenance: this spec = parent with `split` index subdivided
    parent: "ContractionSpec" = None  # type: ignore
    split: Tuple[str, int] = None  # type: ignore
    #: low-precision storage format (``subdivide`` drops this like
    #: ``fused_kind`` — always detect via ``spec.root().quant``)
    quant: QuantMeta = None  # type: ignore

    def __post_init__(self):
        if self.scalar is None:
            object.__setattr__(self, "scalar", _product_scalar)

    @property
    def indices(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for idxs in self.operands.values():
            for i in idxs:
                if i not in seen:
                    seen.append(i)
        return tuple(seen)

    @property
    def reduce_indices(self) -> Tuple[str, ...]:
        return tuple(i for i in self.indices if i not in self.output)

    def kind(self, index: str) -> str:
        return "map" if index in self.output else "rnz"

    def flops(self) -> int:
        # one multiply-chain + one add per innermost point
        muls = max(len(self.operands) - 1, 1)
        pts = math.prod(self.extents[i] for i in self.indices)
        return pts * (muls + (1 if self.reduce_indices else 0))

    def subdivide(self, index: str, b: int) -> "ContractionSpec":
        """Split ``index`` into (index_o, index_i) blocks — the paper's subdiv."""
        e = self.extents[index]
        if e % b:
            raise ValueError(f"{b} does not divide extent {e} of {index}")
        io, ii = index + "o", index + "i"

        def expand(idxs: Tuple[str, ...]) -> Tuple[str, ...]:
            out: List[str] = []
            for i in idxs:
                out.extend((io, ii) if i == index else (i,))
            return tuple(out)

        extents = dict(self.extents)
        del extents[index]
        extents[io], extents[ii] = e // b, b
        return ContractionSpec(
            name=self.name,
            operands={k: expand(v) for k, v in self.operands.items()},
            output=expand(self.output),
            extents=extents,
            reducer=self.reducer,
            scalar=self.scalar,
            parent=self,
            split=(index, b),
        )

    def split_chain(self) -> List[Tuple[str, int]]:
        """Subdivisions applied to reach this spec, outermost application first."""
        chain: List[Tuple[str, int]] = []
        node = self
        while node.parent is not None:
            chain.append(node.split)
            node = node.parent
        return list(reversed(chain))

    def root(self) -> "ContractionSpec":
        node = self
        while node.parent is not None:
            node = node.parent
        return node


def _product_scalar(elems: Dict[str, E.Expr]) -> E.Expr:
    out = None
    for e in elems.values():
        out = e if out is None else App(Prim("*"), (out, e))
    return out


def einsum_formula(spec: ContractionSpec) -> str:
    """np/jnp einsum string for a ROOT spec, operands in spec order.

    The single home of the index-letter mapping — shared by the search
    measurement oracle (``search.measure.einsum_reference``), the grad
    einsum fallbacks (``grad.vjp``) and the test layer.
    """
    spec = spec.root()
    letters = {i: chr(ord("a") + n) for n, i in enumerate(spec.indices)}
    subs = ",".join(
        "".join(letters[i] for i in axes) for axes in spec.operands.values()
    )
    out = "".join(letters[i] for i in spec.output)
    return f"{subs}->{out}"


# canonical specs used by the paper -------------------------------------------


def quantize_spec(
    spec: ContractionSpec, fmt: str = "int8", scale: str = "per_channel"
) -> ContractionSpec:
    """Re-tag a ROOT spec as low-precision: same contraction, quant storage.

    The spec *name* stays the family name so plan keys read
    ``matmul@...@dtype=int8`` — quantization is a storage property, not a
    new contraction family.  Fused kinds (attention, grouped) have no
    quant lowering yet and are rejected loudly.
    """
    if spec.parent is not None:
        raise ValueError("quantize_spec expects a root (unsubdivided) spec")
    if getattr(spec, "fused_kind", ""):
        raise NotImplementedError(
            f"fused family {spec.fused_kind!r} has no quantized lowering"
        )
    meta = QUANT_FORMATS.get(fmt)
    if meta is None:
        raise ValueError(
            f"unknown quant format {fmt!r} (expected one of "
            f"{sorted(QUANT_FORMATS)})"
        )
    if scale != meta.scale:
        meta = dataclasses.replace(meta, scale=scale)
    return dataclasses.replace(spec, quant=meta)


def quantized_matmul_spec(
    n: int, m: int, k: int, fmt: str = "int8", scale: str = "per_channel"
) -> ContractionSpec:
    """matmul_spec with int8/fp8 operand storage and scale metadata."""
    return quantize_spec(matmul_spec(n, m, k), fmt=fmt, scale=scale)


def matmul_spec(n: int, m: int, k: int) -> ContractionSpec:
    """C_ik = sum_j A_ij B_jk (paper eq 50); B stored row-major (j,k)."""
    return ContractionSpec(
        name="matmul",
        operands={"A": ("i", "j"), "B": ("j", "k")},
        output=("i", "k"),
        extents={"i": n, "j": m, "k": k},
    )


def matvec_spec(n: int, m: int) -> ContractionSpec:
    """v_i = sum_j A_ij u_j (paper eq 38)."""
    return ContractionSpec(
        name="matvec",
        operands={"A": ("i", "j"), "u": ("j",)},
        output=("i",),
        extents={"i": n, "j": m},
    )


def weighted_matmul_spec(n: int, m: int, k: int) -> ContractionSpec:
    """C_ik = sum_j A_ij B_jk g_j (paper eq 2/6)."""
    return ContractionSpec(
        name="weighted_matmul",
        operands={"A": ("i", "j"), "B": ("j", "k"), "g": ("j",)},
        output=("i", "k"),
        extents={"i": n, "j": m, "k": k},
    )


def batched_matmul_spec(b: int, n: int, m: int, k: int) -> ContractionSpec:
    """out[b,i,k] = sum_j A[b,i,j] B[b,j,k] — the serving/attention shape."""
    return ContractionSpec(
        name="batched_matmul",
        operands={"A": ("b", "i", "j"), "B": ("b", "j", "k")},
        output=("b", "i", "k"),
        extents={"b": b, "i": n, "j": m, "k": k},
    )


def chain_matmul_spec(n: int, m: int, p: int, q: int) -> ContractionSpec:
    """out[i,l] = sum_{j,k} A[i,j] B[j,k] C[k,l] — the A@B@C chain.

    A single spec with two reduce indices: the per-block contraction is
    multilinear in each reduction block, so summing block-local
    einsum("ij,jk,kl->il") terms over (jo, ko) chunks reproduces the
    chained product exactly (no intermediate matrix is materialized in
    HBM — the paper's fusion claim applied across *two* contractions).
    """
    return ContractionSpec(
        name="chain_matmul",
        operands={"A": ("i", "j"), "B": ("j", "k"), "C": ("k", "l")},
        output=("i", "l"),
        extents={"i": n, "j": m, "k": p, "l": q},
    )


def transposed_matmul_spec(n: int, m: int, k: int) -> ContractionSpec:
    """out[i,k] = sum_j A[j,i] B[j,k] — A stored transposed (weight grads).

    This is the hand-written ancestor of the *derived* backward specs
    (dB = Aᵀ·g), which the training slice derives mechanically.
    """
    return ContractionSpec(
        name="transposed_matmul",
        operands={"A": ("j", "i"), "B": ("j", "k")},
        output=("i", "k"),
        extents={"i": n, "j": m, "k": k},
    )


# fused kernel families ------------------------------------------------------
#
# A fused spec is still a ContractionSpec — its operands/output/extents
# drive the generic enumerate->search->plan machinery unchanged — but the
# innermost semantics are NOT a plain product-reduce: `fused_kind` names a
# dedicated fused lowering (``codegen.fused_gen``) and every einsum-based
# consumer (measurement oracle, grad fallbacks) must branch on it.
# ``whole_indices`` are axes the fused kernel keeps unblocked (attention's
# head dims; grouped's group/contraction axes) — the search space pins them.
# NOTE: ``subdivide`` returns a plain ContractionSpec, so fused detection
# must always go through ``getattr(spec.root(), "fused_kind", "")``.


@dataclasses.dataclass(frozen=True)
class AttentionSpec(ContractionSpec):
    """Fused QK^T -> online-softmax -> PV attention.

    out[h,s,e] = sum_t softmax_t(Q[h,s,:]·K[h,t,:] / sqrt(d) + mask) V[h,t,e]

    The KV sequence axis ``t`` is the in-schedule reduction tier: the
    generated kernel walks its blocks sequentially carrying running
    max/sum state in VMEM (flash-attention style), so ``t`` is a legal
    seq-tier chunk axis while ``d``/``e`` stay whole.
    """

    causal: bool = False

    fused_kind = "attention"
    whole_indices = ("d", "e")

    def flops(self) -> int:
        h, s, t = self.extents["h"], self.extents["s"], self.extents["t"]
        d, e = self.extents["d"], self.extents["e"]
        # two GEMMs plus the softmax exp/rescale work per score
        return 2 * h * s * t * d + 2 * h * s * t * e + 4 * h * s * t

    def fused_meta(self) -> Dict[str, object]:
        return {"causal": bool(self.causal)}


@dataclasses.dataclass(frozen=True)
class GroupedSpec(ContractionSpec):
    """Ragged grouped matmul — MoE expert dispatch as ONE contraction.

    out[n,f] = x[n,:] @ w[group(n),:,:] where rows are partitioned into
    ``len(group_sizes)`` contiguous groups (sum(group_sizes) == extent of
    ``n``).  Lowered as a group-offset Pallas grid; groups may be empty.
    """

    group_sizes: Tuple[int, ...] = ()

    fused_kind = "grouped_matmul"
    whole_indices = ("g", "k")

    @property
    def indices(self) -> Tuple[str, ...]:
        # the derived dW spec has `g` only in its OUTPUT (the group axis
        # of a ragged contraction maps rows to slabs via group_sizes, not
        # via an operand index), so output axes join the index set here
        seen = list(super().indices)
        for i in self.output:
            if i not in seen:
                seen.append(i)
        return tuple(seen)

    def flops(self) -> int:
        k = self.extents["k"]
        f = self.extents["f"]
        return sum(2 * s * k * f for s in self.group_sizes)

    def fused_meta(self) -> Dict[str, object]:
        return {"group_sizes": list(self.group_sizes)}


def attention_spec(
    h: int, s: int, t: int, d: int, e: int = None, causal: bool = False
) -> AttentionSpec:
    """Fused attention over folded heads: Q(h,s,d) K(h,t,d) V(h,t,e)."""
    if e is None:
        e = d
    return AttentionSpec(
        name="attention",
        operands={"Q": ("h", "s", "d"), "K": ("h", "t", "d"), "V": ("h", "t", "e")},
        output=("h", "s", "e"),
        extents={"h": h, "s": s, "t": t, "d": d, "e": e},
        causal=causal,
    )


def grouped_matmul_spec(
    group_sizes: Sequence[int], k: int, f: int
) -> GroupedSpec:
    """Ragged per-group GEMM: x(n,k) w(g,k,f) -> out(n,f), n = sum(groups)."""
    sizes = tuple(int(s) for s in group_sizes)
    if any(s < 0 for s in sizes) or not sizes:
        raise ValueError(f"bad group_sizes {sizes}")
    return GroupedSpec(
        name="grouped_matmul",
        operands={"X": ("n", "k"), "W": ("g", "k", "f")},
        output=("n", "f"),
        extents={"n": max(sum(sizes), 1), "k": k, "f": f, "g": len(sizes)},
        group_sizes=sizes,
    )


def uniform_grouped_spec(g: int, m: int, k: int, f: int) -> GroupedSpec:
    """CLI-friendly grouped ctor: g uniform groups of m rows each."""
    return grouped_matmul_spec((m,) * g, k, f)


def tensor_contraction_spec(n: int, m: int, k: int, p: int, q: int) -> ContractionSpec:
    """C_ipq = sum_jk A_ijk B_jp C_kq g_j f_k (paper eq 7, PDE-style)."""
    return ContractionSpec(
        name="pde_contraction",
        operands={
            "A": ("i", "j", "k"),
            "B": ("j", "p"),
            "C": ("k", "q"),
            "g": ("j",),
            "f": ("k",),
        },
        output=("i", "p", "q"),
        extents={"i": n, "j": m, "k": k, "p": p, "q": q},
    )


# ---------------------------------------------------------------------------
# variant -> DSL expression
# ---------------------------------------------------------------------------


def _operand_expr(
    spec: ContractionSpec, name: str, order: Sequence[str]
) -> Tuple[E.Expr, Tuple[str, ...]]:
    """Wrap Var(name) in the Subdiv/Flip prefix required by variant ``order``.

    The actual input array is the *root* (unsubdivided) operand; this emits
    the paper's subdiv ops to realize every split that touches this operand,
    then Flips to sort its axes into loop-order (outermost first).
    Returns (expr, final axis order).
    """
    axes = list(spec.root().operands[name])
    e: E.Expr = Var(name)
    for index, b in spec.split_chain():
        if index not in axes:
            continue
        p = axes.index(index)  # outermost-first position
        d = len(axes) - 1 - p  # innermost-first dim
        e = Subdiv(d, b, e)
        axes[p : p + 1] = [index + "o", index + "i"]
    assert tuple(sorted(axes, key=order.index)) == tuple(
        sorted(spec.operands[name], key=order.index)
    )
    idxs = tuple(axes)
    target = tuple(sorted(idxs, key=order.index))
    rank = len(axes)
    # selection sort, emitting a Flip per swap (dims innermost-first)
    for pos in range(rank):
        want = target[pos]
        cur = axes.index(want)
        if cur != pos:
            d1 = rank - 1 - pos
            d2 = rank - 1 - cur
            e = Flip(min(d1, d2), max(d1, d2), e)
            axes[pos], axes[cur] = axes[cur], axes[pos]
    return e, target


def lift_n(r: E.Expr, n: int) -> E.Expr:
    for _ in range(n):
        r = E.lift(r)
    return r


def nest_to_expr(spec: ContractionSpec, order: Sequence[str]) -> E.Expr:
    """Build the DSL expression for loop ordering ``order`` (outer -> inner)."""
    assert set(order) == set(spec.indices), (order, spec.indices)

    # live operand expressions + their remaining axis lists
    live: Dict[str, E.Expr] = {}
    remaining: Dict[str, List[str]] = {}
    for name in spec.operands:
        expr_, axes = _operand_expr(spec, name, order)
        live[name] = expr_
        remaining[name] = list(axes)

    def build(k: int) -> E.Expr:
        if k == len(order):
            return spec.scalar({n: live[n] for n in spec.operands})
        idx = order[k]
        involved = [n for n in spec.operands if remaining[n] and remaining[n][0] == idx]
        if not involved:
            return build(k + 1)
        params, saved = [], {}
        for n in involved:
            p = fresh(n.lower())
            params.append(p)
            saved[n] = (live[n], remaining[n])
            live[n] = Var(p)
            remaining[n] = remaining[n][1:]
        body = build(k + 1)
        args = tuple(saved[n][0] for n in involved)
        if spec.kind(idx) == "map":
            out: E.Expr = MapN(Lam(tuple(params), body), args)
        else:
            maps_below = sum(
                1 for j in order[k + 1 :] if spec.kind(j) == "map"
            )
            reducer = lift_n(Prim(spec.reducer), maps_below)
            out = RNZ(reducer, Lam(tuple(params), body), args)
        for n in involved:
            live[n], remaining[n] = saved[n]
        return out

    return build(0)


def output_axis_order(spec: ContractionSpec, order: Sequence[str]) -> Tuple[str, ...]:
    """Axis order (outermost-first) of the result produced by nest_to_expr."""
    return tuple(i for i in order if spec.kind(i) == "map")


def variant_orders(
    spec: ContractionSpec, dedup_rnz: bool = True
) -> List[Tuple[str, ...]]:
    """All loop orderings via SJT.

    ``dedup_rnz`` treats equal-reducer rnz dims of the *same split index
    chain* order-insensitively only when adjacent blocks — the paper keeps
    12 cases for the subdivided matmul because the two rnzs are
    indistinguishable; we dedup orders that differ only by relabeling of
    split siblings at the same nesting relation (jo must stay outside ji).
    """
    idxs = spec.indices
    seen = set()
    out: List[Tuple[str, ...]] = []
    for perm in sjt(len(idxs)):
        order = tuple(idxs[p] for p in perm)
        # block-split sanity: an outer split index must nest outside its inner
        ok = True
        for i in idxs:
            if i.endswith("o") and i[:-1] + "i" in idxs:
                if order.index(i) > order.index(i[:-1] + "i"):
                    ok = False
                    break
        if not ok:
            continue
        key = order
        if dedup_rnz:
            # canonical label: positions of rnz dims as a multiset pattern
            key = tuple(
                ("R" if spec.kind(i) == "rnz" else i) for i in order
            )
            # distinguish which operands each rnz index touches
            key = tuple(
                (
                    k
                    if k != "R"
                    else "R:" + ",".join(sorted(
                        n for n, ax in spec.operands.items() if order[pos] in ax
                    ))
                )
                for pos, k in enumerate(key)
            )
        if key in seen:
            continue
        seen.add(key)
        out.append(order)
    return out


# ---------------------------------------------------------------------------
# rule-driven derivation (the Fig-3 six matvec forms)
# ---------------------------------------------------------------------------


def paper_fig3_variants(n: int, m: int, b: int):
    """The six matvec rearrangements of paper Fig 3, as (label, order, spec).

    1a/1b/1c subdivide the reduction (vector) index j; 2a/2b/2c subdivide the
    map index i.  Orders are the nestings shown in the figure.
    """
    base = matvec_spec(n, m)
    s1 = base.subdivide("j", b)  # jo, ji
    s2 = base.subdivide("i", b)  # io, ii
    return [
        ("1a", ("i", "jo", "ji"), s1),
        ("1b", ("jo", "i", "ji"), s1),
        ("1c", ("jo", "ji", "i"), s1),
        ("2a", ("j", "io", "ii"), s2),
        ("2b", ("io", "j", "ii"), s2),
        ("2c", ("io", "ii", "j"), s2),
    ]


def evaluate_variant(
    spec: ContractionSpec, order: Sequence[str], arrays: Dict[str, np.ndarray]
) -> np.ndarray:
    """Interpret the variant and canonicalize the output to spec.output order."""
    from .interp import run

    out = np.asarray(run(nest_to_expr(spec, order), **arrays))
    produced = output_axis_order(spec, order)
    perm = tuple(produced.index(i) for i in spec.output)
    out = np.transpose(out, perm)
    # merge split output axes back (outer,inner are adjacent in spec.output)
    root_shape = tuple(
        spec.root().extents[i] for i in spec.root().output
    )
    return out.reshape(root_shape)
