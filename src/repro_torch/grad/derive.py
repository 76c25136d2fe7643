"""Backward ContractionSpecs by index calculus — grads as mapping problems.

A copy of the reference's ``grad/derive.py`` (pure Python over the port's
``core.enumerate``): the derived specs, their names and so their plan and
cache keys are the reference's.

For a sum-of-products contraction

    out[output] = sum_{reduce} prod_X X[axes_X]

the cotangent of operand ``W`` under upstream gradient ``g = d loss / d out``
is itself a sum-of-products contraction over the *same* index set:

    dW[axes_W] = sum_{indices - axes_W} g[output] * prod_{X != W} X[axes_X]

i.e. differentiation just moves ``W``'s axes to the output side and the
forward output's axes to an operand (the cotangent, named ``dout`` here).
For the canonical matmul this recovers the classical pair

    dA[i,j] = sum_k g[i,k] B[j,k]     (a transposed-operand GEMM — compare
    dB[j,k] = sum_i A[i,j] g[i,k]      ``core.enumerate.transposed_matmul_spec``)

and for ``chain_matmul`` it produces genuine three-operand contractions,
which is exactly the Linnea/LAMP observation that derived expressions are
mapping problems of their own: every derived spec re-enters the same
``search``/``codegen`` pipeline as the primal, with its own plan-DB and
autotune-cache keys (``name`` differs, so ``codegen.cache.spec_signature``
differs).

Consumers: ``grad.vjp`` (the ``torch.autograd.Function`` backward passes)
and the parity tests (``tests/test_torch_grad.py``).
"""

from __future__ import annotations

from typing import Dict

from ..core import enumerate as _enum
from ..core.enumerate import ContractionSpec

#: operand name carrying the upstream cotangent in every derived spec
COTANGENT = "dout"


def _check_differentiable(root: ContractionSpec) -> None:
    if root.reducer != "+":
        raise NotImplementedError(
            f"cannot derive gradients for reducer {root.reducer!r}; "
            "only '+' contractions are sum-of-products"
        )
    if root.scalar is not _enum._product_scalar:
        raise NotImplementedError(
            f"spec {root.name!r} has a custom scalar body; gradient "
            "derivation assumes the default product scalar"
        )
    if COTANGENT in root.operands:
        raise ValueError(
            f"operand name {COTANGENT!r} is reserved for the cotangent"
        )


def _fused_derived(root: ContractionSpec) -> Dict[str, ContractionSpec]:
    """Backward specs of the fused families.

    A fused forward is not a sum-of-products, so the generic index
    calculus does not apply; instead these are the GEMMs the fused
    custom VJPs (``grad.vjp.attention_vjp`` / ``grouped_vjp``) actually
    execute, each a first-class spec with its own plan-DB/autotune key:

    attention (dS = P∘(dP − D) computed elementwise in the VJP):
        dQ[h,s,d] = Σ_t dS[h,s,t] K[h,t,d]   (``dout`` carries dS)
        dK[h,t,d] = Σ_s dS[h,s,t] Q[h,s,d]
        dV[h,t,e] = Σ_s  P[h,s,t] g[h,s,e]   (``dout`` carries g)
    grouped_matmul (both still ragged — GroupedSpecs with the same
    ``group_sizes``, lowered by the same group-offset kernel modes):
        dX[n,k]   = Σ_f g[n,f] W[group(n),k,f]
        dW[g,k,f] = Σ_{n∈group g} X[n,k] g[n,f]
    """
    kind = root.fused_kind
    ex = root.extents
    if kind == "attention":
        h, s, t = ex["h"], ex["s"], ex["t"]
        d, e = ex["d"], ex["e"]
        return {
            "Q": ContractionSpec(
                name="attention.dQ",
                operands={COTANGENT: ("h", "s", "t"), "K": ("h", "t", "d")},
                output=("h", "s", "d"),
                extents={"h": h, "s": s, "t": t, "d": d},
            ),
            "K": ContractionSpec(
                name="attention.dK",
                operands={COTANGENT: ("h", "s", "t"), "Q": ("h", "s", "d")},
                output=("h", "t", "d"),
                extents={"h": h, "s": s, "t": t, "d": d},
            ),
            "V": ContractionSpec(
                name="attention.dV",
                operands={COTANGENT: ("h", "s", "e"), "P": ("h", "s", "t")},
                output=("h", "t", "e"),
                extents={"h": h, "s": s, "t": t, "e": e},
            ),
        }
    if kind == "grouped_matmul":
        from ..core.enumerate import GroupedSpec

        sizes = root.group_sizes
        return {
            "X": GroupedSpec(
                name="grouped_matmul.dX",
                operands={COTANGENT: ("n", "f"), "W": ("g", "k", "f")},
                output=("n", "k"),
                extents=dict(ex),
                group_sizes=sizes,
            ),
            "W": GroupedSpec(
                name="grouped_matmul.dW",
                operands={COTANGENT: ("n", "f"), "X": ("n", "k")},
                output=("g", "k", "f"),
                extents=dict(ex),
                group_sizes=sizes,
            ),
        }
    raise NotImplementedError(f"no derived specs for fused kind {kind!r}")


def derived_spec(spec: ContractionSpec, wrt: str) -> ContractionSpec:
    """The backward contraction for ``d loss / d wrt`` of a forward spec.

    The result is a ROOT spec named ``<name>.d<wrt>`` whose operands are
    the cotangent (``dout``, carrying the forward output axes) followed by
    every forward operand except ``wrt`` in their original order, and whose
    output axes are ``wrt``'s axes in *storage* order — so the kernel's
    result drops straight into the cotangent slot with no transpose.

    Fused families (``fused_kind`` set) branch to ``_fused_derived`` —
    their backward contractions are hand-derived, not index calculus.
    """
    root = spec.root()
    if getattr(root, "fused_kind", ""):
        fused = _fused_derived(root)
        if wrt not in fused:
            raise ValueError(
                f"unknown operand {wrt!r}; spec has {tuple(root.operands)}"
            )
        return fused[wrt]
    _check_differentiable(root)
    if wrt not in root.operands:
        raise ValueError(
            f"unknown operand {wrt!r}; spec has {tuple(root.operands)}"
        )
    operands = {COTANGENT: root.output}
    for name, axes in root.operands.items():
        if name != wrt:
            operands[name] = axes
    covered = {i for axes in operands.values() for i in axes}
    missing = [i for i in root.operands[wrt] if i not in covered]
    if missing:
        # an index living only in `wrt` and reduced away forward would need
        # a broadcast (ones-expansion) backward; no current spec family
        # does this, so refuse loudly instead of silently mis-deriving
        raise NotImplementedError(
            f"index {missing} of {wrt!r} appears in no other operand nor "
            f"the output; its cotangent is a broadcast, not a contraction"
        )
    return ContractionSpec(
        name=f"{root.name}.d{wrt}",
        operands=operands,
        output=root.operands[wrt],
        extents=dict(root.extents),
        reducer=root.reducer,
    )


def derived_specs(spec: ContractionSpec) -> Dict[str, ContractionSpec]:
    """Backward specs for every operand: {operand name -> dX spec}."""
    root = spec.root()
    return {name: derived_spec(root, name) for name in root.operands}
