"""Lowering the HoF DSL to PyTorch.

The port of the reference's lowering (which targets JAX), name for name:

* ``torch_run`` (the reference's ``jax_run``) — a structural lowering of
  any DSL expression to torch: ``MapN -> torch.func.vmap``, ``RNZ -> vmapped
  zipper + reduction``, layout ops -> reshape/swapaxes.  This is the
  "generate code for the chosen variant" step of the paper.  Associative
  prim reducers lower to ``torch.sum``-style monoid reductions (regrouping
  licensed by the paper's associativity requirement); any other reducer is
  a left fold over the zipped slices, in order.
* ``torch_fn`` (``jax_fn``) — the same as a function of positional tensors.
* ``contraction_to_torch`` (``contraction_to_jax``) — lowers a
  ``ContractionSpec`` variant to a function in which the loop ordering is
  preserved structurally: map dims become vmap levels outer-to-inner,
  reduce dims become sums over dim 0 at their nesting depth, and the
  innermost body is the product of the operands' scalars.  No level is
  handed to a matmul: every dim, the innermost ones included, is a vmap
  level or a sum, as in the reference's code (its docstring's
  ``dot_general`` for the innermost levels is not what it computes).

Inputs are tensors and their device decides where the lowered function
runs (a CUDA tensor on the card, a CPU tensor on the host).  Under
``vmap`` a value's ``ndim`` is its per-example rank, as in JAX, so the
layout ops keep the reference's axis arithmetic.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
from torch.func import vmap

from . import expr as E
from .enumerate import ContractionSpec, output_axis_order

_TORCH_PRIMS: Dict[str, Callable] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "max": torch.maximum,
    "min": torch.minimum,
    "id": lambda a: a,
    "neg": lambda a: -a,
    "exp": torch.exp,
    "sq": lambda a: a * a,
}

# torch.max(x, dim) returns (values, indices); amax / amin return values
_MONOID = {
    "+": torch.sum,
    "*": torch.prod,
    "max": torch.amax,
    "min": torch.amin,
}


class _Closure:
    __slots__ = ("lam", "env")

    def __init__(self, lam, env):
        self.lam, self.env = lam, env


def unwrap_lift(r: E.Expr) -> E.Expr | None:
    """Strip ``lift`` wrappers: \\a b -> nzip r (a, b)  ==>  r."""
    while isinstance(r, E.Lam) and len(r.params) == 2:
        b = r.body
        if (
            isinstance(b, E.MapN)
            and b.args == (E.Var(r.params[0]), E.Var(r.params[1]))
            and not (E.free_vars(b.f) & set(r.params))
        ):
            r = b.f
        else:
            break
    return r


def _apply(fn, args):
    if isinstance(fn, _Closure):
        env = dict(fn.env)
        env.update(zip(fn.lam.params, args))
        return _eval(fn.lam.body, env)
    if callable(fn):
        return fn(*args)
    raise TypeError(f"not applicable: {fn}")


def _like(val, ref: torch.Tensor):
    """``val`` as a tensor of ``ref``'s dtype and device: a function under
    ``vmap`` must return tensors, and a ``Lit`` body returns a float."""
    if isinstance(val, tuple):
        return tuple(_like(v, ref) for v in val)
    if isinstance(val, torch.Tensor):
        return val
    return torch.as_tensor(val, dtype=ref.dtype, device=ref.device)


def _first_tensor(args) -> torch.Tensor:
    a = args[0]
    while isinstance(a, tuple):
        a = a[0]
    return a


def _zip(fn, args):
    """``fn`` over the outermost dim of ``args`` (the nzip of eq 20)."""
    ref = _first_tensor(args)
    return vmap(lambda *xs: _like(_apply(fn, list(xs)), ref))(*args)


def _eval(e: E.Expr, env: dict):
    if isinstance(e, E.Var):
        return env[e.name]
    if isinstance(e, E.Lit):
        return e.value
    if isinstance(e, E.Prim):
        return _TORCH_PRIMS[e.name]
    if isinstance(e, E.Lam):
        return _Closure(e, env)
    if isinstance(e, E.App):
        return _apply(_eval(e.fn, env), [_eval(a, env) for a in e.args])
    if isinstance(e, E.MapN):
        fn = _eval(e.f, env)
        return _zip(fn, [_eval(a, env) for a in e.args])
    if isinstance(e, E.RNZ):
        core = unwrap_lift(e.r)
        fn = _eval(e.f, env)
        ys = _zip(fn, [_eval(a, env) for a in e.args])
        if isinstance(core, E.Prim) and core.name in _MONOID:
            return _MONOID[core.name](ys, dim=0)
        # general associative reducer: a left fold, in order
        r = _eval(e.r, env)
        acc = ys[0]
        for y in ys[1:]:
            acc = _apply(r, [acc, y])
        return acc
    if isinstance(e, E.Subdiv):
        val = _eval(e.x, env)
        d = e.d + val.ndim if e.d < 0 else e.d
        ax = val.ndim - 1 - d
        ext = val.shape[ax]
        return val.reshape(
            val.shape[:ax] + (ext // e.b, e.b) + val.shape[ax + 1 :]
        )
    if isinstance(e, E.Flatten):
        val = _eval(e.x, env)
        d = e.d + val.ndim if e.d < 0 else e.d
        ax = val.ndim - 2 - d
        return val.reshape(
            val.shape[:ax]
            + (val.shape[ax] * val.shape[ax + 1],)
            + val.shape[ax + 2 :]
        )
    if isinstance(e, E.Flip):
        val = _eval(e.x, env)
        d1 = e.d1 + val.ndim if e.d1 < 0 else e.d1
        d2 = e.d2 + val.ndim if e.d2 < 0 else e.d2
        return torch.swapaxes(val, val.ndim - 1 - d1, val.ndim - 1 - d2)
    if isinstance(e, E.Tup):
        return tuple(_eval(i, env) for i in e.items)
    if isinstance(e, E.Proj):
        return _eval(e.x, env)[e.i]
    if isinstance(e, E.FnProd):
        fns = tuple(_eval(f, env) for f in e.fs)
        return lambda *args: tuple(
            _apply(f, [a[i] for a in args]) for i, f in enumerate(fns)
        )
    if isinstance(e, E.FanOut):
        fns = tuple(_eval(f, env) for f in e.fs)
        return lambda *args: tuple(_apply(f, list(args)) for f in fns)
    raise TypeError(type(e))


def torch_run(e: E.Expr, **arrays):
    """Lower + evaluate a DSL expression on tensors (logical arrays)."""
    env = {k: torch.as_tensor(v) for k, v in arrays.items()}
    return _eval(e, env)


def torch_fn(e: E.Expr, names: Sequence[str]) -> Callable:
    """A function of tensors (in ``names`` order) computing ``e``."""

    def fn(*arrays):
        return _eval(e, dict(zip(names, arrays)))

    return fn


# ---------------------------------------------------------------------------
# contraction variants -> structured torch
# ---------------------------------------------------------------------------


def contraction_to_torch(
    spec: ContractionSpec, order: Sequence[str], canonical_output: bool = True
) -> Callable:
    """Lower a contraction variant to torch preserving the loop structure.

    Map dims become vmap levels (outer first); rnz dims become sums over
    dim 0 placed at their depth.  Operand Subdiv/Flip prefixes are realized
    as reshape/permute, so the traversal pattern the paper derives is the
    one the lowered function walks.  The vmapped product holds every
    (map, reduce) point at once before a level sums it: a square matmul of
    extent n takes n^3 elements.
    """
    root = spec.root()
    names = list(root.operands)

    def prepare(name: str, arr: torch.Tensor):
        axes = list(root.operands[name])
        for index, b in spec.split_chain():
            if index not in axes:
                continue
            p = axes.index(index)
            e = arr.shape[p]
            arr = arr.reshape(
                arr.shape[:p] + (e // b, b) + arr.shape[p + 1 :]
            )
            axes[p : p + 1] = [index + "o", index + "i"]
        target = sorted(axes, key=list(order).index)
        arr = arr.permute(tuple(axes.index(t) for t in target))
        return arr, target

    def fn(*arrays):
        prepped = dict(zip(names, (prepare(n, a) for n, a in zip(names, arrays))))
        vals = {n: p[0] for n, p in prepped.items()}
        axlists = {n: list(p[1]) for n, p in prepped.items()}

        def build(k: int, vals: Dict[str, torch.Tensor]):
            if k == len(order):
                out = None
                for n in names:
                    out = vals[n] if out is None else out * vals[n]
                return out
            idx = order[k]
            involved = [
                n for n in names if axlists[n] and axlists[n][0] == idx
            ]
            if not involved:
                return build(k + 1, vals)
            saved = {n: axlists[n] for n in involved}
            for n in involved:
                axlists[n] = axlists[n][1:]

            def inner(*slices):
                v2 = dict(vals)
                v2.update(zip(involved, slices))
                return build(k + 1, v2)

            in_dims = tuple(0 for _ in involved)
            ys = vmap(inner, in_dims=in_dims)(*(vals[n] for n in involved))
            out = ys if spec.kind(idx) == "map" else torch.sum(ys, dim=0)
            for n in involved:
                axlists[n] = saved[n]
            return out

        out = build(0, vals)
        if canonical_output:
            produced = output_axis_order(spec, order)
            out = out.permute(
                tuple(produced.index(i) for i in spec.output)
            )
            out = out.reshape(
                tuple(root.extents[i] for i in root.output)
            )
        return out

    return fn
