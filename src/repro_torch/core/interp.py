"""Reference interpreter for the HoF DSL — the semantic oracle.

Array values are plain numpy arrays in *logical* form: axis 0 is the
outermost dimension (the one HoFs consume).  The layout operators act on the
logical form exactly as the strided definitions prescribe (the
cross-validation against ``layout.View.materialize`` is in the reference's
layout tests, and ``tests/test_torch_hof.py`` holds this copy to it):

* ``subdiv d b``  — reshape logical axis ``rank-1-d`` from ``e`` to ``(e//b, b)``
* ``flatten d``   — merge logical axes of dims ``d+1`` (outer) and ``d`` (inner)
* ``flip d1 d2``  — swap the corresponding logical axes

Every rewrite rule in ``rules.py`` is property-tested to preserve the meaning
assigned by this interpreter.

This is the port's copy of the reference interpreter, numpy inside, line
for line: it is the oracle the lowered (``lower``) and executed
(``execute``) forms of a variant, and B1's generated kernels, are held to.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from . import expr as E


@dataclasses.dataclass(frozen=True)
class PrimFn:
    name: str
    arity: int
    fn: Callable


PRIMS: Dict[str, PrimFn] = {
    "+": PrimFn("+", 2, lambda a, b: a + b),
    "-": PrimFn("-", 2, lambda a, b: a - b),
    "*": PrimFn("*", 2, lambda a, b: a * b),
    "/": PrimFn("/", 2, lambda a, b: a / b),
    "max": PrimFn("max", 2, np.maximum),
    "min": PrimFn("min", 2, np.minimum),
    "id": PrimFn("id", 1, lambda a: a),
    "neg": PrimFn("neg", 1, lambda a: -a),
    "exp": PrimFn("exp", 1, np.exp),
    "sq": PrimFn("sq", 1, lambda a: a * a),
}

#: reducers that are associative AND commutative — eligible for the
#: rnz/rnz exchange rule (paper eq 43) and reduction regrouping.
COMMUTATIVE_ASSOCIATIVE = frozenset({"+", "*", "max", "min"})


@dataclasses.dataclass(frozen=True)
class Closure:
    lam: E.Lam
    env: dict


@dataclasses.dataclass(frozen=True)
class ProdFn:
    """Evaluated function product (f1, f2, ...) — acts componentwise on tuples."""

    fns: tuple


@dataclasses.dataclass(frozen=True)
class FanFn:
    """Evaluated fanOut — applies every fn to the same args, returns a tuple."""

    fns: tuple


def _norm_dim(rank: int, d: int) -> int:
    return d + rank if d < 0 else d


def _axis(val: np.ndarray, d: int) -> int:
    return val.ndim - 1 - _norm_dim(val.ndim, d)


def _slice(val, k):
    """Index the outermost dim; tuples are SoA products (paper eq 30)."""
    if isinstance(val, tuple):
        return tuple(_slice(c, k) for c in val)
    return val[k]


def _outer_extent(val) -> int:
    if isinstance(val, tuple):
        return _outer_extent(val[0])
    return val.shape[0]


def _stack(vals):
    if isinstance(vals[0], tuple):
        return tuple(
            _stack([v[i] for v in vals]) for i in range(len(vals[0]))
        )
    return np.stack([np.asarray(v) for v in vals])


def apply_fn(fn, args):
    if isinstance(fn, ProdFn):
        # (f *** g) (a, c) = (f a, g c); n-ary, every arg is a tuple
        return tuple(
            apply_fn(f, [a[i] for a in args]) for i, f in enumerate(fn.fns)
        )
    if isinstance(fn, FanFn):
        return tuple(apply_fn(f, args) for f in fn.fns)
    if isinstance(fn, PrimFn):
        if len(args) != fn.arity:
            raise TypeError(f"prim {fn.name} expects {fn.arity} args, got {len(args)}")
        return fn.fn(*args)
    if isinstance(fn, Closure):
        if len(args) != len(fn.lam.params):
            raise TypeError(
                f"closure expects {len(fn.lam.params)} args, got {len(args)}"
            )
        env = dict(fn.env)
        env.update(zip(fn.lam.params, args))
        return evaluate(fn.lam.body, env)
    raise TypeError(f"not applicable: {fn!r}")


def evaluate(e: E.Expr, env: dict):
    if isinstance(e, E.Var):
        try:
            return env[e.name]
        except KeyError:
            raise NameError(f"unbound variable {e.name}") from None
    if isinstance(e, E.Lit):
        return e.value
    if isinstance(e, E.Prim):
        return PRIMS[e.name]
    if isinstance(e, E.Lam):
        return Closure(e, env)
    if isinstance(e, E.App):
        fn = evaluate(e.fn, env)
        args = [evaluate(a, env) for a in e.args]
        return apply_fn(fn, args)
    if isinstance(e, E.FnProd):
        return ProdFn(tuple(evaluate(f, env) for f in e.fs))
    if isinstance(e, E.FanOut):
        return FanFn(tuple(evaluate(f, env) for f in e.fs))
    if isinstance(e, E.MapN):
        fn = evaluate(e.f, env)
        args = [_as_value(evaluate(a, env)) for a in e.args]
        n = _outer_extent(args[0])
        for a in args:
            if _outer_extent(a) != n:
                raise ValueError("nzip extent mismatch")
        out = [apply_fn(fn, [_slice(a, k) for a in args]) for k in range(n)]
        return _stack(out)
    if isinstance(e, E.RNZ):
        r = evaluate(e.r, env)
        fn = evaluate(e.f, env)
        args = [_as_value(evaluate(a, env)) for a in e.args]
        n = _outer_extent(args[0])
        for a in args:
            if _outer_extent(a) != n:
                raise ValueError("rnz extent mismatch")
        if n < 1:
            raise ValueError("rnz needs at least one element (paper: reduce)")
        acc = apply_fn(fn, [_slice(a, 0) for a in args])
        for k in range(1, n):
            acc = apply_fn(r, [acc, apply_fn(fn, [_slice(a, k) for a in args])])
        return acc
    if isinstance(e, E.Subdiv):
        val = np.asarray(evaluate(e.x, env))
        ax = _axis(val, e.d)
        ext = val.shape[ax]
        if ext % e.b:
            raise ValueError(f"subdiv: {e.b} !| {ext}")
        new_shape = val.shape[:ax] + (ext // e.b, e.b) + val.shape[ax + 1 :]
        return val.reshape(new_shape)
    if isinstance(e, E.Flatten):
        val = np.asarray(evaluate(e.x, env))
        d = _norm_dim(val.ndim, e.d)
        ax_outer = val.ndim - 2 - d  # axis of dim d+1
        if ax_outer < 0:
            raise ValueError("flatten: rank too small")
        new_shape = (
            val.shape[:ax_outer]
            + (val.shape[ax_outer] * val.shape[ax_outer + 1],)
            + val.shape[ax_outer + 2 :]
        )
        return np.ascontiguousarray(val).reshape(new_shape)
    if isinstance(e, E.Flip):
        val = np.asarray(evaluate(e.x, env))
        return np.swapaxes(val, _axis(val, e.d1), _axis(val, e.d2))
    if isinstance(e, E.Tup):
        return tuple(evaluate(i, env) for i in e.items)
    if isinstance(e, E.Proj):
        return evaluate(e.x, env)[e.i]
    raise TypeError(type(e))


def _as_value(v):
    """Normalize an evaluated array argument (tuples stay SoA tuples)."""
    if isinstance(v, tuple):
        return tuple(_as_value(c) for c in v)
    return np.asarray(v)


def run(e: E.Expr, **arrays) -> np.ndarray:
    """Evaluate ``e`` with named numpy inputs (logical, outermost-first)."""
    return evaluate(e, {k: np.asarray(v) for k, v in arrays.items()})
