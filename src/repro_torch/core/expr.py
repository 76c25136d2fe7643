"""Higher-order-function AST — the paper's DSL.

Nodes mirror the paper's primitives:

* ``MapN(f, args)``   — the n-ary ``nzip`` (eq 20); ``len(args) == 1`` is ``map``.
* ``RNZ(r, f, args)`` — reduce-of-nzip (eq 26): ``r`` must be associative;
  ``f`` zips the slices elementwise before reduction.
* ``Subdiv/Flatten/Flip`` — the logical layout operators of §2.1 lifted to
  expressions.
* ``Lam/App/Var/Prim/Lit`` — a tiny lambda calculus to host the rewrite rules
  (the paper's implementation does the same with catamorphisms over an AST
  with lambda abstraction/application nodes).

All HoFs consume the *outermost* dimension of their array arguments.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple


class Expr:
    """Base class; all subclasses are frozen dataclasses (structural equality)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    name: str

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    value: float

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True)
class Prim(Expr):
    """A named primitive scalar function ('+', '*', 'max', ...).

    Primitives broadcast over logical arrays, which makes ``lift r``
    (paper eq 41) definitionally equal to ``r`` for primitive reducers.
    """

    name: str

    def __repr__(self):
        return f"({self.name})"


@dataclasses.dataclass(frozen=True)
class Lam(Expr):
    params: Tuple[str, ...]
    body: Expr

    def __repr__(self):
        return f"(\\{' '.join(self.params)} -> {self.body!r})"


@dataclasses.dataclass(frozen=True)
class App(Expr):
    fn: Expr
    args: Tuple[Expr, ...]

    def __repr__(self):
        return f"({self.fn!r} {' '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class MapN(Expr):
    """n-ary zip (``nzip``): apply ``f`` elementwise over the outermost dim."""

    f: Expr
    args: Tuple[Expr, ...]

    def __repr__(self):
        return f"(nzip {self.f!r} {' '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class RNZ(Expr):
    """reduce-of-nzip: ``rnz r f xs…`` (paper eq 26)."""

    r: Expr
    f: Expr
    args: Tuple[Expr, ...]

    def __repr__(self):
        return f"(rnz {self.r!r} {self.f!r} {' '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class Subdiv(Expr):
    d: int
    b: int
    x: Expr

    def __repr__(self):
        return f"(subdiv {self.d} {self.b} {self.x!r})"


@dataclasses.dataclass(frozen=True)
class Flatten(Expr):
    d: int
    x: Expr

    def __repr__(self):
        return f"(flatten {self.d} {self.x!r})"


@dataclasses.dataclass(frozen=True)
class Flip(Expr):
    d1: int
    d2: int
    x: Expr

    def __repr__(self):
        return f"(flip {self.d1} {self.d2} {self.x!r})"


@dataclasses.dataclass(frozen=True)
class FnProd(Expr):
    """Function product ``(f, g)`` ((***) in Control.Arrow; paper eq 31-34)."""

    fs: Tuple[Expr, ...]

    def __repr__(self):
        return f"({' *** '.join(map(repr, self.fs))})"


@dataclasses.dataclass(frozen=True)
class FanOut(Expr):
    """``fanOut f g`` — apply each function to the same argument (paper eq 32)."""

    fs: Tuple[Expr, ...]

    def __repr__(self):
        return f"({' &&& '.join(map(repr, self.fs))})"


@dataclasses.dataclass(frozen=True)
class Tup(Expr):
    items: Tuple[Expr, ...]

    def __repr__(self):
        return f"({', '.join(map(repr, self.items))})"


@dataclasses.dataclass(frozen=True)
class Proj(Expr):
    i: int
    x: Expr

    def __repr__(self):
        return f"(proj {self.i} {self.x!r})"


# ---------------------------------------------------------------------------
# structural helpers
# ---------------------------------------------------------------------------

_fresh_counter = itertools.count()


def fresh(prefix: str = "v") -> str:
    return f"{prefix}_{next(_fresh_counter)}"


def children(e: Expr) -> Tuple[Expr, ...]:
    if isinstance(e, (Var, Lit, Prim)):
        return ()
    if isinstance(e, Lam):
        return (e.body,)
    if isinstance(e, App):
        return (e.fn,) + e.args
    if isinstance(e, MapN):
        return (e.f,) + e.args
    if isinstance(e, RNZ):
        return (e.r, e.f) + e.args
    if isinstance(e, (Subdiv, Flatten, Flip, Proj)):
        return (e.x,)
    if isinstance(e, Tup):
        return e.items
    if isinstance(e, (FnProd, FanOut)):
        return e.fs
    raise TypeError(type(e))


def rebuild(e: Expr, kids: Tuple[Expr, ...]) -> Expr:
    if isinstance(e, (Var, Lit, Prim)):
        return e
    if isinstance(e, Lam):
        return Lam(e.params, kids[0])
    if isinstance(e, App):
        return App(kids[0], tuple(kids[1:]))
    if isinstance(e, MapN):
        return MapN(kids[0], tuple(kids[1:]))
    if isinstance(e, RNZ):
        return RNZ(kids[0], kids[1], tuple(kids[2:]))
    if isinstance(e, Subdiv):
        return Subdiv(e.d, e.b, kids[0])
    if isinstance(e, Flatten):
        return Flatten(e.d, kids[0])
    if isinstance(e, Flip):
        return Flip(e.d1, e.d2, kids[0])
    if isinstance(e, Proj):
        return Proj(e.i, kids[0])
    if isinstance(e, Tup):
        return Tup(tuple(kids))
    if isinstance(e, FnProd):
        return FnProd(tuple(kids))
    if isinstance(e, FanOut):
        return FanOut(tuple(kids))
    raise TypeError(type(e))


def free_vars(e: Expr) -> frozenset:
    if isinstance(e, Var):
        return frozenset((e.name,))
    if isinstance(e, Lam):
        return free_vars(e.body) - frozenset(e.params)
    out = frozenset()
    for c in children(e):
        out |= free_vars(c)
    return out


def subst(e: Expr, env: dict) -> Expr:
    """Capture-avoiding substitution of variables by expressions."""
    if isinstance(e, Var):
        return env.get(e.name, e)
    if isinstance(e, (Lit, Prim)):
        return e
    if isinstance(e, Lam):
        env2 = {k: v for k, v in env.items() if k not in e.params}
        if not env2:
            return e
        # rename bound params that would capture free vars of substitutes
        danger = frozenset().union(*(free_vars(v) for v in env2.values()))
        params, renames = [], {}
        for p in e.params:
            if p in danger:
                np_ = fresh(p)
                renames[p] = Var(np_)
                params.append(np_)
            else:
                params.append(p)
        body = subst(e.body, renames) if renames else e.body
        return Lam(tuple(params), subst(body, env2))
    kids = tuple(subst(c, env) for c in children(e))
    return rebuild(e, kids)


def alpha_normalize(e: Expr, counter=None) -> Expr:
    """Canonical bound-variable names, for structural equality in tests."""
    if counter is None:
        counter = itertools.count()

    def go(e: Expr, env: dict) -> Expr:
        if isinstance(e, Var):
            return Var(env.get(e.name, e.name))
        if isinstance(e, (Lit, Prim)):
            return e
        if isinstance(e, Lam):
            new = {p: f"x{next(counter)}" for p in e.params}
            return Lam(tuple(new.values()), go(e.body, {**env, **new}))
        return rebuild(e, tuple(go(c, env) for c in children(e)))

    return go(e, {})


def size(e: Expr) -> int:
    return 1 + sum(size(c) for c in children(e))


# ---------------------------------------------------------------------------
# sugar used by the spec builders and tests
# ---------------------------------------------------------------------------


def lam(params, body) -> Lam:
    if isinstance(params, str):
        params = (params,)
    return Lam(tuple(params), body)


def v(name: str) -> Var:
    return Var(name)


def zip2(f: Expr, x: Expr, y: Expr) -> MapN:
    return MapN(f, (x, y))


def map1(f: Expr, x: Expr) -> MapN:
    return MapN(f, (x,))


def reduce1(r: Expr, x: Expr) -> RNZ:
    """``reduce r x`` — rnz with identity zipper (paper eq 16 via eq 26)."""
    return RNZ(r, Prim("id"), (x,))


def dot(u: Expr, vv: Expr) -> RNZ:
    """``dot u v = rnz (+) (*) u v`` (paper eq 29)."""
    return RNZ(Prim("+"), Prim("*"), (u, vv))


def lift(r: Expr) -> Lam:
    """``lift r`` (paper eq 41): raise a binary function to operate on arrays.

    For Prim reducers this is semantically the identity (prims broadcast),
    but the explicit form is needed when the exchange rule wraps a closure.
    """
    a, b = fresh("la"), fresh("lb")
    return Lam((a, b), MapN(r, (Var(a), Var(b))))


def ncomp(i: int, f: Expr, g: Expr, n: int, m: int) -> Lam:
    """Generalized composition (paper eq 23).

    Compose ``g`` (arity ``m``) before the ``i``-th argument of ``f``
    (arity ``n``).  Result arity is ``n - 1 + m``.
    """
    a_params = [fresh("a") for _ in range(n)]
    b_params = [fresh("b") for _ in range(m)]
    params = a_params[:i] + b_params + a_params[i + 1 :]
    inner = App(g, tuple(Var(p) for p in b_params))
    args = tuple(
        inner if k == i else Var(a_params[k]) for k in range(n)
    )
    return Lam(tuple(params), App(f, args))


def arity(f: Expr) -> int | None:
    """Syntactic arity of a function expression, if known."""
    from .interp import PRIMS  # local import to avoid cycle

    if isinstance(f, Lam):
        return len(f.params)
    if isinstance(f, Prim):
        return PRIMS[f.name].arity
    return None
