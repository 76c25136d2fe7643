"""Rewrite rules over the HoF DSL — paper §3.

Each rule is a function ``Expr -> Expr | None`` (None = no match at this
node).  Rules are *local*: the engine in ``rewrite.py`` decides where and in
which order to apply them.  Every rule here preserves the
reference-interpreter semantics (``core.interp``); this is the port's copy
of the reference's rules, and ``tests/test_torch_hof.py`` holds each
rewrite to the reference's, tree for tree.

Rule inventory (paper equation numbers in parens):

fusion group (pipelines)
  beta / eta / app_id          lambda-calculus housekeeping (paper §4)
  nzip_nzip_fuse        (24-25)  nzip closed under ncomp composition
  rnz_nzip_fuse         (27-28)  maps/zips fold into the rnz zipper
  tup_map_fuse          (31,33)  (map f x, map g y) = map (f***g) (x,y)
  tup_rnz_fuse          (34)     (reduce f x, reduce g y) = reduce (f***g) (x,y)
  fanout_fuse           (32)     (map f x, map g x) = map (fanOut f g) x

exchange group (nested structures)
  map_map_exchange      (36-37)  flip nested maps, transposing the result
  map_rnz_exchange      (42)     THE locality rule: map∘rnz → rnz∘map + flip
  rnz_map_exchange      (42⁻¹)   inverse direction
  rnz_rnz_exchange      (43)     flip two reductions (commutative+associative)

subdivision group (hierarchy)
  map_subdiv            (44)     map f = flatten ∘ map (map f) ∘ subdiv
  rnz_subdiv            (44')    reduction regrouping over blocks
  flip_flip / flatten_subdiv / subdiv_flatten   layout-op cancellations
"""

from __future__ import annotations

from typing import Callable, Optional

from . import expr as E
from .expr import (
    App, FanOut, Flatten, Flip, FnProd, Lam, MapN, Prim, Proj, RNZ, Subdiv,
    Tup, Var, fresh, free_vars, subst,
)
from .interp import COMMUTATIVE_ASSOCIATIVE, PRIMS

Rule = Callable[[E.Expr], Optional[E.Expr]]

RULES: dict = {}


def rule(fn: Rule) -> Rule:
    RULES[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# lambda-calculus housekeeping
# ---------------------------------------------------------------------------


@rule
def beta(e):
    """(\\x -> b) a  =  b[x := a]"""
    if isinstance(e, App) and isinstance(e.fn, Lam) and len(e.fn.params) == len(e.args):
        return subst(e.fn.body, dict(zip(e.fn.params, e.args)))
    return None


@rule
def eta(e):
    """\\x -> f x  =  f   (x not free in f)"""
    if (
        isinstance(e, Lam)
        and isinstance(e.body, App)
        and tuple(e.body.args) == tuple(Var(p) for p in e.params)
        and not (free_vars(e.body.fn) & set(e.params))
    ):
        return e.body.fn
    return None


@rule
def app_id(e):
    """id x = x"""
    if isinstance(e, App) and e.fn == Prim("id") and len(e.args) == 1:
        return e.args[0]
    return None


@rule
def proj_tup(e):
    if isinstance(e, Proj) and isinstance(e.x, Tup):
        return e.x.items[e.i]
    return None


# ---------------------------------------------------------------------------
# fusion group
# ---------------------------------------------------------------------------


def _arity(f: E.Expr) -> Optional[int]:
    if isinstance(f, Lam):
        return len(f.params)
    if isinstance(f, Prim):
        return PRIMS[f.name].arity
    return None


@rule
def nzip_nzip_fuse(e):
    """nzip f xs[..i-1] (nzip g ys) xs[i+1..] = nzip (ncomp i f g) xs++ys (eq 24-25)."""
    if not isinstance(e, MapN):
        return None
    for i, a in enumerate(e.args):
        if isinstance(a, MapN):
            n, m = len(e.args), len(a.args)
            comp = E.ncomp(i, e.f, a.f, n, m)
            new_args = e.args[:i] + a.args + e.args[i + 1 :]
            return MapN(comp, new_args)
    return None


@rule
def rnz_nzip_fuse(e):
    """rnz r f … (nzip g ys) … = rnz r (ncomp i f g) …ys… (eq 27-28)."""
    if not isinstance(e, RNZ):
        return None
    for i, a in enumerate(e.args):
        if isinstance(a, MapN):
            n, m = len(e.args), len(a.args)
            comp = E.ncomp(i, e.f, a.f, n, m)
            new_args = e.args[:i] + a.args + e.args[i + 1 :]
            return RNZ(e.r, comp, new_args)
    return None


@rule
def tup_map_fuse(e):
    """(nzip f xs, nzip g ys) = nzip (f***g) (zip xs ys components) (eq 31/33)."""
    if (
        isinstance(e, Tup)
        and len(e.items) >= 2
        and all(isinstance(it, MapN) for it in e.items)
        and len({len(it.args) for it in e.items}) == 1
    ):
        k = len(e.items[0].args)
        fs = tuple(it.f for it in e.items)
        args = tuple(
            Tup(tuple(it.args[j] for it in e.items)) for j in range(k)
        )
        return MapN(FnProd(fs), args)
    return None


@rule
def tup_rnz_fuse(e):
    """(rnz r f xs, rnz r' f' ys) = rnz (r***r') (f***f') (paired) (eq 34)."""
    if (
        isinstance(e, Tup)
        and len(e.items) >= 2
        and all(isinstance(it, RNZ) for it in e.items)
        and len({len(it.args) for it in e.items}) == 1
    ):
        k = len(e.items[0].args)
        rs = tuple(it.r for it in e.items)
        fs = tuple(it.f for it in e.items)
        args = tuple(
            Tup(tuple(it.args[j] for it in e.items)) for j in range(k)
        )
        return RNZ(FnProd(rs), FnProd(fs), args)
    return None


@rule
def fanout_fuse(e):
    """(map f x, map g x) = map (fanOut f g) x (eq 32)."""
    if (
        isinstance(e, Tup)
        and len(e.items) >= 2
        and all(isinstance(it, MapN) for it in e.items)
        and len({it.args for it in e.items}) == 1
    ):
        return MapN(FanOut(tuple(it.f for it in e.items)), e.items[0].args)
    return None


# ---------------------------------------------------------------------------
# exchange group — operate on nested HoFs, inserting matching flips
# ---------------------------------------------------------------------------


def _single_param_lam(f) -> Optional[Lam]:
    return f if isinstance(f, Lam) and len(f.params) == 1 else None


@rule
def map_map_exchange(e):
    """map (\\x -> map (\\y -> b) u) v  =  flip -2 -1 (map (\\y -> map (\\x -> b) v) u)

    (paper eqs 36-37; the result is 'the same up to a flip in the functor
    structure', which we make explicit so the rule is semantics-preserving.)
    """
    if not (isinstance(e, MapN) and len(e.args) == 1):
        return None
    lam_x = _single_param_lam(e.f)
    if lam_x is None or not isinstance(lam_x.body, MapN):
        return None
    inner = lam_x.body
    if len(inner.args) != 1:
        return None
    x = lam_x.params[0]
    u = inner.args[0]
    if x in free_vars(u):
        return None  # inner operand depends on the outer binder: cannot lift
    v = e.args[0]
    lam_y = inner.f
    if not isinstance(lam_y, Lam) or len(lam_y.params) != 1:
        return None
    y = lam_y.params[0]
    swapped = MapN(
        Lam((y,), MapN(Lam((x,), lam_y.body), (v,))),
        (u,),
    )
    return Flip(-2, -1, swapped)


@rule
def map_rnz_exchange(e):
    """map (\\a -> rnz r m a u) A = rnz (lift r) (\\c q -> map (\\α -> m α q) c) (flip -2 -1 A) u

    (paper eq 42 — the locality-critical exchange.)  Matches when the rnz's
    first argument is exactly the map binder and the second is independent.
    """
    if not (isinstance(e, MapN) and len(e.args) == 1):
        return None
    lam_a = _single_param_lam(e.f)
    if lam_a is None or not isinstance(lam_a.body, RNZ):
        return None
    rnz_ = lam_a.body
    if len(rnz_.args) != 2:
        return None
    a = lam_a.params[0]
    if rnz_.args[0] != Var(a):
        return None
    u = rnz_.args[1]
    if a in free_vars(u) or a in free_vars(rnz_.r) or a in free_vars(rnz_.f):
        return None
    A = e.args[0]
    c, q, al = fresh("c"), fresh("q"), fresh("al")
    zipper = Lam(
        (c, q),
        MapN(Lam((al,), App(rnz_.f, (Var(al), Var(q)))), (Var(c),)),
    )
    return RNZ(E.lift(rnz_.r), zipper, (Flip(-2, -1, A), u))


@rule
def rnz_map_exchange(e):
    """Inverse of eq 42: rnz (lift r) (\\c q -> map (\\α -> m α q) c) A u
    = map (\\a -> rnz r m a u) (flip -2 -1 A)."""
    if not (isinstance(e, RNZ) and len(e.args) == 2):
        return None
    # reducer must be a lift: \la lb -> nzip r (la, lb)
    r = None
    if isinstance(e.r, Lam) and len(e.r.params) == 2:
        b = e.r.body
        if (
            isinstance(b, MapN)
            and b.args == (Var(e.r.params[0]), Var(e.r.params[1]))
            and not (free_vars(b.f) & set(e.r.params))
        ):
            r = b.f
    if r is None:
        return None
    zipper = e.f
    if not isinstance(zipper, Lam) or len(zipper.params) != 2:
        return None
    c, q = zipper.params
    zb = zipper.body
    if not (isinstance(zb, MapN) and len(zb.args) == 1 and zb.args[0] == Var(c)):
        return None
    lam_al = _single_param_lam(zb.f)
    if lam_al is None:
        return None
    al = lam_al.params[0]
    if not (
        isinstance(lam_al.body, App)
        and lam_al.body.args == (Var(al), Var(q))
        and not (free_vars(lam_al.body.fn) & {c, q, al})
    ):
        return None
    m = lam_al.body.fn
    A, u = e.args
    a = fresh("a")
    return MapN(
        Lam((a,), RNZ(r, m, (Var(a), u))),
        (Flip(-2, -1, A),),
    )


@rule
def rnz_rnz_exchange(e):
    """rnz r (\\a… -> rnz r m a… B…) A… =
       rnz r (\\a… b… -> rnz r (\\α… -> m α… b…) a…) (flip A…)… B…

    (paper eq 43; requires r commutative + associative.)
    """
    if not isinstance(e, RNZ):
        return None
    if not (isinstance(e.r, Prim) and e.r.name in COMMUTATIVE_ASSOCIATIVE):
        return None
    outer_lam = e.f
    if not isinstance(outer_lam, Lam) or not isinstance(outer_lam.body, RNZ):
        return None
    inner = outer_lam.body
    if inner.r != e.r:
        return None
    ps = outer_lam.params
    k = len(ps)
    if len(e.args) != k:
        return None
    # inner args must be the outer binders (in order) followed by extras
    if tuple(inner.args[:k]) != tuple(Var(p) for p in ps):
        return None
    extras = inner.args[k:]
    if not extras:
        return None
    bound = set(ps)
    if any(free_vars(x) & bound for x in extras):
        return None
    if free_vars(inner.f) & bound:
        return None
    m = inner.f
    bs = tuple(fresh("b") for _ in extras)
    als = tuple(fresh("al") for _ in ps)
    new_inner = RNZ(
        e.r,
        Lam(als, App(m, tuple(Var(a) for a in als) + tuple(Var(b) for b in bs))),
        tuple(Var(p) for p in ps),
    )
    new_outer_lam = Lam(ps + bs, new_inner)
    new_args = tuple(Flip(-2, -1, A) for A in e.args) + extras
    return RNZ(e.r, new_outer_lam, new_args)


# ---------------------------------------------------------------------------
# subdivision group
# ---------------------------------------------------------------------------


def make_map_subdiv(b: int) -> Rule:
    """map f xs… = flatten -2 (map (\\x… -> map f x…) (subdiv -1 b xs)…)  (eq 44)."""

    def map_subdiv(e):
        if not isinstance(e, MapN):
            return None
        xs = tuple(fresh("blk") for _ in e.args)
        inner = MapN(e.f, tuple(Var(x) for x in xs))
        outer = MapN(
            Lam(xs, inner), tuple(Subdiv(-1, b, a) for a in e.args)
        )
        return Flatten(-2, outer)

    map_subdiv.__name__ = f"map_subdiv[{b}]"
    return map_subdiv


def make_rnz_subdiv(b: int) -> Rule:
    """rnz r f xs… = rnz r (\\x… -> rnz r f x…) (subdiv -1 b xs)…

    Reduction regrouping over blocks — valid because r is associative
    (grouping changes only; order is preserved, so commutativity is NOT
    required, matching the paper's remark below eq 16).
    """

    def rnz_subdiv(e):
        if not isinstance(e, RNZ):
            return None
        xs = tuple(fresh("blk") for _ in e.args)
        inner = RNZ(e.r, e.f, tuple(Var(x) for x in xs))
        return RNZ(
            e.r, Lam(xs, inner), tuple(Subdiv(-1, b, a) for a in e.args)
        )

    rnz_subdiv.__name__ = f"rnz_subdiv[{b}]"
    return rnz_subdiv


# layout-op cancellations -----------------------------------------------------


@rule
def flip_flip(e):
    if (
        isinstance(e, Flip)
        and isinstance(e.x, Flip)
        and {e.d1, e.d2} == {e.x.d1, e.x.d2}
    ):
        return e.x.x
    return None


@rule
def flatten_subdiv(e):
    """flatten d (subdiv d b x) = x"""
    if isinstance(e, Flatten) and isinstance(e.x, Subdiv) and e.d == e.x.d:
        return e.x.x
    return None


@rule
def subdiv_flatten(e):
    """subdiv d b (flatten d x) = x   when the flattened inner extent was b"""
    # only safe when extents match; we keep it conservative: no static types,
    # so this cancellation is applied by the engine only when it tracked the
    # subdivision itself (see rewrite.Normalizer).
    return None


FUSION_RULES = [
    RULES[n]
    for n in [
        "beta", "app_id", "proj_tup",
        "nzip_nzip_fuse", "rnz_nzip_fuse",
        "tup_map_fuse", "tup_rnz_fuse", "fanout_fuse",
        "flip_flip", "flatten_subdiv",
    ]
]
