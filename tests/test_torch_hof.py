"""The port's HoF formalism against the reference: interpreter, rules,
rewrite engine, layouts and the variant interpreter.

Every expression is built by one builder that takes the ``expr`` module,
so the same tree is built in each package from the same seeded stream;
inputs are numpy arrays built once.  For each rewrite rule the two
packages' rewrites are compared structurally (a walk to nested tuples of
class name and fields, with both fresh-name counters started at the same
point) and both trees are interpreted on the same inputs (rtol 1e-10).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import expr as RE
from repro.core import interp as RI
from repro.core import rewrite as RW
from repro.core import rules as RR
from repro.core.enumerate import evaluate_variant as ref_evaluate_variant
from repro.core.layout import Layout as RLayout
from repro.core.layout import View as RView

from repro_torch.core import enumerate as PEN
from repro_torch.core import expr as PE
from repro_torch.core import interp as PI
from repro_torch.core import rewrite as PW
from repro_torch.core import rules as PR
from repro_torch.core.layout import Layout as PLayout
from repro_torch.core.layout import View as PView

#: (expr module, rules module, rewrite module, interp module) per package
REF = (RE, RR, RW, RI)
PORT = (PE, PR, PW, PI)
RTOL = 1e-10


def walk(e):
    """A tree as nested tuples of class name and fields."""
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        return (type(e).__name__,) + tuple(
            walk(getattr(e, f.name)) for f in dataclasses.fields(e))
    if isinstance(e, tuple):
        return tuple(walk(x) for x in e)
    return e


@pytest.fixture(autouse=True)
def _same_fresh_names(monkeypatch):
    """Both packages' fresh-name counters from the same start, so a rule
    that invents binders invents the same names in each."""
    monkeypatch.setattr(RE, "_fresh_counter", itertools.count(10_000))
    monkeypatch.setattr(PE, "_fresh_counter", itertools.count(10_000))


def _restart_fresh():
    RE._fresh_counter = itertools.count(20_000)
    PE._fresh_counter = itertools.count(20_000)


def _assert_same(after, before):
    if isinstance(before, tuple):
        assert isinstance(after, tuple) and len(after) == len(before)
        for a, b in zip(after, before):
            _assert_same(a, b)
        return
    np.testing.assert_allclose(
        np.asarray(after, np.float64), np.asarray(before, np.float64),
        rtol=RTOL, atol=RTOL,
    )


# ---------------------------------------------------------------------------
# builders: the cases of tests/test_rules.py, over either expr module
# ---------------------------------------------------------------------------


def _scalar_body(E, rng, names):
    e = E.v(names[0])
    for n in names[1:]:
        op = rng.choice(["+", "*", "-"])
        e = E.App(E.Prim(op), (e, E.v(n)))
    if rng.random() < 0.5:
        e = E.App(E.Prim("+"), (e, E.Lit(float(rng.integers(1, 4)))))
    return e


def _unary(E, rng):
    op = rng.choice(["neg", "sq", "exp", "id"])
    p = f"u{rng.integers(1 << 20)}"
    return E.lam(p, E.App(E.Prim(op), (E.v(p),)))


def _gen_beta(E, rng):
    n = int(rng.integers(2, 5))
    x = rng.standard_normal(n)
    p = "bx"
    body = E.App(E.Prim("*"), (E.v(p), E.App(E.Prim("+"), (E.v(p), E.Lit(2.0)))))
    return E.App(E.Lam((p,), body), (E.v("x"),)), {"x": x}


def _gen_eta(E, rng):
    n = int(rng.integers(2, 5))
    x = rng.standard_normal(n)
    op = rng.choice(["neg", "sq", "exp"])
    return E.map1(E.lam("ex", E.App(E.Prim(op), (E.v("ex"),))), E.v("x")), {"x": x}


def _gen_app_id(E, rng):
    n = int(rng.integers(2, 5))
    return E.App(E.Prim("id"), (E.v("x"),)), {"x": rng.standard_normal(n)}


def _gen_proj_tup(E, rng):
    n = int(rng.integers(2, 5))
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    i = int(rng.integers(0, 2))
    items = (E.v("x"), E.App(E.Prim("neg"), (E.v("y"),)))
    return E.Proj(i, E.Tup(items)), {"x": x, "y": y}


def _gen_nzip_nzip_fuse(E, rng):
    n = int(rng.integers(2, 6))
    x, y, z = (rng.standard_normal(n) for _ in range(3))
    inner = E.zip2(E.Prim(rng.choice(["+", "*"])), E.v("y"), E.v("z"))
    if rng.random() < 0.5:
        e = E.MapN(E.Prim(rng.choice(["+", "*"])), (E.v("x"), inner))
    else:
        e = E.MapN(E.Prim(rng.choice(["+", "*"])), (inner, E.v("x")))
    return e, {"x": x, "y": y, "z": z}


def _gen_rnz_nzip_fuse(E, rng):
    n = int(rng.integers(2, 6))
    u, w, g = (rng.standard_normal(n) for _ in range(3))
    inner = E.zip2(E.Prim("*"), E.v("w"), E.v("g"))
    e = E.RNZ(E.Prim(rng.choice(["+", "max"])), E.Prim("*"), (E.v("u"), inner))
    return e, {"u": u, "w": w, "g": g}


def _gen_tup_map_fuse(E, rng):
    n = int(rng.integers(2, 6))
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    e = E.Tup((E.map1(_unary(E, rng), E.v("x")), E.map1(_unary(E, rng), E.v("y"))))
    return e, {"x": x, "y": y}


def _gen_tup_rnz_fuse(E, rng):
    n = int(rng.integers(2, 6))
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    r1, r2 = rng.choice(["+", "max", "min", "*"], size=2)
    e = E.Tup((E.reduce1(E.Prim(r1), E.v("x")), E.reduce1(E.Prim(r2), E.v("y"))))
    return e, {"x": x, "y": y}


def _gen_fanout_fuse(E, rng):
    n = int(rng.integers(2, 6))
    x = rng.standard_normal(n)
    e = E.Tup((E.map1(_unary(E, rng), E.v("x")), E.map1(_unary(E, rng), E.v("x"))))
    return e, {"x": x}


def _gen_map_map_exchange(E, rng):
    n, m = int(rng.integers(2, 5)), int(rng.integers(2, 5))
    w, u = rng.standard_normal(n), rng.standard_normal(m)
    body = _scalar_body(E, rng, ["mx", "my"])
    e = E.map1(E.lam("mx", E.map1(E.Lam(("my",), body), E.v("u"))), E.v("w"))
    return e, {"w": w, "u": u}


def _gen_map_rnz_exchange(E, rng):
    n, m = int(rng.integers(2, 5)), int(rng.integers(2, 5))
    A, u = rng.standard_normal((n, m)), rng.standard_normal(m)
    r = rng.choice(["+", "max"])
    e = E.map1(E.lam("r", E.RNZ(E.Prim(r), E.Prim("*"), (E.v("r"), E.v("u")))),
               E.v("A"))
    return e, {"A": A, "u": u}


def _gen_rnz_map_exchange(E, rng):
    # the inverse rule's redexes are the forward rule's images
    e, arrays = _gen_map_rnz_exchange(E, rng)
    rules, rewrite = (RR, RW) if E is RE else (PR, PW)
    path = rewrite.find_matches(e, rules.map_rnz_exchange)[0]
    return rewrite.apply_at(e, path, rules.map_rnz_exchange), arrays


def _gen_rnz_rnz_exchange(E, rng):
    n, m = int(rng.integers(2, 5)), int(rng.integers(2, 5))
    A1, A2 = rng.standard_normal((n, m)), rng.standard_normal((n, m))
    B = rng.standard_normal(m)
    body = E.App(E.Prim("*"), (E.App(E.Prim("*"), (E.v("x"), E.v("y"))), E.v("b")))
    e = E.RNZ(
        E.Prim("+"),
        E.lam(("a1", "a2"), E.RNZ(E.Prim("+"), E.lam(("x", "y", "b"), body),
                                  (E.Var("a1"), E.Var("a2"), E.v("B")))),
        (E.v("A1"), E.v("A2")),
    )
    return e, {"A1": A1, "A2": A2, "B": B}


def _gen_flip_flip(E, rng):
    shape = tuple(int(rng.integers(2, 4)) for _ in range(3))
    A = rng.standard_normal(shape)
    d1 = int(rng.integers(0, 2))
    d2 = int(rng.integers(d1 + 1, 3))
    return E.Flip(d1, d2, E.Flip(d1, d2, E.v("A"))), {"A": A}


def _gen_flatten_subdiv(E, rng):
    n, b = [(6, 2), (6, 3), (8, 4), (4, 2)][int(rng.integers(0, 4))]
    m = 2 * int(rng.integers(1, 3))
    A = rng.standard_normal((m, n))
    d = int(rng.integers(0, 2))
    return E.Flatten(d, E.Subdiv(d, b if d == 0 else 2, E.v("A"))), {"A": A}


def _gen_map_subdiv(E, rng):
    n, b = [(6, 2), (6, 3), (8, 4), (12, 3)][int(rng.integers(0, 4))]
    x = rng.standard_normal(n)
    return E.map1(E.lam("a", E.App(E.Prim("*"), (E.v("a"), E.v("a")))), E.v("x")), {"x": x}


def _gen_rnz_subdiv(E, rng):
    n, b = [(6, 2), (6, 3), (8, 4), (12, 3)][int(rng.integers(0, 4))]
    u, w = rng.standard_normal(n), rng.standard_normal(n)
    return E.dot(E.v("u"), E.v("w")), {"u": u, "w": w}


RULE_GENERATORS = {
    "beta": _gen_beta,
    "eta": _gen_eta,
    "app_id": _gen_app_id,
    "proj_tup": _gen_proj_tup,
    "nzip_nzip_fuse": _gen_nzip_nzip_fuse,
    "rnz_nzip_fuse": _gen_rnz_nzip_fuse,
    "tup_map_fuse": _gen_tup_map_fuse,
    "tup_rnz_fuse": _gen_tup_rnz_fuse,
    "fanout_fuse": _gen_fanout_fuse,
    "map_map_exchange": _gen_map_map_exchange,
    "map_rnz_exchange": _gen_map_rnz_exchange,
    "rnz_map_exchange": _gen_rnz_map_exchange,
    "rnz_rnz_exchange": _gen_rnz_rnz_exchange,
    "flip_flip": _gen_flip_flip,
    "flatten_subdiv": _gen_flatten_subdiv,
}
#: the subdivision rules are factories of a block size
FACTORY_GENERATORS = {
    "make_map_subdiv": (_gen_map_subdiv, (2, 3)),
    "make_rnz_subdiv": (_gen_rnz_subdiv, (2, 3)),
}


def _lift_into_map(E, e, arrays, rng):
    """``e`` inside an outer map: every array gains a leading dim."""
    L = int(rng.integers(2, 4))
    names = sorted(arrays)
    params = {n: E.fresh(n.lower()) for n in names}
    body = E.subst(e, {n: E.Var(p) for n, p in params.items()})
    lifted = E.MapN(E.Lam(tuple(params[n] for n in names), body),
                    tuple(E.v(n) for n in names))
    stacked = {n: np.stack([rng.standard_normal(np.shape(arrays[n]))
                            for _ in range(L)]) for n in names}
    return lifted, stacked


def _build(pkg, gen, seed, lift):
    E = pkg[0]
    rng = np.random.default_rng(seed)
    e, arrays = gen(E, rng)
    if lift:
        e, arrays = _lift_into_map(E, e, arrays, rng)
    return e, arrays


def _both(gen, seed, lift):
    """The case built in each package; the same inputs and the same tree."""
    _restart_fresh()
    e_ref, arrays = _build(REF, gen, seed, lift)
    _restart_fresh()
    e_port, arrays_port = _build(PORT, gen, seed, lift)
    assert sorted(arrays) == sorted(arrays_port)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], arrays_port[k])
    assert walk(e_port) == walk(e_ref)
    return e_ref, e_port, arrays


def _check_rule(rule_ref, rule_port, e_ref, e_port, arrays):
    paths = RW.find_matches(e_ref, rule_ref)
    assert paths, f"no redex for {rule_ref.__name__}: {e_ref!r}"
    assert PW.find_matches(e_port, rule_port) == paths
    before = RI.run(e_ref, **arrays)
    _assert_same(PI.run(e_port, **arrays), before)
    for path in paths:
        _restart_fresh()
        r_ref = RW.apply_at(e_ref, path, rule_ref)
        _restart_fresh()
        r_port = PW.apply_at(e_port, path, rule_port)
        assert walk(r_port) == walk(r_ref), path
        after = PI.run(r_port, **arrays)
        _assert_same(after, RI.run(r_ref, **arrays))
        _assert_same(after, before)


SEEDS = (0, 1, 2)


def test_rule_inventory_is_the_references():
    assert list(PR.RULES) == list(RR.RULES)
    assert set(PR.RULES) == set(RULE_GENERATORS) | {"subdiv_flatten"}
    assert [r.__name__ for r in PR.FUSION_RULES] == [
        r.__name__ for r in RR.FUSION_RULES]


@pytest.mark.parametrize("lift", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(RULE_GENERATORS))
def test_rule_rewrites_as_the_reference(name, seed, lift):
    e_ref, e_port, arrays = _both(RULE_GENERATORS[name], seed, lift)
    _check_rule(RR.RULES[name], PR.RULES[name], e_ref, e_port, arrays)


@pytest.mark.parametrize("lift", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("factory", sorted(FACTORY_GENERATORS))
def test_subdivision_rules_rewrite_as_the_reference(factory, seed, lift):
    gen, blocks = FACTORY_GENERATORS[factory]
    e_ref, e_port, arrays = _both(gen, seed, lift)
    n = next(iter(arrays.values())).shape[-1]
    for b in blocks:
        if n % b:
            continue
        rule_ref, rule_port = getattr(RR, factory)(b), getattr(PR, factory)(b)
        assert rule_port.__name__ == rule_ref.__name__
        if not lift:
            _check_rule(rule_ref, rule_port, e_ref, e_port, arrays)
            continue
        # inside the lift the subdivision acts on the per-slice operand:
        # apply it at the inner redex (the rule matches at the root too,
        # where it would subdivide the lift's own dim)
        paths = [p for p in RW.find_matches(e_ref, rule_ref) if p]
        assert paths and [p for p in PW.find_matches(e_port, rule_port)
                          if p] == paths
        for path in paths:
            _restart_fresh()
            r_ref = RW.apply_at(e_ref, path, rule_ref)
            _restart_fresh()
            r_port = PW.apply_at(e_port, path, rule_port)
            assert walk(r_port) == walk(r_ref)
            _assert_same(PI.run(r_port, **arrays), RI.run(e_ref, **arrays))


def test_subdiv_flatten_matches_nothing_in_either():
    for E, R, W in ((RE, RR, RW), (PE, PR, PW)):
        e = E.Subdiv(0, 3, E.Flatten(0, E.Subdiv(0, 3, E.v("x"))))
        assert R.subdiv_flatten(e) is None
        assert not W.find_matches(e, R.subdiv_flatten)


# ---------------------------------------------------------------------------
# the engine: fuse / normalize give the reference's traces
# ---------------------------------------------------------------------------


def _eq1(E, rng):
    """The paper's motivating eq 1: (A + B)(v + u) row by row."""
    arrays = {"A": rng.standard_normal((3, 4)), "B": rng.standard_normal((3, 4)),
              "vv": rng.standard_normal(4), "u": rng.standard_normal(4)}
    row_sum = E.zip2(E.Prim("+"), E.v("rA"), E.v("rB"))
    vec_sum = E.zip2(E.Prim("+"), E.v("vv"), E.v("u"))
    e = E.MapN(E.lam(("rA", "rB"), E.reduce1(
        E.Prim("+"), E.zip2(E.Prim("*"), row_sum, vec_sum))),
        (E.v("A"), E.v("B")))
    return e, arrays


def _map_map(E, rng):
    f = E.lam("a", E.App(E.Prim("*"), (E.v("a"), E.Lit(3.0))))
    g = E.lam("a", E.App(E.Prim("+"), (E.v("a"), E.Lit(1.0))))
    return E.map1(f, E.map1(g, E.v("x"))), {"x": rng.standard_normal(5)}


def _dot_of_zip(E, rng):
    e = E.reduce1(E.Prim("+"), E.zip2(E.Prim("*"), E.v("u"), E.v("w")))
    return e, {"u": rng.standard_normal(6), "w": rng.standard_normal(6)}


def _tuples(E, rng):
    f = E.lam("a", E.App(E.Prim("*"), (E.v("a"), E.Lit(2.0))))
    g = E.lam("a", E.App(E.Prim("neg"), (E.v("a"),)))
    e = E.Tup((E.map1(f, E.v("x")), E.map1(g, E.v("x"))))
    return e, {"x": rng.standard_normal(4)}


def _matvec_round_trip(E, rng):
    """eq 42 forwards and back: a flip of a flip for normalize to cancel."""
    rules, rewrite = (RR, RW) if E is RE else (PR, PW)
    e = E.map1(E.lam("r", E.RNZ(E.Prim("+"), E.Prim("*"), (E.v("r"), E.v("u")))),
               E.v("A"))
    e = rewrite.apply_at(e, rewrite.find_matches(e, rules.map_rnz_exchange)[0],
                         rules.map_rnz_exchange)
    e = rewrite.apply_at(e, rewrite.find_matches(e, rules.rnz_map_exchange)[0],
                         rules.rnz_map_exchange)
    return e, {"A": rng.standard_normal((3, 5)), "u": rng.standard_normal(5)}


def _beta_redex(E, rng):
    e = E.App(E.lam("x", E.App(E.Prim("+"), (E.v("x"), E.Lit(1.0)))), (E.Lit(2.0),))
    return e, {}


ENGINE_CASES = {
    "eq1": (_eq1, "fuse", None),
    "map_map": (_map_map, "fuse", None),
    "dot_of_zip": (_dot_of_zip, "fuse", None),
    "tuples": (_tuples, "fuse", None),
    "matvec_round_trip": (_matvec_round_trip, "normalize", ["flip_flip"]),
    "beta": (_beta_redex, "normalize", ["beta"]),
}


def _steps(trace):
    return [(s.rule, s.path, s.before_size, s.after_size) for s in trace.steps]


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_fuse_and_normalize_give_the_references_trace(case):
    builder, how, rule_names = ENGINE_CASES[case]
    out = {}
    for pkg in (REF, PORT):
        E, R, W, I = pkg
        _restart_fresh()
        e, arrays = builder(E, np.random.default_rng(7))
        trace = W.Trace()
        if how == "fuse":
            res = W.fuse(e, trace=trace)
        else:
            res = W.normalize(e, [R.RULES[n] for n in rule_names], trace=trace)
        out[pkg[0].__name__] = (res, trace, arrays, I)
    (r_ref, t_ref, arrays, _), (r_port, t_port, _, _) = out.values()
    assert _steps(t_port) == _steps(t_ref)
    assert repr(t_port) == repr(t_ref)
    assert walk(r_port) == walk(r_ref)
    _assert_same(PI.run(r_port, **arrays), RI.run(r_ref, **arrays))


def test_rewrite_once_and_get_at_replace_at():
    _restart_fresh()
    e_ref, arrays = _eq1(RE, np.random.default_rng(3))
    _restart_fresh()
    e_port, _ = _eq1(PE, np.random.default_rng(3))
    r_ref, c_ref = RW.rewrite_once(e_ref, RR.FUSION_RULES)
    r_port, c_port = PW.rewrite_once(e_port, PR.FUSION_RULES)
    assert c_port == c_ref and walk(r_port) == walk(r_ref)
    path = (0, 0)
    assert walk(PW.get_at(e_port, path)) == walk(RW.get_at(e_ref, path))
    assert walk(PW.replace_at(e_port, path, PE.v("z"))) == walk(
        RW.replace_at(e_ref, path, RE.v("z")))


# ---------------------------------------------------------------------------
# the interpreter's tables, arity
# ---------------------------------------------------------------------------


def test_prims_and_arity_are_the_references():
    assert {k: p.arity for k, p in PI.PRIMS.items()} == {
        k: p.arity for k, p in RI.PRIMS.items()}
    assert PI.COMMUTATIVE_ASSOCIATIVE == RI.COMMUTATIVE_ASSOCIATIVE
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal(4), rng.standard_normal(4)
    for k, p in PI.PRIMS.items():
        args = (a, b)[:p.arity]
        np.testing.assert_array_equal(p.fn(*args), RI.PRIMS[k].fn(*args))
    for E in (RE, PE):
        assert E.arity(E.Prim("max")) == 2
        assert E.arity(E.lam(("p", "q", "r"), E.v("p"))) == 3
        assert E.arity(E.v("f")) is None


# ---------------------------------------------------------------------------
# layouts: the cases of tests/test_layout.py
# ---------------------------------------------------------------------------


LAYOUT_SHAPES = [(4, 5, 2, 3), (10, 6), (8, 6), (4, 5, 6), (3, 4), (4, 6)]


def _layout_chain(seed):
    """A random subdiv / flip / flatten chain from a row-major shape, as
    ``tests/test_layout.py``'s strategy draws one."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(rng.choice([1, 2, 3, 4, 6]))
                  for _ in range(int(rng.integers(1, 4))))
    lay = RLayout.row_major(shape)
    ops = []
    for _ in range(int(rng.integers(0, 5))):
        kind = rng.choice(["subdiv", "flip", "flatten"])
        if kind == "subdiv" and lay.rank < 5:
            d = int(rng.integers(0, lay.rank))
            e = lay.dims[d][0]
            b = int(rng.choice([b for b in range(1, e + 1) if e % b == 0]))
            ops.append(("subdiv", d, b))
        elif kind == "flip" and lay.rank >= 2:
            d1 = int(rng.integers(0, lay.rank - 1))
            d2 = int(rng.integers(d1 + 1, lay.rank))
            ops.append(("flip", d1, d2))
        elif kind == "flatten" and lay.rank >= 2:
            cands = [d for d in range(lay.rank - 1)
                     if lay.dims[d + 1][1] == lay.dims[d][0] * lay.dims[d][1]]
            if not cands:
                continue
            ops.append(("flatten", int(rng.choice(cands))))
        else:
            continue
        lay = getattr(lay, ops[-1][0])(*ops[-1][1:])
    return shape, ops


@pytest.mark.parametrize("shape", LAYOUT_SHAPES)
def test_layout_queries_are_the_references(shape):
    r, p = RLayout.row_major(shape), PLayout.row_major(shape)
    assert p.dims == r.dims and p.size == r.size and p.rank == r.rank
    assert p.shape_outer_first() == r.shape_outer_first()
    assert list(p.indices()) == list(r.indices())
    idx = tuple(e - 1 for e in p.extents)
    assert p.offset(idx) == r.offset(idx)
    assert p.is_separable() == r.is_separable()


def test_layout_paper_example_and_refusals():
    assert PLayout.row_major((4, 5, 2, 3)).dims == ((3, 1), (2, 3), (5, 6), (4, 30))
    sub_r = RLayout.row_major((10, 6)).subdiv(0, 3).subdiv(2, 2)
    sub_p = PLayout.row_major((10, 6)).subdiv(0, 3).subdiv(2, 2)
    assert sub_p.dims == sub_r.dims
    for L in (RLayout, PLayout):
        with pytest.raises(ValueError):
            L.row_major((4, 6)).flip(0, 1).flatten(0)
        with pytest.raises(ValueError):
            L.row_major((4, 6)).subdiv(0, 4)
    buf = np.arange(12, dtype=np.float64)
    np.testing.assert_array_equal(
        PView(buf, PLayout.row_major((3, 4))).flip(0, 1).materialize(),
        RView(buf, RLayout.row_major((3, 4))).flip(0, 1).materialize())


@pytest.mark.parametrize("seed", range(24))
def test_view_chains_are_the_references(seed):
    shape, ops = _layout_chain(seed)
    buf = np.arange(int(np.prod(shape)), dtype=np.float64)
    vr = RView(buf, RLayout.row_major(shape))
    vp = PView(buf, PLayout.row_major(shape))
    for op in ops:
        vr = getattr(vr, op[0])(*op[1:])
        vp = getattr(vp, op[0])(*op[1:])
        assert vp.layout.dims == vr.layout.dims
    np.testing.assert_array_equal(vp.materialize(), vr.materialize())
    assert vp.layout.is_separable() == vr.layout.is_separable()
    assert vp.layout.reshape_transpose_plan() == vr.layout.reshape_transpose_plan()
    np.testing.assert_array_equal(
        PView.from_logical(buf.reshape(shape)).materialize(),
        RView.from_logical(buf.reshape(shape)).materialize())


# ---------------------------------------------------------------------------
# evaluate_variant over every variant order of the six differential families
# ---------------------------------------------------------------------------

FAMILIES = {
    "matmul_spec": (4, 6, 3),
    "matvec_spec": (6, 4),
    "weighted_matmul_spec": (3, 4, 6),
    "batched_matmul_spec": (2, 3, 4, 2),
    "transposed_matmul_spec": (4, 3, 2),
    "chain_matmul_spec": (3, 2, 4, 2),
}


def _arrays(spec, seed):
    rng = np.random.default_rng(seed)
    root = spec.root()
    return {n: rng.standard_normal(tuple(root.extents[i] for i in ax))
            for n, ax in root.operands.items()}


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evaluate_variant_over_every_order(family, split):
    from repro.core import enumerate as REN

    ref_spec = getattr(REN, family)(*FAMILIES[family])
    spec = getattr(PEN, family)(*FAMILIES[family])
    if split:  # subdivide an even index by 2, a reduced one first
        red = next(i for i in sorted(spec.indices,
                                     key=lambda i: spec.kind(i) != "rnz")
                   if spec.extents[i] % 2 == 0)
        ref_spec, spec = ref_spec.subdivide(red, 2), spec.subdivide(red, 2)
    arrays = _arrays(spec, 11)
    orders = PEN.variant_orders(spec)
    assert orders == REN.variant_orders(ref_spec)
    want = np.einsum(PEN.einsum_formula(spec), *arrays.values())
    for order in orders:
        got = PEN.evaluate_variant(spec, order, arrays)
        np.testing.assert_allclose(got, ref_evaluate_variant(ref_spec, order, arrays),
                                   rtol=RTOL, atol=RTOL, err_msg=str(order))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
