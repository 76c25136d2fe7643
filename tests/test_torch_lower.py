"""The port's lowering, executor, cost models, tuner and paper scripts
against the reference.

``torch_run`` / ``contraction_to_torch`` are held to ``jax_run`` /
``contraction_to_jax`` (the reference runs in f32 with x64 off, the port
keeps f64: rtol 1e-4, atol 1e-5, and 1e-5 for the variants);
``execute_variant`` in f64 on both sides at rtol 1e-10; the cost models
give equal floats and the tuner the same ranking.  Inputs are numpy arrays
built once from a seed and handed to both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import autotune as RA
from repro.core import cost as RC
from repro.core import enumerate as REN
from repro.core import expr as RE
from repro.core.execute import execute_variant as ref_execute_variant
from repro.core.lower import contraction_to_jax, jax_run
from repro.core.rewrite import fuse as ref_fuse

from repro_torch.codegen import AutotuneCache
from repro_torch.core import autotune as PA
from repro_torch.core import cost as PC
from repro_torch.core import enumerate as PEN
from repro_torch.core import expr as PE
from repro_torch.core.execute import TAILS, execute_variant
from repro_torch.core.lower import contraction_to_torch, torch_fn, torch_run
from repro_torch.core.rewrite import fuse as port_fuse


def rnd(*shape, seed=0):
    return np.random.default_rng(seed + sum(shape)).standard_normal(shape)


# ---------------------------------------------------------------------------
# torch_run against jax_run: the cases of tests/test_lower.py and more
# ---------------------------------------------------------------------------


def _matvec(E):
    e = E.map1(E.lam("r", E.dot(E.v("r"), E.v("u"))), E.v("A"))
    return e, {"A": rnd(4, 6), "u": rnd(6)}


def _fused_pipeline(E):
    row_sum = E.zip2(E.Prim("+"), E.v("rA"), E.v("rB"))
    vec_sum = E.zip2(E.Prim("+"), E.v("vv"), E.v("u"))
    e = E.MapN(
        E.lam(("rA", "rB"), E.RNZ(E.Prim("+"), E.Prim("id"),
                                  (E.zip2(E.Prim("*"), row_sum, vec_sum),))),
        (E.v("A"), E.v("B")),
    )
    fuse = ref_fuse if E is RE else port_fuse
    return fuse(e), {"A": rnd(3, 4), "B": rnd(3, 4, seed=1), "vv": rnd(4),
                     "u": rnd(4, seed=2)}


def _flipped_matvec(E):
    e = E.RNZ(
        E.lift(E.Prim("+")),
        E.lam(("c", "q"),
              E.map1(E.lam("e", E.App(E.Prim("*"), (E.v("e"), E.v("q")))),
                     E.v("c"))),
        (E.Flip(0, 1, E.v("A")), E.v("u")),
    )
    return e, {"A": rnd(5, 7), "u": rnd(7)}


def _max_reduce(E):
    """A monoid other than +: rnz max over rows (torch.amax)."""
    e = E.map1(E.lam("r", E.RNZ(E.Prim("max"), E.Prim("*"),
                                (E.v("r"), E.v("u")))), E.v("A"))
    return e, {"A": rnd(4, 5), "u": rnd(5)}


def _min_prod(E):
    e = E.Tup((E.reduce1(E.Prim("min"), E.v("x")),
               E.reduce1(E.Prim("*"), E.v("y"))))
    return e, {"x": rnd(6), "y": rnd(5) * 0.5 + 1.0}


def _general_reducer(E):
    """A lambda reducer: the left fold (the reference's lax.scan)."""
    r = E.lam(("a", "b"), E.App(E.Prim("-"), (E.v("a"), E.v("b"))))
    e = E.RNZ(r, E.Prim("sq"), (E.v("x"),))
    return e, {"x": rnd(7)}


def _constant_body(E):
    """A Lit body: a float returned under vmap."""
    return E.map1(E.lam("a", E.Lit(2.0)), E.v("x")), {"x": rnd(4)}


def _layout_ops(E):
    """subdiv, flip and flatten inside a map (per-example rank under vmap)."""
    inner = E.Flatten(0, E.Flip(0, 1, E.Subdiv(0, 3, E.v("r"))))
    e = E.map1(E.lam("r", E.map1(E.lam("z", E.App(E.Prim("exp"), (E.v("z"),))),
                                 inner)), E.v("A"))
    return e, {"A": rnd(4, 6)}


def _fanout(E):
    f = E.lam("a", E.App(E.Prim("*"), (E.v("a"), E.Lit(2.0))))
    g = E.lam("a", E.App(E.Prim("neg"), (E.v("a"),)))
    return E.MapN(E.FanOut((f, g)), (E.v("x"),)), {"x": rnd(5)}


RUN_CASES = {
    "matvec": _matvec,
    "fused_pipeline": _fused_pipeline,
    "flipped_matvec_eq40": _flipped_matvec,
    "max_reduce": _max_reduce,
    "min_prod": _min_prod,
    "general_reducer": _general_reducer,
    "constant_body": _constant_body,
    "layout_ops": _layout_ops,
    "fanout": _fanout,
}


def _close(got, want, rtol, atol):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_torch_run_matches_jax_run(case):
    e_ref, arrays = RUN_CASES[case](RE)
    e_port, _ = RUN_CASES[case](PE)
    want = jax_run(e_ref, **arrays)
    got = torch_run(e_port, **{k: torch.as_tensor(v) for k, v in arrays.items()})
    _close(got, want, 1e-4, 1e-5)
    fn = torch_fn(e_port, sorted(arrays))
    _close(fn(*(torch.as_tensor(arrays[k]) for k in sorted(arrays))), got,
           1e-12, 1e-12)


# ---------------------------------------------------------------------------
# contraction_to_torch against contraction_to_jax
# ---------------------------------------------------------------------------


def test_contraction_to_torch_all_table1_orders():
    spec, ref_spec = PEN.matmul_spec(8, 6, 10), REN.matmul_spec(8, 6, 10)
    A, B = rnd(8, 6), rnd(6, 10, seed=3)
    orders = PEN.variant_orders(spec, dedup_rnz=False)
    assert len(orders) == 6
    for order in orders:
        want = np.asarray(contraction_to_jax(ref_spec, order)(A, B))
        got = contraction_to_torch(spec, order)(torch.as_tensor(A),
                                                torch.as_tensor(B))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=str(order))
        np.testing.assert_allclose(got.numpy(), A @ B, rtol=1e-12)


@pytest.mark.parametrize("split", [("j", 4), ("i", 2), ("k", 5)])
def test_contraction_to_torch_subdivided(split):
    spec = PEN.matmul_spec(8, 12, 10).subdivide(*split)
    ref_spec = REN.matmul_spec(8, 12, 10).subdivide(*split)
    A, B = rnd(8, 12), rnd(12, 10, seed=4)
    for order in PEN.variant_orders(spec):
        want = np.asarray(contraction_to_jax(ref_spec, order)(A, B))
        got = contraction_to_torch(spec, order)(torch.as_tensor(A),
                                                torch.as_tensor(B))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=str(order))
        np.testing.assert_allclose(got.numpy(), A @ B, rtol=1e-12)


def test_contraction_to_torch_fig3_and_weighted():
    A, u = rnd(16, 16), rnd(16)
    for label, order, spec in PEN.paper_fig3_variants(16, 16, 4):
        ref = dict((l, s) for l, _, s in REN.paper_fig3_variants(16, 16, 4))
        want = np.asarray(contraction_to_jax(ref[label], order)(A, u))
        got = contraction_to_torch(spec, order)(torch.as_tensor(A),
                                                torch.as_tensor(u)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    spec, ref_spec = PEN.weighted_matmul_spec(6, 8, 10), REN.weighted_matmul_spec(6, 8, 10)
    A, B, g = rnd(6, 8), rnd(8, 10, seed=6), rnd(8, seed=7)
    for order in PEN.variant_orders(spec):
        want = np.asarray(contraction_to_jax(ref_spec, order)(A, B, g))
        got = contraction_to_torch(spec, order)(
            *(torch.as_tensor(a) for a in (A, B, g))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# execute_variant: f64 on both sides
# ---------------------------------------------------------------------------


EXEC_SPECS = {
    "table1": (lambda m: m.matmul_spec(12, 8, 10), None),
    "table2": (lambda m: m.matmul_spec(16, 12, 8).subdivide("j", 4), None),
    "weighted": (lambda m: m.weighted_matmul_spec(6, 8, 10), None),
    "batched": (lambda m: m.batched_matmul_spec(2, 4, 6, 3), None),
    "chain": (lambda m: m.chain_matmul_spec(3, 4, 2, 5), None),
    "all_subdiv": (lambda m: m.matmul_spec(8, 8, 8).subdivide("j", 2)
                   .subdivide("i", 4).subdivide("k", 2), None),
}


@pytest.mark.parametrize("vector_levels", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(EXEC_SPECS))
def test_execute_variant_matches_the_reference(case, vector_levels):
    build, _ = EXEC_SPECS[case]
    spec, ref_spec = build(PEN), build(REN)
    root = spec.root()
    rng = np.random.default_rng(9)
    arrays = {n: rng.standard_normal(tuple(root.extents[i] for i in ax))
              for n, ax in root.operands.items()}
    tensors = {n: torch.as_tensor(a) for n, a in arrays.items()}
    for order in PEN.variant_orders(spec)[:8]:
        want = ref_execute_variant(ref_spec, order, arrays, vector_levels)
        TAILS.calls = 0
        got = execute_variant(spec, order, tensors, vector_levels)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10,
                                   err_msg=str(order))
        cut = max(len(order) - vector_levels, 0)
        assert TAILS.calls == int(np.prod([spec.extents[i]
                                           for i in order[:cut]]))


def test_execute_variant_fig3():
    A, u = rnd(32, 32), rnd(32)
    tensors = {"A": torch.as_tensor(A), "u": torch.as_tensor(u)}
    ref = {l: s for l, _, s in REN.paper_fig3_variants(32, 32, 8)}
    for label, order, spec in PEN.paper_fig3_variants(32, 32, 8):
        want = ref_execute_variant(ref[label], order, {"A": A, "u": u})
        got = execute_variant(spec, order, tensors)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# the cost models and the early cut
# ---------------------------------------------------------------------------


def _paper_cases(m):
    """(spec, orders) of Tables 1-2 and Fig 3 at the scripts' sizes."""
    t1 = m.matmul_spec(1024, 1024, 1024)
    t2 = m.matmul_spec(384, 384, 384).subdivide("j", 16)
    out = [(t1, m.variant_orders(t1, dedup_rnz=False)), (t2, m.variant_orders(t2))]
    out += [(s, [o]) for _, o, s in m.paper_fig3_variants(1024, 1024, 64)]
    return out


def test_cpu_and_tpu_cost_are_the_references():
    for (spec, orders), (ref_spec, ref_orders) in zip(_paper_cases(PEN),
                                                      _paper_cases(REN)):
        assert orders == ref_orders
        for order in orders:
            assert PC.cpu_cost(spec, order) == RC.cpu_cost(ref_spec, order)
            for eb in (2, 4, 8):
                assert PC.tpu_cost(spec, order, elem_bytes=eb) == RC.tpu_cost(
                    ref_spec, order, elem_bytes=eb)
        for fn_p, fn_r in ((PC.cpu_cost, RC.cpu_cost), (PC.tpu_cost, RC.tpu_cost)):
            assert PC.rank_variants(spec, orders, fn_p) == RC.rank_variants(
                ref_spec, orders, fn_r)
            assert PC.early_cut(spec, orders, 3, fn_p) == RC.early_cut(
                ref_spec, orders, 3, fn_r)


def test_cost_model_constants_and_roofline_are_the_references():
    assert PC.CPU_HIERARCHY == tuple(
        PC.CacheLevel(l.name, l.capacity, l.miss_cost) for l in RC.CPU_HIERARCHY)
    assert PC.LINE_ELEMS == RC.LINE_ELEMS and PC.TPU == RC.TPU
    assert PC.roofline_terms(1e12, 3e9, 1e8, 4) == RC.roofline_terms(
        1e12, 3e9, 1e8, 4)
    spec, ref_spec = PEN.weighted_matmul_spec(6, 8, 10), REN.weighted_matmul_spec(6, 8, 10)
    assert PC._operand_views(spec) == RC._operand_views(ref_spec)
    for order in PEN.variant_orders(spec):
        assert PC.cpu_cost(spec, order) == RC.cpu_cost(ref_spec, order)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


TUNE_CASES = {
    "matmul_256": (lambda m: m.matmul_spec(256, 256, 256), {"j": [16, 64]}),
    "matmul_64_three": (lambda m: m.matmul_spec(64, 32, 48),
                        {"i": [8], "j": [16, 4], "k": [8, 6]}),
    "weighted": (lambda m: m.weighted_matmul_spec(32, 64, 16), {"j": [8]}),
    "no_splits": (lambda m: m.matmul_spec(96, 64, 32), None),
}


def _ranking(tvs):
    return [(tv.order, tuple(tuple(s) for s in tv.spec.split_chain()),
             tv.predicted_cost) for tv in tvs]


@pytest.mark.parametrize("cost", ["cpu_cost", "tpu_cost"])
@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_tune_ranks_as_the_reference(case, cost):
    build, splits = TUNE_CASES[case]
    spec, ref_spec = build(PEN), build(REN)
    got = PA.tune(spec, subdiv_candidates=splits, cost_fn=getattr(PC, cost),
                  keep=6)
    want = RA.tune(ref_spec, subdiv_candidates=splits,
                   cost_fn=getattr(RC, cost), keep=6)
    assert _ranking(got) == _ranking(want)
    if splits:
        assert [s.split_chain() for s in PA.enumerate_subdivided(spec, splits)] == [
            s.split_chain() for s in RA.enumerate_subdivided(ref_spec, splits)]


def test_tune_cache_key_is_the_references_but_the_cost_module(monkeypatch):
    """The key's payload equals the reference's except the cost function's
    module path (and the hardware fingerprint, which ``cache_key`` adds)."""
    from repro.codegen import cache as ref_cache
    from repro_torch.codegen import cache as port_cache

    seen = {}

    def recorder(tag):
        def cache_key(spec, **kw):
            seen[tag] = kw["extra"]
            return tag
        return cache_key

    monkeypatch.setattr(ref_cache, "cache_key", recorder("ref"))
    monkeypatch.setattr(port_cache, "cache_key", recorder("port"))
    rng = np.random.default_rng(0)
    arrays = {"A": rng.standard_normal((16, 8)), "B": rng.standard_normal((8, 4))}
    splits = {"j": [4, 2]}
    RA._tune_cache_key(REN.matmul_spec(16, 8, 4), splits, RC.cpu_cost, 3, arrays)
    PA._tune_cache_key(PEN.matmul_spec(16, 8, 4), splits, PC.cpu_cost, 3,
                       {k: torch.as_tensor(v) for k, v in arrays.items()})
    assert seen["ref"]["cost_fn"] == "repro.core.cost:cpu_cost"
    assert seen["port"]["cost_fn"] == "repro_torch.core.cost:cpu_cost"
    seen["port"]["cost_fn"] = seen["ref"]["cost_fn"]
    assert seen["port"] == seen["ref"]


def test_tune_round_trips_variants_through_json():
    spec = PEN.matmul_spec(64, 32, 48)
    tvs = PA.tune(spec, subdiv_candidates={"j": [8], "i": [16]}, keep=5)
    back = PA._variants_from_json(PA._variants_to_json(tvs), spec)
    assert _ranking(back) == _ranking(tvs)
    ref_tvs = RA.tune(REN.matmul_spec(64, 32, 48),
                      subdiv_candidates={"j": [8], "i": [16]}, keep=5)
    assert PA._variants_to_json(tvs) == RA._variants_to_json(ref_tvs)


def test_tune_measures_on_cpu_tensors_and_hits_its_cache(tmp_path):
    spec = PEN.matmul_spec(64, 64, 64)
    rng = np.random.default_rng(8)
    arrays = {k: torch.as_tensor(rng.standard_normal((64, 64))) for k in "AB"}
    cache = AutotuneCache(str(tmp_path / "tune.json"))
    kw = dict(subdiv_candidates={"j": [16]}, keep=3, measure_with=arrays,
              repeats=1, cache=cache)
    first = PA.tune(spec, **kw)
    assert len(first) == 3 and all(tv.measured_s is not None for tv in first)
    assert [tv.measured_s for tv in first] == sorted(tv.measured_s for tv in first)
    got = execute_variant(first[0].spec, first[0].order, arrays)
    np.testing.assert_allclose(got.numpy(), (arrays["A"] @ arrays["B"]).numpy(),
                               rtol=1e-10)
    assert (cache.hits, cache.misses) == (0, 1)
    second = PA.tune(spec, **kw)
    assert (cache.hits, cache.misses) == (1, 1)
    assert [(tv.order, tv.spec.split_chain(), tv.measured_s) for tv in second] == [
        (tv.order, tv.spec.split_chain(), tv.measured_s) for tv in first]
    # a fresh instance reads the file back
    third = PA.tune(spec, **{**kw, "cache": AutotuneCache(str(tmp_path / "tune.json"))})
    assert _ranking(third) == _ranking(first)


# ---------------------------------------------------------------------------
# the paper scripts on the CPU at small sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", ["execute", "lower"])
@pytest.mark.parametrize("script", ["table1", "table2", "fig3", "subdiv_sweep"])
def test_paper_scripts_run_on_the_cpu(script, executor, capsys):
    import importlib

    mod = importlib.import_module(f"repro_torch.paper.{script}")
    sizes = {"table1": dict(n=16), "table2": dict(n=32, b=4),
             "fig3": dict(n=32, b=8), "subdiv_sweep": dict(n=16, b=2)}[script]
    out = mod.run(**sizes, device="cpu", executor=executor)
    printed = capsys.readouterr().out.splitlines()
    if script == "subdiv_sweep":
        assert set(out) == {"naive", "maps_subdiv", "rnz_subdiv",
                            "rnz_subdiv_twice", "all_subdiv"}
        assert printed[-1].startswith("subdiv.claim_rnz_beats_maps,")
        return
    n_rows = {"table1": 6, "table2": 12, "fig3": 6}[script]
    assert len(out["rows"]) == n_rows
    assert all(r["s"] > 0 and (r["einsums"] > 0) == (executor == "execute")
               for r in out["rows"])
    names = [line.split(",")[0] for line in printed]
    assert names[:n_rows] == [f"{script}.{r['label']}" for r in out["rows"]]
    if script == "table1":
        assert names[:n_rows] == ["table1." + "/".join(
            {"i": "mapA", "j": "rnz", "k": "mapB"}[i] for i in o)
            for o in REN.variant_orders(REN.matmul_spec(4, 4, 4), dedup_rnz=False)]
        assert "table1.rank_corr_vs_paper" in names
    assert f"{script}.rank_corr_vs_costmodel" in names
    assert -1.0 <= out["rho_model"] <= 1.0
    assert out["bound_s"] > 0 and out["matmul_s"] > 0


def test_paper_scripts_refuse_cuda_without_a_card():
    from repro_torch.paper import table1

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        table1.run(8)


def test_paper_spearman_is_the_references(monkeypatch):
    import os
    import sys

    monkeypatch.setattr(sys, "path", [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))] + sys.path)
    from benchmarks.common import spearman as ref_spearman
    from repro_torch.paper.common import spearman

    rng = np.random.default_rng(1)
    for _ in range(5):
        a, b = rng.standard_normal(12), rng.standard_normal(12)
        assert spearman(a, b) == ref_spearman(a, b)
