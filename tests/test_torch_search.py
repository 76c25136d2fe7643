"""The port's variant search (``repro_torch.search``) against the reference's.

Every case builds the same specs through both packages and compares on
the CPU:

* ``space``: SJT orders (with the dedup count), block and chunk choices,
  candidates' canonical keys, ``candidate_schedule``, the mesh
  enumeration, the dtype axis and the sweep points, over the reference's
  spec families and both quant tiers;
* ``beam``: ``estimate`` on every order x block combination of small
  specs, and ``beam_search``'s survivors and stats;
* ``search_schedule(measure=False)``: the analytic ladder rung by rung
  (schedule, score, bound, ``fits_vmem``, source, explain terms) and its
  stats;
* ``reference_arrays`` and ``einsum_reference``; a measured CPU ladder
  (the plain version timed on the host) whose winner is never slower than
  the default, and whose stored ladder an analytic request cannot mask;
* the card's side that runs here: ``card_candidates`` yields only plans
  ``contract.cu`` accepts and always the launcher's own (a property test),
  ``card_plan_cost``'s score never below its bound, ``card_beam``'s cuts,
  ``h100_cost``, the tile geometry ``core.cost`` models against
  ``codegen.cuda_gen``'s, and the launcher's choice between a searched
  plan and its heuristic (``tests/test_torch_gpu.py`` runs them on the
  card);
* ``roofline.analysis``'s model helpers;
* ``tune_schedule(measure_with=)``, and the mesh refusals.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.enumerate as RE
import repro.roofline.analysis as r_roof
import repro.search as R
import repro.search.space as r_space
import repro.core.cost as r_cost
from repro.codegen.cache import schedule_to_dict as r_sched_dict

import repro_torch.core.enumerate as PE
import repro_torch.roofline.analysis as p_roof
import repro_torch.search as P
import repro_torch.search.space as p_space
from repro_torch.codegen import cuda_gen
from repro_torch.codegen.cache import schedule_to_dict as p_sched_dict
from repro_torch.core import cost as p_cost

#: (family, extents) small enough for the analytic beam to run in ms
FAMILIES = [
    ("matmul", (16, 8, 32)),
    ("matmul", (64, 32, 128)),
    ("matvec", (24, 16)),
    ("weighted_matmul", (8, 16, 8)),
    ("batched_matmul", (2, 8, 16, 8)),
    ("chain_matmul", (8, 8, 16, 8)),
    ("transposed_matmul", (16, 8, 32)),
    ("attention", (2, 16, 16, 8)),
    ("grouped_matmul", (2, 8, 16, 16)),
]
IDS = [f"{f}-{'x'.join(map(str, e))}" for f, e in FAMILIES]
TIERS = ("int8", "fp8")


def _pair(family, extents):
    return (R.spec_from_name(family, extents),
            P.spec_from_name(family, extents))


def _quant_pair(tier):
    return (RE.quantize_spec(RE.matmul_spec(32, 16, 64), fmt=tier),
            PE.quantize_spec(PE.matmul_spec(32, 16, 64), fmt=tier))


# ---------------------------------------------------------------------------
# space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,extents", FAMILIES, ids=IDS)
def test_space_matches_reference(family, extents):
    r, p = _pair(family, extents)
    assert p_space.candidate_orders_counted(p) == \
        r_space.candidate_orders_counted(r)
    assert p_space.candidate_orders(p, limit=3) == \
        r_space.candidate_orders(r, limit=3)
    assert p_space.block_choices(p, p_cost.TPU) == \
        r_space.block_choices(r, r_cost.TPU)
    for e in (1, 3, 8, 96, 512, 1024, 1536):
        assert p_space.map_block_choices(e, p_cost.TPU) == \
            r_space.map_block_choices(e, r_cost.TPU)
        assert p_space.seq_chunk_choices(e, p_cost.TPU) == \
            r_space.seq_chunk_choices(e, r_cost.TPU)
    choices = p_space.block_choices(p, p_cost.TPU)
    for order in p_space.candidate_orders(p, limit=4):
        for combo in itertools.islice(
                itertools.product(*(choices[i] for i in p.indices)), 6):
            blocks = dict(zip(p.indices, combo))
            pc = p_space.make_candidate(p, order, blocks)
            rc = r_space.make_candidate(r, order, blocks)
            assert pc.canonical_key() == rc.canonical_key()
            assert pc.grid_order() == rc.grid_order()
            assert pc.seq_order() == rc.seq_order()
            assert p_sched_dict(pc.to_schedule()) == \
                r_sched_dict(rc.to_schedule())
    labels = lambda pts: [(lab, s.name) for lab, s in pts]  # noqa: E731
    assert labels(p_space.sweep_specs(p, with_grads=False)) == \
        labels(r_space.sweep_specs(r, with_grads=False))
    assert labels(p_space.sweep_specs(p, with_grads=True)) == \
        labels(r_space.sweep_specs(r, with_grads=True))


@pytest.mark.parametrize("family,extents", FAMILIES[:7], ids=IDS[:7])
def test_dtype_tiers_match_reference(family, extents):
    r, p = _pair(family, extents)
    rt = r_space.dtype_tier_specs(r, dtype=np.float32)
    pt = p_space.dtype_tier_specs(p, dtype=torch.float32)
    assert [(t, s.name, str(d)) for t, s, d in rt] == \
        [(t, s.name, str(d).replace("torch.", "")) for t, s, d in pt]
    for (_, rs, _), (_, ps, _) in zip(rt, pt):
        assert (rs.quant is None) == (ps.quant is None)
        if ps.quant is not None:
            assert (ps.quant.dtype, ps.quant.accum) == \
                (rs.quant.dtype, rs.quant.accum)


@pytest.mark.parametrize("shape", [(2,), (1, 1), (2, 4), (2, 2, 2), (8, 1)])
def test_mesh_enumeration_matches_reference(shape):
    text = "x".join(map(str, shape))
    assert p_space.parse_mesh_shape(text) == r_space.parse_mesh_shape(text)
    assert p_space.mesh_descriptor(shape) == r_space.mesh_descriptor(shape)
    for family, extents in FAMILIES[:3]:
        r, p = _pair(family, extents)
        pv = p_space.mesh_variants(p, shape)
        rv = r_space.mesh_variants(r, shape)
        assert [(v.assignment, v.collective, v.shards) for v in pv] == \
            [(v.assignment, v.collective, v.shards) for v in rv]
        for v in pv:
            assert p_space.local_extents(p, v.as_dict()) == \
                r_space.local_extents(r, v.as_dict())
    with pytest.raises(ValueError):
        p_space.parse_mesh_shape("2xq")


# ---------------------------------------------------------------------------
# beam
# ---------------------------------------------------------------------------


ESTIMATE_CASES = [(f, e, None) for f, e in FAMILIES] + [
    ("matmul", (32, 16, 64), tier) for tier in TIERS]


@pytest.mark.parametrize(
    "family,extents,tier", ESTIMATE_CASES,
    ids=IDS + [f"matmul-{t}" for t in TIERS])
def test_estimate_matches_reference(family, extents, tier):
    r, p = _quant_pair(tier) if tier else _pair(family, extents)
    choices = p_space.block_choices(p, p_cost.TPU)
    for order in p_space.candidate_orders(p, limit=3):
        for combo in itertools.islice(
                itertools.product(*(choices[i] for i in p.indices)), 12):
            blocks = dict(zip(p.indices, combo))
            for assigned in (None, frozenset(p.indices[:1])):
                pe = P.estimate(p, order, blocks, elem_bytes=2,
                                assigned=assigned)
                re_ = R.estimate(r, order, blocks, elem_bytes=2,
                                 assigned=assigned)
                assert pe == P.CostEstimate(**re_.__dict__)
                assert pe.score >= pe.lower_bound - 1e-18


@pytest.mark.parametrize("family,extents", FAMILIES, ids=IDS)
def test_beam_search_matches_reference(family, extents):
    r, p = _pair(family, extents)
    ps, pst = P.beam_search(p, beam_width=4, topk=4)
    rs, rst = R.beam_search(r, beam_width=4, topk=4)
    assert [(c.candidate.canonical_key(), c.cost.score) for c in ps] == \
        [(c.candidate.canonical_key(), c.cost.score) for c in rs]
    assert pst.as_dict() == rst.as_dict()
    assert pst.bound_log == rst.bound_log
    for key, bound, best in pst.bound_log:
        assert bound >= best, key


# ---------------------------------------------------------------------------
# the analytic ladder
# ---------------------------------------------------------------------------


def _rung(p):
    return (p.score, p.lower_bound, p.fits_vmem, p.measured_s, p.source,
            p.collective, p.explain)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("family,extents", FAMILIES, ids=IDS)
def test_analytic_ladder_matches_reference(family, extents, dtype):
    r, p = _pair(family, extents)
    kw = dict(beam_width=4, topk=3, measure=False)
    rres = R.search_schedule(r, dtype=np.dtype(dtype), **kw)
    pres = P.search_schedule(p, dtype=getattr(torch, dtype), **kw)
    assert len(pres.ranked) == len(rres.ranked)
    for a, b in zip(pres.ranked, rres.ranked):
        assert p_sched_dict(a.schedule) == r_sched_dict(b.schedule)
        assert _rung(a) == _rung(b)
        assert a.card is None
    assert pres.stats.as_dict() == rres.stats.as_dict()
    assert pres.dtype == rres.dtype
    assert pres.baseline() is not None


@pytest.mark.parametrize("tier", TIERS)
def test_dtype_ladder_matches_reference(tier):
    r, p = _pair("matmul", (32, 16, 64))
    kw = dict(beam_width=4, topk=2, measure=False, tiers=(tier,))
    rl = R.search_dtype_ladder(r, dtype=np.float32, **kw)
    pl = P.search_dtype_ladder(p, dtype=torch.float32, **kw)
    assert sorted(pl) == sorted(rl) == sorted(("baseline", tier))
    for t in pl:
        assert [_rung(x) for x in pl[t].ranked] == \
            [_rung(x) for x in rl[t].ranked]
    assert P.best_dtype_tier(pl) == R.best_dtype_tier(rl)
    with pytest.raises(ValueError):
        P.best_dtype_tier({})


def test_spec_families_and_all_match_reference():
    assert sorted(P.SPEC_FAMILIES) == sorted(R.SPEC_FAMILIES)
    for name, (_, arity) in P.SPEC_FAMILIES.items():
        assert R.SPEC_FAMILIES[name][1] == arity
    assert set(R.__all__) <= set(P.__all__)
    with pytest.raises(ValueError, match="unknown spec"):
        P.spec_from_name("conv", (1, 2))
    with pytest.raises(ValueError, match="takes 3"):
        P.spec_from_name("matmul", (1, 2))


# ---------------------------------------------------------------------------
# measurement on the CPU
# ---------------------------------------------------------------------------


ARRAY_CASES = [(f, e, dt) for f, e in FAMILIES
               for dt in ("float32", "bfloat16")] + [
    (f, e, dt) for f, e in FAMILIES[:7] for dt in ("int8", "float8_e4m3fn")]


@pytest.mark.parametrize("family,extents,dtype", ARRAY_CASES,
                         ids=[f"{f}-{'x'.join(map(str, e))}-{d}"
                              for f, e, d in ARRAY_CASES])
def test_reference_arrays_and_oracle_match(family, extents, dtype):
    r, p = _pair(family, extents)
    ra = R.reference_arrays(r, dtype=np.dtype(dtype), seed=3)
    pa = P.reference_arrays(p, dtype=dtype, seed=3)
    assert list(pa) == list(ra)
    for n in ra:
        np.testing.assert_array_equal(np.asarray(pa[n], np.float64),
                                      np.asarray(ra[n], np.float64))
    np.testing.assert_array_equal(P.einsum_reference(p, pa),
                                  R.einsum_reference(r, ra))


def test_measured_cpu_ladder_never_slower_than_default(tmp_path):
    spec = PE.matmul_spec(64, 64, 64)
    db = P.PlanDB(str(tmp_path / "plans.json"))
    res = P.search_schedule(spec, beam_width=4, topk=2, measure=True,
                            arrays=P.reference_arrays(spec, seed=3),
                            plan_db=db)
    base = res.baseline()
    assert base is not None and base.measured_s is not None
    assert res.best.measured_s <= base.measured_s
    assert res.stats.measured == len(res.ranked)
    assert all(p.max_err is not None and p.max_err < 1e-3 and p.card is None
               for p in res.ranked)


def test_unmeasured_ladder_does_not_satisfy_measured_request(tmp_path):
    spec = PE.matmul_spec(64, 64, 64)
    db = P.PlanDB(str(tmp_path / "plans.json"))
    res = P.search_schedule(spec, beam_width=4, topk=2, measure=False,
                            plan_db=db)
    assert res.best.measured_s is None
    res2 = P.search_schedule(spec, beam_width=4, topk=2, measure=True,
                             plan_db=db)
    assert res2.best.measured_s is not None
    res3 = P.search_schedule(spec, beam_width=4, topk=2, measure=False,
                             plan_db=db)
    assert res3.best.measured_s is not None
    assert db.lookup_hits >= 1


def test_wrong_candidate_raises_and_is_never_ranked(monkeypatch):
    spec = PE.matmul_spec(32, 16, 32)
    sched = P.candidate_schedule(spec, spec.indices, {})
    arrays = P.reference_arrays(spec, seed=1)
    from repro_torch.codegen import cuda_gen as cg

    real = cg.contract_ref
    monkeypatch.setattr(cg, "contract_ref",
                        lambda *a, **k: real(*a, **k) * 1.01)
    with pytest.raises(AssertionError, match="refusing to rank"):
        P.measure_schedules(spec, [sched], arrays=arrays)


def test_search_with_grads_and_gemm_plans_cpu(tmp_path):
    db = P.PlanDB(str(tmp_path / "plans.json"))
    out = P.search_schedule_with_grads(PE.matmul_spec(16, 8, 32),
                                       beam_width=4, topk=2, measure=False,
                                       plan_db=db)
    assert sorted(out) == ["dA", "dB", "fwd"]
    assert out["dA"].spec.name == "matmul.dA"
    n = P.search_gemm_plans([(16, 8, 32), (8, 8, 8)], measure=False,
                            plan_db=db, with_grads=True)
    assert n == 6


# ---------------------------------------------------------------------------
# the card's plans, as far as they run here
# ---------------------------------------------------------------------------


def _meta(batch, m, k, n, dtype=torch.bfloat16, a_t=False, b_t=False):
    """Folded operands on the meta device; ``a_t`` / ``b_t`` give the
    transposed (m- / n-major ... k-major) layouts the backward passes."""
    a = torch.empty(batch, m, k, dtype=dtype, device="meta")
    b = torch.empty(batch, k, n, dtype=dtype, device="meta")
    if a_t:
        a = torch.empty(batch, k, m, dtype=dtype,
                        device="meta").transpose(1, 2)
    if b_t:
        b = torch.empty(batch, n, k, dtype=dtype,
                        device="meta").transpose(1, 2)
    return a, b


def _legal(plan, batch, m, n, k, kscale=False, row_reduce=False,
           narrow_x=False):
    """``contract.cu``'s checks for ``plan``, written out again
    (``narrow_x``: a plain product whose x is k-contiguous, which alone
    takes a tc32 x tile narrower than 128)."""
    body, tile_n, splits = plan
    bk = cuda_gen.TC32_BK if body == "tc32" else cuda_gen.RING_BK
    nk = -(-k // bk)
    per = -(-nk // splits)
    ok = 1 <= splits <= nk and (splits - 1) * per < nk and (
        batch * splits <= 65535)
    if body == "ring":
        # the row reduce takes a K split: each split's column sums are a
        # row block of their own (contract.cu's ring_row_reduce)
        ok &= tile_n in (128, 256) and m >= 64
        ok &= not (kscale or row_reduce) or tile_n == 128
    elif body == "narrow":
        ok &= tile_n in cuda_gen.NARROW_WIDTHS and m <= tile_n
    elif body == "tc32":
        ok &= tile_n in cuda_gen.TC32_WIDTHS and (
            tile_n == cuda_gen.TC32_TILE or narrow_x)
    return ok


def _mode_spec(mode, batch, m, k, n):
    """A spec of ``mode``'s fold at these extents: the plain product, the
    weighted forward (g on the reduced index: the k-scale), its ``.dA``
    (g on n: the multiplier), its ``.dg`` (the row reduce, over (m, n) =
    (i, j) with k reduced)."""
    from repro_torch.grad import derived_specs

    if mode == "plain":
        return (PE.matmul_spec(m, k, n) if batch == 1
                else PE.batched_matmul_spec(batch, m, k, n))
    if mode == "kscale":
        return PE.weighted_matmul_spec(m, k, n)
    if mode == "mul":
        return derived_specs(PE.weighted_matmul_spec(m, n, k))["A"]
    return derived_specs(PE.weighted_matmul_spec(m, n, k))["g"]


@settings(max_examples=60, deadline=None)
@given(batch=st.sampled_from((1, 2, 3)),
       m=st.integers(1, 700), n=st.integers(1, 5000),
       k=st.integers(1, 13000),
       dtype=st.sampled_from((torch.bfloat16, torch.float32)),
       a_t=st.booleans(), b_t=st.booleans(),
       mode=st.sampled_from(("plain", "kscale", "mul", "row_reduce")))
def test_card_candidates_are_legal_and_hold_the_heuristic(
        batch, m, n, k, dtype, a_t, b_t, mode):
    kscale, row_reduce = mode == "kscale", mode == "row_reduce"
    if mode != "plain":
        batch = 1
    a, b = _meta(batch, m, k, n, dtype, a_t, b_t)
    plans = P.card_candidates(_mode_spec(mode, batch, m, k, n), a, b)
    vec = (cuda_gen.VecArg(torch.empty(k, device="meta"), 3)
           if kscale else None)
    body = cuda_gen.contract_body(a, b, plain=mode == "plain", kscale=vec,
                                  row_reduce=row_reduce)
    heur = cuda_gen.heuristic_plan(body, batch, m, n, k, kscale=kscale,
                                   row_reduce=row_reduce)
    if body in ("mma", "fma"):
        assert plans == [] and heur is None
        return
    assert heur in plans
    assert len(set(plans)) == len(plans)
    for plan in plans:
        assert plan.body == body
        assert _legal(plan, batch, m, n, k, kscale, row_reduce,
                      mode == "plain" and cuda_gen.tma_operand(a, 2, 4)), plan
    # every plan is a distinct launch: its grid differs
    grids = {(p.tile_n, p.splits) for p in plans}
    assert len(grids) == len(plans)


def test_card_candidates_dtype_override_and_bodies():
    mm = PE.matmul_spec(512, 4096, 4096)
    a, b = _meta(1, 512, 4096, 4096)
    ring = P.card_candidates(mm, a, b)
    assert {p.body for p in ring} == {"ring"}
    assert {p.tile_n for p in ring} == {128, 256}
    tc = P.card_candidates(mm, a, b, dtype="float32")
    assert {p.body for p in tc} == {"tc32"}
    weighted = P.card_candidates(PE.weighted_matmul_spec(512, 4096, 4096),
                                 a, b)
    assert {p.tile_n for p in weighted} == {128}
    a, b = _meta(1, 4, 4096, 4096)
    narrow = P.card_candidates(mm, a, b)
    assert {p.body for p in narrow} == {"narrow"}
    assert {p.tile_n for p in narrow} == set(cuda_gen.NARROW_WIDTHS)
    a, b = _meta(1, 40, 4096, 4096)
    assert {p.tile_n for p in P.card_candidates(mm, a, b)} == {64}
    # fused modes at M < 64 run mma.sync: no plan
    a, b = _meta(1, 4, 4096, 4096)
    assert P.card_candidates(PE.weighted_matmul_spec(4, 4096, 4096),
                             a, b) == []


def test_heuristic_plans_at_the_prefill_shapes():
    """``ring_tiles`` at a 512-token qwen3-8b prefill's four projection
    shapes, and the narrow body at decode's M = 4."""
    want = {(4096, 4096): (128, 1), (4096, 1024): (128, 4),
            (4096, 12288): (128, 1), (12288, 4096): (128, 1)}
    for (k, n), (tile_n, splits) in want.items():
        assert cuda_gen.heuristic_plan("ring", 1, 512, n, k) == \
            cuda_gen.CardPlan("ring", tile_n, splits)
        t = cuda_gen.narrow_tiles(4, n, k)
        assert cuda_gen.heuristic_plan("narrow", 1, 4, n, k) == \
            cuda_gen.CardPlan("narrow", t.tile_n, t.splits)
    assert cuda_gen.heuristic_plan("mma", 1, 4, 8, 8) is None
    assert cuda_gen.heuristic_plan("ring", 1, 512, 64, 64,
                                   row_reduce=True) == \
        cuda_gen.CardPlan("ring", cuda_gen.RING_FUSED_BN, 1)


@settings(max_examples=80, deadline=None)
@given(body=st.sampled_from(("ring", "narrow", "tc32")),
       batch=st.sampled_from((1, 4)), m=st.integers(1, 4096),
       n=st.integers(1, 20000), k=st.integers(1, 20000),
       wide=st.booleans(), splits=st.integers(1, 32))
def test_card_plan_cost_score_never_below_bound(body, batch, m, n, k, wide,
                                                splits):
    """On every plan the kernel takes: the ring's 128 / 256 in bf16, the
    narrow body's token widths holding M in bf16, tc32's 128 or (M < 64)
    its narrow x tile in f32."""
    if body == "ring":
        tile_n, dtype = (256 if wide else 128), "bfloat16"
    elif body == "narrow":
        m = min(m, 64)
        tile_n = next(w for w in cuda_gen.NARROW_WIDTHS if w >= m)
        tile_n, dtype = (64 if wide else tile_n), "bfloat16"
    else:
        tile_n = (cuda_gen.TC32_TILE if wide
                  else cuda_gen.tc32_width(m, narrow_x=True))
        dtype = "float32"
    plan = cuda_gen.CardPlan(body, tile_n, splits)
    c = p_cost.card_plan_cost(body, plan, batch, m, n, k, dtype)
    assert c.score >= c.lower_bound > 0
    assert c.waves >= 1
    elem = 4 if dtype == "float32" else 2
    peak = (p_cost.H100["peak_3xtf32"] if dtype == "float32"
            else p_cost.H100["peak_bf16"])
    roofline = max(2.0 * batch * m * n * k / peak,
                   batch * (m * k + k * n + m * n) * elem
                   / p_cost.H100["hbm_bw"])
    assert c.lower_bound >= roofline * (1 - 1e-12)


def test_card_beam_cuts_and_keeps_the_heuristic():
    a, b = _meta(1, 512, 4096, 1024)
    plans = P.card_candidates(PE.matmul_spec(512, 4096, 1024), a, b)
    heur = cuda_gen.heuristic_plan("ring", 1, 512, 1024, 4096)
    out, stats = P.card_beam(plans, 1, 512, 1024, 4096, beam_width=3,
                             topk=2, heuristic=heur)
    assert stats.considered == len(plans)
    assert stats.considered == (stats.pruned_bound + stats.pruned_beam
                                + min(3, len(plans) - stats.pruned_bound))
    assert any(p == heur for p, _ in out)
    assert len(out) <= 3
    best = min(c.score for _, c in out)
    for key, bound, best_at_cut in stats.bound_log:
        assert bound >= best_at_cut * 1.25 * (1 - 1e-12)
    scores = [c.score for p, c in out if p != heur]
    assert scores == sorted(scores) and best == min(scores + [best])
    # a plan costs its own grid: the heuristic's 4 splits beat 1 at N = 1024
    cost = lambda splits: p_cost.card_plan_cost(  # noqa: E731
        "ring", cuda_gen.CardPlan("ring", 128, splits), 1, 512, 1024, 4096)
    assert cost(4).score < cost(1).score
    assert P.card_beam([], 1, 1, 1, 1)[0] == []


@pytest.mark.parametrize("gap_us, spread_us, winner", [
    (0.3, 1.3, "default"),   # inside the scatter: a tie keeps the heuristic
    (1.3, 1.3, "default"),   # exactly the spread: still a tie
    (2.4, 0.5, "search"),    # beyond the scatter: the faster plan wins
    (2.4, None, "search"),   # host-timed rungs carry no spread: order kept
])
def test_measured_ladder_keeps_the_heuristic_on_a_tie(gap_us, spread_us,
                                                      winner):
    spread = None if spread_us is None else spread_us * 1e-6
    rung = lambda source, ms, tile: P.RankedPlan(  # noqa: E731
        schedule=None, score=1.0, lower_bound=0.0, fits_vmem=True,
        measured_s=ms * 1e-3, spread_s=spread, source=source,
        card=cuda_gen.CardPlan("ring", tile, 1))
    base = 0.0230
    plans = [rung("search", base - gap_us * 1e-3, 256),
             rung("search", base - gap_us * 1e-3 / 2, 64),
             rung("default", base, 128)]
    P._keep_heuristic_within_spread(plans)
    assert plans[0].source == winner
    assert sorted(p.card.tile_n for p in plans) == [64, 128, 256]
    if winner == "default":
        assert [p.card.tile_n for p in plans[1:]] == [256, 64]



@pytest.mark.parametrize("first, again_us, winner, retimed", [
    ("search", (22.0, 23.0, 0.4, 0.4), "search", True),    # wins again
    ("search", (23.1, 23.0, 0.4, 0.4), "default", True),   # loses again
    ("search", (22.8, 23.0, 0.4, 0.4), "default", True),   # a tie again
    ("default", None, "default", False),  # the heuristic already leads
    ("host", None, "search", False),      # host-timed: no spread, kept
])
def test_measured_ladder_confirms_a_winner_on_a_second_timing(
        first, again_us, winner, retimed):
    spread = None if first == "host" else 0.4e-6
    rung = lambda source, ms, tile: P.RankedPlan(  # noqa: E731
        schedule=None, score=1.0, lower_bound=0.0, fits_vmem=True,
        measured_s=ms * 1e-3, spread_s=spread, source=source,
        card=cuda_gen.CardPlan("ring", tile, 1))
    if first == "default":
        plans = [rung("default", 0.0200, 128), rung("search", 0.0210, 256)]
    else:
        plans = [rung("search", 0.0200, 256), rung("search", 0.0210, 64),
                 rung("default", 0.0230, 128)]
    calls = []

    def retime(best, base):
        calls.append((best.card.tile_n, base.card.tile_n))
        w, b, wsp, bsp = (x * 1e-6 for x in again_us)
        return (w, wsp), (b, bsp)

    P._keep_heuristic_within_spread(plans, retime)
    assert plans[0].source == winner
    assert calls == ([(256, 128)] if retimed else [])
    assert sorted(p.card.tile_n for p in plans) == sorted(
        {"default": [128, 256]}.get(first, [64, 128, 256]))
    if winner == "default" and first == "search":
        # the first timing's order of the rest is kept, and its numbers
        assert [p.card.tile_n for p in plans[1:]] == [256, 64]
        assert plans[1].measured_s == 0.0200e-3

def test_card_geometry_matches_the_kernel_constants():
    assert p_cost.CARD_BODIES["ring"] == (cuda_gen.RING_BM, cuda_gen.RING_BK,
                                          1)
    assert p_cost.CARD_BODIES["narrow"] == (cuda_gen.RING_BM,
                                            cuda_gen.RING_BK,
                                            cuda_gen.NARROW_PER_SM)
    assert p_cost.CARD_BODIES["tc32"] == (cuda_gen.TC32_TILE,
                                          cuda_gen.TC32_BK, 1)
    assert p_cost.H100["sms"] == cuda_gen.H100_SMS
    assert p_cost.TPU == r_cost.TPU


def test_h100_cost_counts_host_calls_and_the_roofline():
    spec = PE.matmul_spec(64, 64, 64)
    for order in P.candidate_orders(spec):
        calls = p_cost.einsum_calls(spec, order)
        assert calls == 64
        c = p_cost.h100_cost(spec, order)
        device = max(2 * 64**3 / 67e12, 3 * 64 * 64 * 8 / 3.35e12)
        assert c == pytest.approx(64 * p_cost.H100["host_call_s"] + device)
    sub = spec.subdivide("j", 16)
    order = ("jo", "i", "ji", "k")
    assert p_cost.einsum_calls(sub, order) == 4 * 64
    assert p_cost.einsum_calls(sub, order, vector_levels=4) == 1
    # usable as core.autotune.tune's cost_fn
    from repro_torch.core.autotune import tune

    ranked = tune(spec, {"j": [16]}, cost_fn=p_cost.h100_cost, keep=3)
    assert [tv.predicted_cost for tv in ranked] == sorted(
        tv.predicted_cost for tv in ranked)


def test_card_plan_dict_roundtrip():
    plan = cuda_gen.CardPlan("ring", 256, 3)
    d = plan.as_dict()
    assert d == {"body": "ring", "tile_n": 256, "splits": 3}
    assert json.loads(json.dumps(d)) == d
    assert cuda_gen.CardPlan.from_dict(d) == plan
    assert cuda_gen.CardPlan.from_dict(None) is None
    assert cuda_gen.card_of("mma", None) == cuda_gen.CardPlan("mma", 0, 1)
    assert cuda_gen._tiles_of(cuda_gen.CardPlan("narrow", 8, 4)) == \
        cuda_gen.NarrowPlan(8, cuda_gen.RING_BM, 4)
    with pytest.raises(ValueError, match="tc32"):
        cuda_gen._tiles_of(cuda_gen.CardPlan("tc32", 256, 1))


def test_card_views_are_the_launch_views():
    """The views the search measures are those ``_launch_cuda`` launches
    on: ``matmul.dB``'s product is taken the other way round (A = x^T,
    m-major, B = dout), with no copy."""
    from repro_torch.grad import derived_specs

    spec = PE.matmul_spec(64, 32, 48)
    x, w = torch.randn(64, 32), torch.randn(32, 48)
    a3, b3 = cuda_gen.card_views(spec, x, w)
    assert a3.shape == (1, 64, 32) and b3.shape == (1, 32, 48)
    assert a3.data_ptr() == x.data_ptr() and b3.data_ptr() == w.data_ptr()
    d = derived_specs(spec)
    g = torch.randn(64, 48)
    a3, b3 = cuda_gen.card_views(d["B"], g, x)
    assert a3.shape == (1, 32, 64) and a3.stride(2) != 1
    assert a3.data_ptr() == x.data_ptr()
    a3, b3 = cuda_gen.card_views(d["A"], g, w)
    assert a3.shape == (1, 64, 48) and b3.shape == (1, 48, 32)
    assert b3.stride(1) == 1  # w^T read k-major as it lies
    # a three-operand spec's views carry its vector; the chain has none
    a3, b3, vec = cuda_gen.card_views(PE.weighted_matmul_spec(4, 4, 4),
                                      torch.ones(4, 4), torch.ones(4, 4),
                                      torch.ones(4))
    assert a3.shape == b3.shape == (1, 4, 4) and vec.axis == 3
    with pytest.raises(ValueError):
        cuda_gen.card_views(PE.chain_matmul_spec(4, 4, 4, 4),
                            torch.ones(4, 4), torch.ones(4, 4),
                            torch.ones(4, 4))


def test_launcher_takes_the_plan_of_its_body():
    """``launch_plan``, the launcher's choice: a searched plan's tile and
    split where the call runs its body (``ops.card_plan.applied``), the
    heuristic's on another body (``.skipped``)."""
    shape = (1, 512, 1024, 4096)
    plan = cuda_gen.CardPlan("ring", 256, 2)
    assert cuda_gen.launch_plan("ring", plan, *shape) == (
        cuda_gen.RingPlan(256, 2), "applied")
    narrow = cuda_gen.CardPlan("narrow", 8, 4)
    assert cuda_gen.launch_plan("ring", narrow, *shape) == (
        cuda_gen.RingPlan(128, 4), "skipped")
    assert cuda_gen.launch_plan("ring", None, *shape) == (
        cuda_gen.RingPlan(128, 4), None)
    assert cuda_gen.launch_plan("narrow", narrow, 1, 4, 1024, 4096) == (
        cuda_gen.NarrowPlan(8, cuda_gen.RING_BM, 4), "applied")
    assert cuda_gen.launch_plan("mma", plan, 1, 4, 1024, 4096) == (
        None, "skipped")
    # the row reduce keeps its unsplit fused tile without a plan
    assert cuda_gen.launch_plan("ring", None, 1, 512, 64, 64,
                                row_reduce=True) == (
        cuda_gen.RingPlan(cuda_gen.RING_FUSED_BN, 1), None)
    assert cuda_gen.card_of("ring", cuda_gen.RingPlan(256, 2)) == plan


# ---------------------------------------------------------------------------
# roofline helpers, tuner, refusals
# ---------------------------------------------------------------------------


def test_roofline_helpers_match_reference():
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "COLLECTIVE_BYTE_FACTOR",
                 "QUANT_STORAGE_BYTES", "QUANT_ACCUM_BYTES"):
        assert getattr(p_roof, name) == getattr(r_roof, name), name
    for kind in r_roof.COLLECTIVE_BYTE_FACTOR:
        for shards in (1, 2, 8):
            assert p_roof.collective_seconds(kind, 1e6, shards) == \
                r_roof.collective_seconds(kind, 1e6, shards)
    for coll in ("psum", "ring"):
        for comp in (0.0, 1e-6, 1e-3):
            assert p_roof.sharded_reduce_seconds(
                4e6, 4, collective=coll, compute_s=comp) == \
                r_roof.sharded_reduce_seconds(
                    4e6, 4, collective=coll, compute_s=comp)
    assert p_roof.attention_rescale_seconds(4, 64, 8, 3) == \
        r_roof.attention_rescale_seconds(4, 64, 8, 3)
    for sizes, bm in (((0, 3, 16, 17), 8), ((), 4), ((5,), 0)):
        assert p_roof.grouped_tail_factor(sizes, bm) == \
            r_roof.grouped_tail_factor(sizes, bm)
    for tier in TIERS:
        r, p = _quant_pair(tier)
        assert p_roof.quant_byte_model(p.quant, 2) == \
            r_roof.quant_byte_model(r.quant, 2)
        assert p_roof.quant_hbm_bytes(p) == r_roof.quant_hbm_bytes(r)
    assert p_roof.quant_byte_model(None, 4) == (4, 4)


def test_tune_schedule_measure_with_on_cpu(tmp_path):
    from repro_torch.codegen import AutotuneCache, tune_schedule

    spec = PE.matmul_spec(64, 64, 128)
    cache = AutotuneCache(str(tmp_path / "c.json"))
    arrays = P.reference_arrays(spec, seed=2)
    a = tune_schedule(spec, cache=cache, measure_with=arrays)
    assert (cache.hits, cache.misses) == (0, 1)
    b = tune_schedule(spec, cache=cache, measure_with=arrays)
    assert (cache.hits, cache.misses) == (1, 1)
    assert p_sched_dict(a) == p_sched_dict(b)
    # an analytic request has its own key: the measured entry is not it,
    # and the measured entry says so
    tune_schedule(spec, cache=cache)
    assert cache.misses == 2
    stored = [v for v in json.load(open(cache.path)).values()
              if isinstance(v, dict) and "measured" in v]
    assert sorted(v["measured"] for v in stored) == [False, True]
    assert all("card" not in v for v in stored)


def test_mesh_and_capture_requests_raise(tmp_path):
    # the mesh tier (item 6c) searches, sweeps and measures where it used
    # to raise: a single process persists analytic mesh ladders
    spec = PE.matmul_spec(16, 16, 16)
    db = P.PlanDB(str(tmp_path / "plans.json"))
    res = P.search_schedule(spec, measure=False, mesh_shape="2x4",
                            plan_db=db)
    assert res.mesh == "2x4" and res.best_sharded() is not None
    assert P.search_gemm_plans([(16, 16, 16)], measure=False,
                               mesh_shape=(2, 2), plan_db=db) == 2
    # a trivial mesh is no mesh, as in the reference
    assert P.search_schedule(spec, measure=False, mesh_shape="1x1",
                             plan_db=db).mesh is None
    sched = P.candidate_schedule(spec, spec.indices, {"i": 8},
                                 mesh={"j": ("data", 2)})
    # no world of ranks hosts the mesh: measuring a sharded schedule raises
    with pytest.raises(ValueError, match="mesh of ranks"):
        P.measure_schedules(spec, [sched])
    from repro_torch.search import sweep

    # --from-model harvests since the capture slice
    # (tests/test_torch_capture_launch.py); --mesh sweeps since item 6c
    assert sweep.main(["--shapes", "8,8,8", "--mesh", "2x4", "--device",
                       "cpu", "--plan-db", str(tmp_path / "sweep.json"),
                       "--beam", "2", "--topk", "1"]) == 0


def test_sweep_cli_on_cpu_round_trips(tmp_path, capsys):
    from repro_torch.search import sweep

    db = str(tmp_path / "plans.json")
    rc, results = sweep.run(["--shapes", "16,8,32;8,8,8", "--with-grads",
                             "--device", "cpu", "--plan-db", db,
                             "--beam", "4", "--topk", "2",
                             "--dtype", "bfloat16"])
    assert rc == 0 and len(results) == 6
    out = capsys.readouterr().out
    assert out.count("round-tripped") == 6 and "sweep OK" in out
    assert all(r.best.measured_s is not None for *_, r in results)
    # the second sweep finds every ladder stored
    rc, again = sweep.run(["--shapes", "16,8,32;8,8,8", "--with-grads",
                           "--device", "cpu", "--plan-db", db,
                           "--beam", "4", "--topk", "2",
                           "--dtype", "bfloat16"])
    assert rc == 0
    assert [r.best.measured_s for *_, r in again] == \
        [r.best.measured_s for *_, r in results]
    assert math.isfinite(sum(r.best.measured_s for *_, r in again))
