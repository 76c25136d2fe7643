"""The fused kernels' card plans (``codegen.fused_gen.FusedPlan``) on the CPU.

B2, B3 and B4 take a searched plan on the card: B2's KV block and
persistent CTA count (the ring) or KV block (the 3xTF32 body), B3's M tile,
B4's tile width and CTA count.  What runs here:

* ``search.space.fused_card_candidates`` on meta tensors: every plan legal
  (the rules ``attention.cu``, ``grouped.cu`` and ``grouped_dw.cu`` check),
  the launcher's heuristic among them, no plan for the mma.sync and FMA
  bodies; the heuristics (``attention_plan``, ``grouped_plan``,
  ``grouped_dw_plan``) are the launches made before plans existed;
* the plan's dict round trip, ``plan_from_dict`` telling a fused plan
  from B1's, and plan DBs written before fused plans (the golden fixture,
  a B1 card rung) loading unchanged;
* ``group_table`` at each M tile;
* ``ops._tuned_kernel`` handing a fused rung's plan to ``FusedKernel``
  under memo keys that tell plans apart, and plain versions on CPU tensors
  whatever the plan;
* the search's side: the fused card ladder's rungs, the f64 oracle on the
  operands' device against ``einsum_reference``, ``measure``'s launch
  check, plan-explain's fused rows; and the CPU ladders of ``attention``
  and ``grouped_matmul`` still the reference's;
* ``chip_smoke._searched_card``, the B1 plan its unembedding rows expect
  where a ladder stored one.

``tests/test_torch_gpu.py`` holds every candidate plan against its plain
version on the card, and the kernels' refusals.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.search as R
from repro.codegen.cache import schedule_to_dict as r_sched_dict

import repro_torch.core.enumerate as PE
import repro_torch.search as P
from repro_torch import codegen, obs, ops
from repro_torch.codegen import cuda_gen, fused_gen
from repro_torch.codegen.cache import schedule_to_dict as p_sched_dict
from repro_torch.codegen.fused_gen import FusedPlan, plan_from_dict
from repro_torch.codegen.schedules import default_schedule
from repro_torch.grad import derived_specs
from repro_torch.obs.explain import format_entry
from repro_torch.search import measure, space
from repro_torch.search.plandb import entry_from

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "plan_db_golden.json")
SMS = cuda_gen.H100_SMS


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _operands(spec, dtype=torch.bfloat16):
    root = spec.root()
    return [_meta(*(root.extents[i] for i in axes), dtype=dtype)
            for axes in root.operands.values()]


def _legal(plan, spec, tensors):
    """The kernels' own rules for a plan (the C entries' checks)."""
    root = spec.root()
    if plan.kernel == "attention" and plan.body == "ring":
        q = tensors[0]
        tiles = fused_gen.attention_ring_tiles(q.shape[0], q.shape[1])
        return plan.block in (128, 64) and 1 <= plan.ctas <= tiles
    if plan.kernel == "attention":
        d, e = tensors[0].shape[2], tensors[2].shape[2]
        return (plan.ctas == 0 and plan.block in (32, 64)
                and fused_gen.tc32_block_fits(d, e, plan.block))
    if plan.kernel == "grouped":
        return plan.ctas == 0 and plan.block in (16, 32, 64, 128)
    assert plan.kernel == "grouped_dw"
    k1, k2 = root.extents["k"], root.extents["f"]
    tiles = fused_gen.dw_ring_tiles(len(root.group_sizes), k1, k2,
                                    plan.block)
    return plan.block in (256, 128) and 1 <= plan.ctas <= tiles


def _dw_spec(sizes, k1, k2):
    return derived_specs(PE.grouped_matmul_spec(sizes, k1, k2))["W"]


def _dx_spec(sizes, k, f):
    return derived_specs(PE.grouped_matmul_spec(sizes, k, f))["X"]


# ---------------------------------------------------------------------------
# candidates and heuristics
# ---------------------------------------------------------------------------


ATTN_CASES = [
    # (h, s, t, d, e, dtype, body, plans)
    (128, 512, 512, 128, 128, torch.bfloat16, "ring", 6),   # attn-path (a)
    (32, 4096, 4096, 128, 128, torch.bfloat16, "ring", 6),  # (e)
    (1, 100, 77, 64, 64, torch.bfloat16, "ring", 2),        # one tile
    (2, 64, 64, 4, 4, torch.bfloat16, "mma", 0),            # d % 8
    (2, 64, 64, 192, 192, torch.bfloat16, "mma", 0),        # past 128
    (2, 64, 64, 128, 128, torch.float32, "tc32", 1),        # 64 won't fit
    (2, 64, 64, 64, 128, torch.float32, "tc32", 2),
    (2, 64, 64, 196, 196, torch.float32, "fma", 0),
]


@pytest.mark.parametrize("h,s,t,d,e,dtype,body,n", ATTN_CASES)
def test_attention_candidates_legal_with_the_heuristic(h, s, t, d, e, dtype,
                                                       body, n):
    spec = PE.attention_spec(h, s, t, d, e=e, causal=True)
    q, k, v = _meta(h, s, d, dtype=dtype), _meta(h, t, d, dtype=dtype), \
        _meta(h, t, e, dtype=dtype)
    assert fused_gen.attention_body(q, k, v) == body
    plans = space.fused_card_candidates(spec, q, k, v)
    assert len(plans) == n == len(set(plans))
    heur = fused_gen.attention_plan(q, k, v, SMS)
    if n == 0:
        assert heur is None
        return
    assert heur in plans and all(_legal(p, spec, (q, k, v)) for p in plans)
    # the launch made before plans existed: RG_BN / TC_BC, one CTA an SM
    tiles = h * -(-s // 128)
    assert heur == (FusedPlan("attention", "ring", 128, min(tiles, SMS))
                    if body == "ring" else
                    FusedPlan("attention", "tc32", 32, 0))
    assert space.fused_heuristic_plan(spec, q, k, v, sms=SMS) == heur


GROUPED_CASES = [
    # (sizes, k, f): the MoE training and serving shapes, ragged
    ((320,) * 32, 7168, 2048),
    ((16,) * 384, 7168, 2048),
    ((0, 1, 17, 0, 100, 3, 0, 45, 1, 16), 128, 136),
    ((1000,), 64, 64),
]


@pytest.mark.parametrize("mode", ["fwd", "dX", "dW"])
@pytest.mark.parametrize("sizes,k,f", GROUPED_CASES,
                         ids=lambda v: str(v)[:20])
def test_grouped_candidates_legal_with_the_heuristic(sizes, k, f, mode):
    spec = {"fwd": PE.grouped_matmul_spec(sizes, k, f),
            "dX": _dx_spec(sizes, k, f), "dW": _dw_spec(sizes, k, f)}[mode]
    tensors = _operands(spec)
    plans = space.fused_card_candidates(spec, *tensors)
    heur = space.fused_heuristic_plan(spec, *tensors, sms=SMS)
    assert heur in plans and len(set(plans)) == len(plans)
    assert all(_legal(p, spec, tensors) for p in plans)
    if mode == "dW":
        assert {p.block for p in plans} == {256, 128}
        tiles = fused_gen.dw_ring_tiles(len(sizes), k, f, 256)
        assert heur == FusedPlan("grouped_dw", "ring", 256, min(tiles, SMS))
        assert all(p.ctas in space.fused_cta_choices(
            fused_gen.dw_ring_tiles(len(sizes), k, f, p.block), SMS)
            for p in plans)
    else:
        assert [p.block for p in plans] == list(fused_gen.GROUPED_TILES)
        assert heur == FusedPlan("grouped", "ring",
                                 fused_gen.grouped_tile_m(sizes), 0)


def test_bodies_without_a_plan_have_no_candidates():
    """f32 operands (the FMA bodies), element-wise B3 and B4 operands
    (mma.sync): no plan, and the heuristic is None."""
    sizes = (4, 0, 9)
    for spec, dtype in ((PE.grouped_matmul_spec(sizes, 64, 64),
                         torch.float32),
                        (PE.grouped_matmul_spec(sizes, 77, 64),
                         torch.bfloat16),
                        (_dx_spec(sizes, 64, 45), torch.bfloat16),
                        (_dw_spec(sizes, 64, 64), torch.float32),
                        (_dw_spec(sizes, 77, 64), torch.bfloat16)):
        tensors = _operands(spec, dtype)
        assert space.fused_card_candidates(spec, *tensors) == []
        assert space.fused_heuristic_plan(spec, *tensors) is None
    x = torch.empty_strided((13, 64), (68, 1), dtype=torch.bfloat16,
                            device="meta")  # a row stride of 68
    assert fused_gen.grouped_body(x, _meta(3, 64, 64)) == "mma"
    assert fused_gen.grouped_body(_meta(13, 64), _meta(3, 64, 64)) == "ring"
    with pytest.raises(ValueError, match="not a fused spec"):
        space.fused_card_candidates(PE.matmul_spec(8, 8, 8), _meta(8, 8),
                                    _meta(8, 8))


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 40), s=st.integers(1, 3000),
       d=st.sampled_from([8, 64, 72, 128]),
       e=st.sampled_from([8, 64, 128]),
       f32=st.booleans(), sms=st.sampled_from([132, 114, 8]))
def test_attention_candidates_property(h, s, d, e, f32, sms):
    """Any shape and card size: the candidates are legal, distinct, hold
    the heuristic, and the ring's CTA counts are ``fused_cta_choices``."""
    dtype = torch.float32 if f32 else torch.bfloat16
    q, k, v = _meta(h, s, d, dtype=dtype), _meta(h, s, d, dtype=dtype), \
        _meta(h, s, e, dtype=dtype)
    spec = PE.attention_spec(h, s, s, d, e=e)
    plans = space.fused_card_candidates(spec, q, k, v, sms=sms)
    heur = fused_gen.attention_plan(q, k, v, sms)
    assert (heur is None) == (plans == [])
    if heur is not None:
        assert heur in plans and len(set(plans)) == len(plans)
        assert all(_legal(p, spec, (q, k, v)) for p in plans)
        if heur.body == "ring":
            tiles = fused_gen.attention_ring_tiles(h, s)
            assert {p.ctas for p in plans} == set(
                space.fused_cta_choices(tiles, sms))
            assert heur.ctas == min(tiles, sms)


def test_tc32_block_fits_is_the_kernels_layout():
    """The 3xTF32 body's 64-column KV block fits all but d = e = 128
    (attention.cu's TcLayout<DP, EP, BC>::FITS)."""
    fits = {(d, e): fused_gen.tc32_block_fits(d, e, 64)
            for d in (64, 128) for e in (64, 128)}
    assert fits == {(64, 64): True, (64, 128): True, (128, 64): True,
                    (128, 128): False}
    assert all(fused_gen.tc32_block_fits(d, e, 32)
               for d in (1, 64, 128) for e in (1, 64, 128))


# ---------------------------------------------------------------------------
# the plan's record, the plan DB
# ---------------------------------------------------------------------------


def test_fused_plan_dict_roundtrip_and_dispatch():
    plan = FusedPlan("grouped_dw", "ring", 128, 99)
    d = plan.as_dict()
    assert d == {"kernel": "grouped_dw", "body": "ring", "block": 128,
                 "ctas": 99}
    assert json.loads(json.dumps(d)) == d
    assert FusedPlan.from_dict(d) == plan and plan_from_dict(d) == plan
    b1 = cuda_gen.CardPlan("ring", 256, 3)
    assert plan_from_dict(b1.as_dict()) == b1
    assert isinstance(plan_from_dict(b1.as_dict()), cuda_gen.CardPlan)
    assert plan_from_dict(None) is None and FusedPlan.from_dict({}) is None


def test_plan_dbs_written_before_fused_plans_load_unchanged(tmp_path):
    """The golden fixture (no card fields) and a B1 card ladder as earlier
    sweeps wrote it load as they were: ladders of the same schedules, B1's
    ``CardPlan`` on its rung, no plan on the others."""
    with open(FIXTURE) as f:
        fixture = json.load(f)
    path = tmp_path / "plans.json"
    spec = PE.matmul_spec(128, 128, 256)
    old = {"schedule": p_sched_dict(default_schedule(spec)), "score": 1.0,
           "lower_bound": 0.5, "fits_vmem": True, "measured_s": 1e-4,
           "source": "search", "collective": "", "explain": {},
           "card": {"body": "ring", "tile_n": 256, "splits": 2}}
    db = P.PlanDB(str(path))
    db.put(spec, torch.float32, [old], hardware="cuda/any")
    data = json.loads(path.read_text())
    data.update(fixture)
    path.write_text(json.dumps(data))
    db = P.PlanDB(str(path))
    cached = db.get(spec, torch.float32, "cuda/any")
    ladder = P._ladder_from(cached, spec)
    assert ladder[0].card == cuda_gen.CardPlan("ring", 256, 2)
    for key, entry in fixture.items():
        if not isinstance(entry, dict) or not entry.get("spec"):
            continue
        assert all(plan_from_dict(r.get("card")) is None
                   for r in entry["ranked"])
    assert json.loads(path.read_text())  # written back nothing else


def _fused_ladder(db, spec, dtype, plan, heur):
    return db.put(spec, dtype, [
        entry_from(default_schedule(spec), score=float("inf"),
                   lower_bound=0.0, fits_vmem=True, measured_s=1e-4,
                   card=plan.as_dict()),
        entry_from(default_schedule(spec), score=float("inf"),
                   lower_bound=0.0, fits_vmem=True, measured_s=2e-4,
                   source="default", card=heur.as_dict()),
    ])


def test_fused_rung_reaches_the_fused_kernel(tmp_path, monkeypatch):
    """``ops._tuned_kernel`` hands a fused ladder's winner to
    ``FusedKernel`` (``compile_fused(card=)``), under memo keys that tell
    plans apart; a B1 plan never reaches a fused spec nor a fused plan a
    B1 spec; on CPU tensors the plan changes nothing."""
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    db = P.default_plan_db()
    spec = PE.attention_spec(4, 64, 64, 16, causal=True)
    plan = FusedPlan("attention", "ring", 64, 2)
    heur = FusedPlan("attention", "ring", 128, 2)
    _fused_ladder(db, spec, torch.bfloat16, plan, heur)
    # the stored ladder answers a search, its rungs' plans with it
    res = P.search_schedule(spec, dtype=torch.bfloat16, plan_db=db,
                            device="cpu")
    assert [p.card for p in res.ranked] == [plan, heur]
    kern = ops._tuned_kernel(spec, torch.bfloat16, interpret=True)
    assert isinstance(kern, fused_gen.FusedKernel) and kern.card == plan
    sched = kern.schedule
    a = cuda_gen.cached_compile(spec, sched, card=plan)
    b = cuda_gen.cached_compile(spec, sched, card=heur)
    c = cuda_gen.cached_compile(spec, sched)
    assert a is not b and a is not c and b is not c
    assert (a.card, b.card, c.card) == (plan, heur, None)
    assert cuda_gen.cached_compile(spec, sched, card=plan) is a
    # a rewritten ladder replaces the process memo's kernel
    _fused_ladder(db, spec, torch.bfloat16, heur, plan)
    assert ops._tuned_kernel(spec, torch.bfloat16, interpret=True).card \
        == heur
    # the plain versions on CPU tensors, whatever the plan
    g = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(g.standard_normal((4, 64, 16))).float()
               for _ in range(3))
    want = fused_gen.attention_ref(q, k, v, causal=True, kv_lengths=None,
                                   out_dtype=torch.float32)
    torch.testing.assert_close(a(q, k, v), want, rtol=0, atol=0)
    torch.testing.assert_close(ops.attention(q, k, v, causal=True,
                                             interpret=True), want,
                               rtol=1e-5, atol=1e-5)
    # plans of the other family are dropped, or refused outright
    mm = PE.matmul_spec(64, 64, 64)
    _fused_ladder(db, mm, torch.float32, plan, heur)
    assert ops._tuned_kernel(mm, torch.float32, interpret=True).card is None
    with pytest.raises(ValueError, match="FusedPlan"):
        fused_gen.compile_fused(spec, sched,
                                card=cuda_gen.CardPlan("ring", 128, 1)._replace(
                                    body="x"))


def test_fused_grouped_rungs_reach_the_kernels_and_tables(tmp_path,
                                                          monkeypatch):
    """The grouped forward's and dW's plans through ``ops``: the kernel
    carries the plan; a B3 plan's table is cut at its M tile where the
    launch takes it (``_table``), the default table otherwise."""
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    db = P.default_plan_db()
    sizes = (40, 0, 70)
    fwd = PE.grouped_matmul_spec(sizes, 32, 32)
    plan = FusedPlan("grouped", "ring", 16, 0)
    _fused_ladder(db, fwd, torch.bfloat16, plan,
                  FusedPlan("grouped", "ring", 128, 0))
    kern = ops._tuned_kernel(fwd, torch.bfloat16, interpret=True)
    assert kern.card == plan
    table, max_rows, band = kern._table(torch.device("cpu"), 16)
    assert max_rows == 16 and band == 5
    assert [tuple(r) for r in table.tolist()] == fused_gen.group_table(
        sizes, 16)
    assert kern._table(torch.device("cpu"))[1:] == (64, 2)
    dw = _dw_spec(sizes, 32, 32)
    dplan = FusedPlan("grouped_dw", "ring", 128, 3)
    _fused_ladder(db, dw, torch.bfloat16, dplan,
                  FusedPlan("grouped_dw", "ring", 256, 3))
    assert ops._tuned_kernel(dw, torch.bfloat16, interpret=True).card == dplan
    # the plain version on CPU tensors, whatever the plan
    x = torch.randn(110, 32)
    w = torch.randn(3, 32, 32)
    torch.testing.assert_close(
        kern(x, w), fused_gen.grouped_ref(x, w, sizes,
                                          out_dtype=torch.float32))


@pytest.mark.parametrize("tile", fused_gen.GROUPED_TILES)
@pytest.mark.parametrize("sizes", [
    (320,) * 4, (16,) * 9, (0, 1, 17, 0, 100, 3, 0, 45, 1, 16),
    (1000,), (0, 0, 5), (129, 0, 0, 257)], ids=lambda v: str(v)[:20])
def test_group_table_at_each_tile(sizes, tile):
    """At every M tile: the blocks cover every row once, in order, none
    spans two groups, none holds more than the tile, empty groups have
    none."""
    table = fused_gen.group_table(sizes, tile)
    offs = fused_gen._group_offsets(sizes)
    seen = []
    for gid, first, rows in table:
        assert 1 <= rows <= tile
        assert offs[gid] <= first and first + rows <= offs[gid] + sizes[gid]
        seen.extend(range(first, first + rows))
    assert seen == list(range(sum(sizes)))
    assert len(table) == sum(-(-s // tile) for s in sizes)
    assert fused_gen.group_table(sizes) == fused_gen.group_table(
        sizes, fused_gen.grouped_tile_m(sizes))


# ---------------------------------------------------------------------------
# the search's side
# ---------------------------------------------------------------------------


def test_fused_card_ladder_rungs():
    """``_card_ladder`` of a fused spec: the analytic winner's schedule on
    every rung, one rung a candidate plan, the heuristic's the default;
    a body with no plan gives the one default rung."""
    spec = PE.attention_spec(8, 256, 256, 64, causal=True)
    arrays = P.reference_arrays(spec, dtype="bfloat16")
    survivors, _ = P.beam_search(spec, beam_width=4, topk=2,
                                 elem_bytes=2)
    plans, stats, tensors = P._card_ladder(spec, survivors, arrays,
                                           torch.bfloat16, 4, 2, "cpu")
    ops_ = [tensors[n] for n in spec.operands]
    want = space.fused_card_candidates(spec, *ops_)
    assert [p.card for p in plans] == want and stats.considered == len(want)
    assert [p.source for p in plans].count("default") == 1
    assert next(p for p in plans if p.source == "default").card == \
        fused_gen.attention_plan(*ops_, SMS)
    sched = survivors[0].candidate.to_schedule()
    assert all(p_sched_dict(p.schedule) == p_sched_dict(sched)
               for p in plans)
    f32 = P._card_ladder(spec, survivors, P.reference_arrays(spec),
                         torch.float32, 4, 2, "cpu")[0]
    assert [p.card.block for p in f32] == [32, 64]
    mma = PE.attention_spec(2, 16, 16, 4)
    one = P._card_ladder(mma, [], None, torch.bfloat16, 4, 2, "cpu")[0]
    assert len(one) == 1 and one[0].card is None
    assert one[0].source == "default"


FUSED_SPECS = [
    PE.attention_spec(3, 20, 33, 8, e=12, causal=True),
    PE.attention_spec(2, 17, 17, 8),
    PE.grouped_matmul_spec((3, 0, 7, 1), 6, 5),
    _dx_spec((3, 0, 7, 1), 6, 5),
    _dw_spec((3, 0, 7, 1), 6, 5),
]


@pytest.mark.parametrize("spec", FUSED_SPECS, ids=lambda s: s.name)
def test_fused_oracle_is_the_reference_oracle(spec):
    """``measure.fused_oracle`` (torch, f64, on the operands' device)
    against ``einsum_reference`` on the same inputs."""
    arrays = measure.reference_arrays(spec, seed=5)
    tensors = [torch.from_numpy(arrays[n]) for n in spec.operands]
    got = measure.fused_oracle(spec, tensors)
    want = measure.einsum_reference(spec, arrays)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_a_timed_call_must_launch_once_on_its_plan():
    """``measure._call``: one launch of the spec's launcher a call, on the
    requested plan, or it raises."""
    class Launcher:
        launches, last_plan = 0, None

    fake = Launcher()
    plan = FusedPlan("grouped", "ring", 32, 0)

    def kern(*_):
        fake.launches += 1
        fake.last_plan = plan
        return 1

    assert measure._call(kern, (), fake, plan, "ok") == 1
    with pytest.raises(AssertionError, match="launches"):
        measure._call(kern, (), fake, plan._replace(block=16), "wrong")
    with pytest.raises(AssertionError, match="0 launches"):
        measure._call(lambda *_: 1, (), fake, plan, "none")
    assert measure._launcher_of(FUSED_SPECS[0], torch.bfloat16) is \
        fused_gen.ATTENTION
    assert measure._launcher_of(FUSED_SPECS[2], torch.bfloat16) is \
        fused_gen.GROUPED
    assert measure._launcher_of(FUSED_SPECS[3], torch.bfloat16) is \
        fused_gen.GROUPED
    assert measure._launcher_of(FUSED_SPECS[4], torch.bfloat16) is \
        fused_gen.GROUPED_DW
    assert measure._launcher_of(PE.matmul_spec(8, 8, 8), torch.float32) is \
        codegen.CONTRACT


def test_launchers_count_applied_and_skipped_plans():
    """A plan of the launch's own body is applied, another skipped, both
    counted under ``ops.card_plan``; without one nothing is counted."""
    obs.metrics_reset()
    plan = FusedPlan("attention", "ring", 64, 8)
    assert fused_gen._plan_state(plan, "attention", "ring") == plan
    assert fused_gen._plan_state(plan, "attention", "mma") is None
    assert fused_gen._plan_state(plan, "grouped", "ring") is None
    assert fused_gen._plan_state(cuda_gen.CardPlan("ring", 128, 1),
                                 "attention", "ring") is None
    assert fused_gen._plan_state(None, "attention", "ring") is None
    counters = obs.metrics_json()["counters"]
    assert counters.get("ops.card_plan.applied") == 1
    assert counters.get("ops.card_plan.skipped") == 3


def test_explain_renders_a_fused_rung():
    spec = PE.attention_spec(4, 64, 64, 16)
    rung = entry_from(default_schedule(spec), score=float("inf"),
                      lower_bound=0.0, fits_vmem=True, measured_s=2.5e-4,
                      card=FusedPlan("attention", "ring", 64, 99).as_dict())
    b1 = entry_from(default_schedule(spec), score=1e-4, lower_bound=0.0,
                    fits_vmem=True, measured_s=3e-4, source="default",
                    card={"body": "ring", "tile_n": 128, "splits": 1})
    text = format_entry("k", {"ranked": [rung, b1],
                              "spec": {"name": "attention",
                                       "extents": spec.extents}})
    row = next(line for line in text.splitlines()
               if "attention ring 64x99" in line)
    assert row.split()[-3:] == ["0.2500", "-", "-"]
    assert any("ring 128x1" in line and "0.1000" in line
               for line in text.splitlines())


@pytest.mark.parametrize("family,extents", [
    ("attention", (2, 16, 16, 8)),
    ("grouped_matmul", (2, 8, 16, 16)),
], ids=["attention", "grouped_matmul"])
def test_fused_cpu_ladders_remain_the_reference_ladders(family, extents):
    """A measured CPU ladder of a fused family (the plain version timed on
    the host) holds the reference's rungs: the same schedules with their
    scores, bounds, sources and explain terms, no card plan, and errors
    against the oracle at the existing tests' tolerance.  Timings differ,
    so the rungs are compared as a set."""
    r = R.spec_from_name(family, extents)
    p = P.spec_from_name(family, extents)
    kw = dict(beam_width=4, topk=3, measure=True)
    rres = R.search_schedule(r, dtype=np.float32, interpret=True,
                             arrays=R.reference_arrays(r, seed=3), **kw)
    pres = P.search_schedule(p, dtype=torch.float32, device="cpu",
                             arrays=P.reference_arrays(p, seed=3), **kw)

    def rungs(res, to_dict):
        return sorted(
            (json.dumps(to_dict(x.schedule), sort_keys=True), x.score,
             x.lower_bound, x.fits_vmem, x.source, x.collective,
             json.dumps(x.explain, sort_keys=True)) for x in res.ranked)

    assert rungs(pres, p_sched_dict) == rungs(rres, r_sched_dict)
    assert all(x.card is None and x.max_err < 1e-3 for x in pres.ranked)
    assert pres.stats.as_dict() == rres.stats.as_dict()


def test_sweep_cli_sweeps_causal_attention(tmp_path):
    """``sweep --spec attention --causal``: the causal spec's ladder (the
    key ``ops.attention(causal=True)`` looks up) round-trips; ``--causal``
    on another family is refused."""
    from repro_torch.search import sweep

    rc, results = sweep.run(["--spec", "attention", "--shapes", "2,16,16,8",
                             "--causal", "--device", "cpu", "--plan-db",
                             str(tmp_path / "plans.json")])
    assert rc == 0 and [r[1].causal for r in results] == [True]
    db = P.PlanDB(str(tmp_path / "plans.json"))
    assert db.get(PE.attention_spec(2, 16, 16, 8, causal=True),
                  torch.float32, "cpu") is not None
    assert db.get(PE.attention_spec(2, 16, 16, 8), torch.float32,
                  "cpu") is None
    with pytest.raises(SystemExit, match="causal"):
        sweep.run(["--spec", "matmul", "--shapes", "8,8,8", "--causal",
                   "--device", "cpu"])


def test_smoke_expects_the_plan_db_s_b1_plan(tmp_path, monkeypatch):
    """``chip_smoke._searched_card`` is the B1 plan ``ops`` launches for a
    spec: None without a ladder, the stored winner's ``CardPlan`` with
    one, and None where the winner carries a fused plan (which ``ops``
    drops for a B1 spec)."""
    import sys

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    db = P.default_plan_db()
    spec = PE.matmul_spec(4, 64, 256)
    assert chip_smoke._searched_card(spec, torch.float32) is None
    won, heur = (cuda_gen.CardPlan("tc32", 16, 1),
                 cuda_gen.CardPlan("tc32", 8, 1))
    _fused_ladder(db, spec, torch.float32, won, heur)
    assert chip_smoke._searched_card(spec, torch.float32) == won
    # another dtype's key holds no ladder
    assert chip_smoke._searched_card(spec, torch.bfloat16) is None
    _fused_ladder(db, spec, torch.float32,
                  FusedPlan("attention", "ring", 64, 2),
                  FusedPlan("attention", "ring", 128, 2))
    assert chip_smoke._searched_card(spec, torch.float32) is None
