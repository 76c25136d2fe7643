"""Searched card plans for B1's weighted family, its epilogue launches, the
8-bit rings and the chain, on the CPU.

The plans themselves run only on the card (``tests/test_torch_gpu.py``
launches every one of them against its plain version); here, on meta and
CPU tensors: each mode's candidates are legal and hold the launcher's own
plan (``space.card_candidates`` under an epilogue,
``space.q8_card_candidates``, ``space.chain_card_candidates``), the
card ladder's rungs for each fold (two or more where the body takes a
plan, one where it takes none), the launcher a timed call must be one
launch of (``measure._launcher_of``), the plan DB round trip of each plan
kind (``fused_gen.plan_from_dict``; older DBs load as they were; the
epilogue-qualified key), ``ops._tuned_kernel`` handing each stored plan
to the compiled kernel and an epilogue lookup taking its own ladder's
plan only, ``_launch_cuda`` routing a plan to the launcher of its kind
(fakes of the launchers), the f64 oracle and epilogue vectors of a
measurement, ``sweep --quant``, and -- under a stored plan -- the ops'
CPU results against the JAX reference in interpret mode at the reference
tests' tolerances (inputs made with numpy from a seed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import ops as ref_ops
from repro.optim import quant as RQ
import repro_torch.core.enumerate as PE
import repro_torch.search as P
from repro_torch import codegen, obs, ops
from repro_torch.codegen import cuda_gen, fused_gen, modes
from repro_torch.codegen.schedules import default_schedule
from repro_torch.grad import derived_specs
from repro_torch.search import measure
from repro_torch.search.plandb import entry_from

#: the reference's tests/test_differential.py tolerances, on values scaled
#: by max(|ref|, 1)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 6e-2)}
SMS = cuda_gen.H100_SMS


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


def _meta(spec, dtype, kmajor=False):
    """``spec``'s operands on the meta device, contiguous in their index
    order; ``kmajor`` lays a matrix whose first index is reduced with that
    index unit-stride (an 8-bit W as ``ops.dense(quant=)`` writes it)."""
    out = []
    for axes in spec.operands.values():
        shape = tuple(spec.extents[i] for i in axes)
        x = torch.empty(shape, dtype=dtype, device="meta")
        if kmajor and len(axes) == 2 and axes[0] not in spec.output:
            x = torch.empty(shape[::-1], dtype=dtype, device="meta").t()
        out.append(x)
    return out


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(a, np.float32).astype(np.float64)


def _close(got, want, rtol, atol, what):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=atol, err_msg=what)


# --------------------------------------------------------------------------
# candidates: legal, the heuristic's among them
# --------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 700), n=st.integers(1, 5000),
       k=st.integers(1, 13000),
       dtype=st.sampled_from((torch.bfloat16, torch.float32)),
       a_t=st.booleans(), b_t=st.booleans())
def test_epilogue_candidates_are_legal_and_hold_the_heuristic(m, n, k, dtype,
                                                              a_t, b_t):
    """Under an epilogue the launch runs the fused ring or tc32's epilogue
    mode: its plans are those bodies' (no narrow body, tc32's 128-wide x
    tile only), the launcher's heuristic among them, or none at all on the
    mma.sync / FMA bodies."""
    a = (torch.empty(1, k, m, dtype=dtype, device="meta").transpose(1, 2)
         if a_t else torch.empty(1, m, k, dtype=dtype, device="meta"))
    b = (torch.empty(1, n, k, dtype=dtype, device="meta").transpose(1, 2)
         if b_t else torch.empty(1, k, n, dtype=dtype, device="meta"))
    spec = PE.matmul_spec(m, k, n)
    plans = P.card_candidates(spec, a, b, epilogue=True)
    body = cuda_gen.contract_body(a, b, plain=False)
    heur = cuda_gen.heuristic_plan(body, 1, m, n, k)
    if body in ("mma", "fma"):
        assert plans == [] and heur is None
        return
    assert heur in plans and len(set(plans)) == len(plans)
    for plan in plans:
        assert plan.body == body in ("ring", "tc32")
        assert plan.tile_n in ((128, 256) if body == "ring" else (128,))
        nk = -(-k // (cuda_gen.RING_BK if body == "ring"
                      else cuda_gen.TC32_BK))
        assert 1 <= plan.splits <= nk


@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 700), n=st.integers(1, 3000),
       k=st.integers(1, 9000), batch=st.sampled_from((1, 2)),
       fmt=st.sampled_from(("int8", "fp8")), kmajor=st.booleans())
def test_q8_candidates_are_legal_and_hold_the_heuristic(m, n, k, batch, fmt,
                                                        kmajor):
    """The 8-bit ring's plans: one CTA a tile (the heuristic's), and one
    CTA an SM where the tiles outnumber the SMs.  None where the launch
    does not run the ring (q8_body)."""
    dt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    spec = PE.quantize_spec(PE.matmul_spec(m, k, n) if batch == 1
                            else PE.batched_matmul_spec(batch, m, k, n),
                            fmt=fmt)
    ops_ = _meta(spec, dt, kmajor=kmajor)
    plans = P.q8_card_candidates(spec, *ops_, sms=SMS)
    a3, b3 = cuda_gen.card_views(spec, *ops_)
    if modes.q8_body(a3, b3) != "ring":
        assert plans == []
        return
    tiles = batch * -(-m // modes.Q8_RING_TILE) * -(-n // modes.Q8_RING_TILE)
    assert plans == [modes.Q8_HEURISTIC] + (
        [modes.Q8Plan(SMS)] if tiles > SMS else [])


@settings(max_examples=40, deadline=None)
@given(r=st.integers(1, 5000), p=st.integers(1, 5000),
       q=st.integers(1, 5000), c=st.integers(1, 5000),
       dtype=st.sampled_from((torch.bfloat16, torch.float32, torch.int8)),
       which=st.sampled_from(("fwd", "A", "B", "C")))
def test_chain_candidates_are_legal_and_hold_the_heuristic(r, p, q, c, dtype,
                                                           which):
    """Both associations, clusters powers of two up to CHAIN_MAX_CLUSTER
    that leave every CTA a step of the first reduction, the launch's own
    plan (``cuda_gen.chain_plan``) among them."""
    spec = PE.chain_matmul_spec(r, p, q, c)
    if which != "fwd":
        spec = derived_specs(spec)[which]
    plans = P.chain_card_candidates(spec, dtype)
    fold = cuda_gen._classify(spec)
    rr, pp, qq, cc = (spec.extents[i] for i in cuda_gen.chain_extents(spec,
                                                                     fold))
    heur = cuda_gen.chain_plan(rr, pp, qq, cc, dtype)
    assert heur in plans and len(set(plans)) == len(plans)
    assert {x.assoc for x in plans} == {"xy", "yz"}
    step = 64 if dtype == torch.bfloat16 else 32
    for plan in plans:
        first = pp if plan.assoc == "xy" else qq
        assert plan.cluster in (1, 2, 4, 8)
        assert plan.cluster == 1 or plan.cluster <= -(-first // step)


def test_weighted_row_reduce_candidates_take_splits():
    """The ring's row reduce takes a K split (each split's column sums a
    row block of partial rows), 128 columns wide; its scratch grows by
    the splits."""
    spec = derived_specs(PE.weighted_matmul_spec(2048, 4096, 12288))["g"]
    a3, b3, t = cuda_gen.card_views(spec, *_meta(spec, torch.bfloat16))
    assert t.shape == (2048, 4096)
    plans = P.card_candidates(spec, a3, b3)
    assert {x.tile_n for x in plans} == {128}
    assert max(x.splits for x in plans) == P.space.CARD_MAX_SPLITS
    plan = cuda_gen.RingPlan(128, 3)
    assert cuda_gen.scratch_sizes("ring", 1, 2048, 4096, plan,
                                  row_reduce=True) == (16 * 3 * 4096, 32)
    assert cuda_gen.scratch_sizes("fma", 1, 2048, 4096, plan,
                                  row_reduce=True, tile=(128, 64)) == (
        16 * 4096, 64)


# --------------------------------------------------------------------------
# the card ladder of each mode
# --------------------------------------------------------------------------

M, D, F = 256, 512, 384


def _rungs(spec, dtype, epilogue=None):
    plans, stats, _ = P._card_ladder(spec, [], None, dtype, 8, 4, "cpu",
                                     epilogue)
    return plans, stats


@pytest.mark.parametrize("label", ["fwd", "dA", "dB", "dg"])
def test_weighted_folds_have_two_or_more_rungs(label):
    """bf16 at M >= 64: the ring's plans, ranked by the cost model, the
    heuristic's in the default role, every rung a distinct plan."""
    spec = dict(P.sweep_specs(PE.weighted_matmul_spec(M, D, F),
                              with_grads=True))[label]
    plans, stats = _rungs(spec, torch.bfloat16)
    cards = [x.card for x in plans]
    assert len(cards) >= 2 and len(set(cards)) == len(cards)
    assert all(c.body == "ring" for c in cards)
    assert sum(x.source == "default" for x in plans) == 1
    assert stats.considered >= len(cards)


def test_epilogue_ladder_has_two_or_more_rungs():
    epi = codegen.Epilogue(act="gelu", bias=True, norm=True)
    plans, _ = _rungs(PE.matmul_spec(M, D, F), torch.bfloat16, epi)
    assert len(plans) >= 2 and all(x.card.body == "ring" for x in plans)
    assert sum(x.source == "default" for x in plans) == 1


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_8bit_tiers_have_two_or_more_rungs(tier):
    """``search_dtype_ladder``'s tier specs with more tiles than SMs (256
    here): both plans of the 8-bit ring, measured (no cost model), on W
    laid out k-major as ``ops.dense(quant=)`` passes it."""
    m, d, f = 2048, 384, 2048  # fp8 takes the ring from K = 384
    (_, spec, dt), = [t for t in P.dtype_tier_specs(
        PE.matmul_spec(m, d, f), dtype=torch.bfloat16) if t[0] == tier]
    plans, stats = _rungs(spec, dt)
    cards = [x.card for x in plans]
    assert len(cards) >= 2 and all(isinstance(c, modes.Q8Plan)
                                   for c in cards)
    assert [x.card for x in plans if x.source == "default"] == [
        modes.Q8_HEURISTIC]
    assert stats.considered == len(cards)
    _, _, tensors = P._card_ladder(spec, [], None, dt, 8, 4, "cpu")
    assert tensors["B"].stride() == (1, d)  # k-major


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chain_ladders_have_two_or_more_rungs(dtype):
    plans, _ = _rungs(PE.chain_matmul_spec(4096, 128, 4096, 128), dtype)
    cards = [x.card for x in plans]
    assert len(cards) >= 4 and all(isinstance(c, modes.ChainPlan)
                                   for c in cards)
    assert [x.card for x in plans if x.source == "default"] == [
        modes.ChainPlan("yz", 8)]


@pytest.mark.parametrize("case", ["upcast", "mma", "fma", "fp8 k-scale"])
def test_bodies_without_a_plan_keep_one_rung(case):
    """The upcast body (the int8 weighted forward at M < 64), mma.sync
    (bf16 weighted at M < 64), FMA (the f32 k-scale) and fp8's k-scale
    (contract.cu's bf16 ring, which the 8-bit ladder does not rank): one
    default rung, no plan."""
    spec, dt = {
        "upcast": (PE.quantize_spec(PE.weighted_matmul_spec(32, D, F),
                                    fmt="int8"), torch.int8),
        "mma": (PE.weighted_matmul_spec(32, D, F), torch.bfloat16),
        "fma": (PE.weighted_matmul_spec(M, D, F), torch.float32),
        "fp8 k-scale": (PE.quantize_spec(PE.weighted_matmul_spec(M, D, F),
                                         fmt="fp8"), torch.float8_e4m3fn),
    }[case]
    plans, _ = _rungs(spec, dt)
    assert len(plans) == 1 and plans[0].card is None
    assert plans[0].source == "default"


def test_launcher_of_each_mode():
    """The launcher whose one launch a timed call must be, by mode (the
    fused and plain ones as ``tests/test_torch_fused_plans.py`` holds)."""
    bf16 = torch.bfloat16
    w = PE.weighted_matmul_spec(M, D, F)
    for spec in (w, *derived_specs(w).values()):
        assert measure._launcher_of(spec, bf16) is codegen.CONTRACT
        assert measure._launcher_of(spec, torch.float32) is codegen.CONTRACT
    chain = PE.chain_matmul_spec(64, 32, 48, 16)
    for spec in (chain, *derived_specs(chain).values()):
        assert measure._launcher_of(spec, bf16) is modes.CONTRACT_CHAIN
    for fmt, launcher, dt in (("int8", modes.CONTRACT_INT8, torch.int8),
                              ("fp8", modes.CONTRACT_FP8,
                               torch.float8_e4m3fn)):
        q = PE.quantize_spec(PE.matmul_spec(M, D, F), fmt=fmt)
        assert measure._launcher_of(q, dt) is None  # the route needs data
        assert measure._launcher_of(q, dt, _meta(q, dt, True)) is launcher
        qd = PE.quantize_spec(derived_specs(w)["g"], fmt=fmt)
        assert measure._launcher_of(qd, dt, _meta(qd, dt)) is launcher
    qf = PE.quantize_spec(w, fmt="fp8")  # fp8's k-scale: contract.cu
    assert measure._launcher_of(qf, torch.float8_e4m3fn, _meta(
        qf, torch.float8_e4m3fn)) is codegen.CONTRACT
    qs = PE.quantize_spec(PE.weighted_matmul_spec(32, D, F), fmt="int8")
    assert measure._launcher_of(qs, torch.int8, _meta(
        qs, torch.int8)) is modes.CONTRACT_UPCAST


def test_a_timed_call_checks_each_launchers_plan():
    """``measure._call`` reads the plan the launch ran: ``last_card`` of
    B1's and the 8-bit launchers, the chain's ``last_plan``."""
    class Q8:
        launches, last_card = 0, None

    class Chain:
        launches, last_plan = 0, None

    for fake, plan, other in ((Q8(), modes.Q8Plan(132), modes.Q8Plan(0)),
                              (Chain(), modes.ChainPlan("yz", 4),
                               modes.ChainPlan("yz", 8))):
        attr = "last_card" if isinstance(fake, Q8) else "last_plan"

        def kern(*_, fake=fake, plan=plan, attr=attr):
            fake.launches += 1
            setattr(fake, attr, plan)
            return 1

        assert measure._call(kern, (), fake, plan, "ok") == 1
        with pytest.raises(AssertionError, match="launches"):
            measure._call(kern, (), fake, other, "wrong plan")


# --------------------------------------------------------------------------
# the plan DB and the op-side lookup
# --------------------------------------------------------------------------


@pytest.mark.parametrize("plan", [
    modes.Q8Plan(99), modes.Q8Plan(0), modes.ChainPlan("xy", 2),
    modes.ChainPlan("yz", 8), cuda_gen.CardPlan("ring", 128, 3),
    fused_gen.FusedPlan("attention", "ring", 64, 99)], ids=str)
def test_plan_db_round_trips_each_plan_kind(tmp_path, plan):
    import json

    db = P.PlanDB(str(tmp_path / "db.json"))
    spec = PE.matmul_spec(8, 8, 8)
    d = plan.as_dict()
    assert json.loads(json.dumps(d)) == d
    assert fused_gen.plan_from_dict(d) == plan
    assert type(fused_gen.plan_from_dict(d)) is type(plan)
    db.put(spec, torch.float32, [entry_from(
        default_schedule(spec), score=1.0, lower_bound=0.0, fits_vmem=True,
        measured_s=1e-4, card=d)])
    P.PlanDB(db.path)  # a fresh reader
    _, rung = P.PlanDB(db.path).best_entry(spec, torch.float32)
    assert fused_gen.plan_from_dict(rung["card"]) == plan


def test_older_cards_load_as_they_were():
    """A B1 tile plan without a ``kernel`` and a fused plan load as before
    (``plan_from_dict``'s rule); a rung without ``card`` is the
    reference's."""
    assert fused_gen.plan_from_dict({"body": "ring", "tile_n": 256,
                                     "splits": 1}) == cuda_gen.CardPlan(
        "ring", 256, 1)
    assert fused_gen.plan_from_dict({"kernel": "grouped", "body": "ring",
                                     "block": 32, "ctas": 0}) == \
        fused_gen.FusedPlan("grouped", "ring", 32, 0)
    assert fused_gen.plan_from_dict(None) is None


def test_epilogue_keys_are_their_own():
    """An epilogue ladder's key differs from the product's and from
    another epilogue's; no epilogue keeps the key byte for byte."""
    from repro_torch.search.plandb import plan_key

    spec = PE.matmul_spec(64, 64, 64)
    gelu = codegen.Epilogue(act="gelu", bias=True, norm=True, eps=1e-5)
    assert gelu.kind == "bias+mean+var:gelu"
    assert codegen.Epilogue(act="gelu", bias=True, norm=True,
                            eps=1e-3).kind == gelu.kind
    assert codegen.Epilogue(dequant=True).kind == "qscale:id"
    keys = {plan_key(spec, "bfloat16", "cpu"),
            plan_key(spec, "bfloat16", "cpu", epilogue=gelu.kind),
            plan_key(spec, "bfloat16", "cpu", epilogue="bias:relu")}
    assert len(keys) == 3
    assert plan_key(spec, "bfloat16", "cpu", epilogue=None) == plan_key(
        spec, "bfloat16", "cpu")


def _store(db, spec, dtype, plan, epilogue=None):
    db.put(spec, dtype, [entry_from(
        default_schedule(spec), score=1.0, lower_bound=0.5, fits_vmem=True,
        measured_s=1e-4, card=plan.as_dict())], epilogue=epilogue)


def test_tuned_kernel_hands_each_stored_plan_to_the_kernel():
    """A weighted rung's B1 plan, a tier's ``Q8Plan`` (the one measured
    under the dequant epilogue, its own ladder, reaches the dequant
    launch), the chain's ``ChainPlan``: each reaches the compiled
    kernel."""
    db = ops.default_plan_db()
    cases = [
        (derived_specs(PE.weighted_matmul_spec(M, D, F))["g"],
         torch.bfloat16, cuda_gen.CardPlan("ring", 128, 2), None),
        (PE.weighted_matmul_spec(M, D, F), torch.bfloat16,
         cuda_gen.CardPlan("ring", 128, 4), None),
        (PE.quantize_spec(PE.matmul_spec(M, D, F), fmt="int8"), torch.int8,
         modes.Q8Plan(132), codegen.Epilogue(dequant=True)),
        (PE.quantize_spec(PE.matmul_spec(M, D, F), fmt="fp8"),
         torch.float8_e4m3fn, modes.Q8Plan(99), None),
        (PE.chain_matmul_spec(64, 32, 48, 16), torch.float32,
         modes.ChainPlan("xy", 2), None),
    ]
    for spec, dt, plan, epi in cases:
        _store(db, spec, dt, plan, epilogue=epi and epi.kind)
        kern = ops._tuned_kernel(spec, dt, interpret=True, epilogue=epi)
        assert kern.card == plan, spec.name


def test_an_epilogue_lookup_takes_only_its_own_ladders_plan():
    """A plain product's B1 plan never reaches an epilogue launch; the
    epilogue's own ladder does, and never reaches the plain product's
    launch or another epilogue's."""
    db = ops.default_plan_db()
    spec = PE.matmul_spec(M, D, F)
    epi = codegen.Epilogue(act="gelu", bias=True, norm=True, eps=1e-5)
    plain, fused = (cuda_gen.CardPlan("ring", 256, 1),
                    cuda_gen.CardPlan("ring", 128, 2))
    _store(db, spec, torch.bfloat16, plain)
    assert ops._tuned_kernel(spec, torch.bfloat16, interpret=True,
                             epilogue=epi).card is None
    _store(db, spec, torch.bfloat16, fused, epilogue=epi.kind)
    assert ops._tuned_kernel(spec, torch.bfloat16, interpret=True,
                             epilogue=epi).card == fused
    assert ops._tuned_kernel(spec, torch.bfloat16,
                             interpret=True).card == plain
    relu = codegen.Epilogue(act="relu", bias=True)
    assert ops._tuned_kernel(spec, torch.bfloat16, interpret=True,
                             epilogue=relu).card is None
    # the serving phase's epilogue ladder first, then the unphased one
    decode = cuda_gen.CardPlan("ring", 128, 3)
    db.put(spec, torch.bfloat16, [entry_from(
        default_schedule(spec), score=1.0, lower_bound=0.5, fits_vmem=True,
        measured_s=1e-4, card=decode.as_dict())], epilogue=epi.kind,
        phase="decode")
    with P.serving_phase("decode"):
        assert ops._tuned_kernel(spec, torch.bfloat16, interpret=True,
                                 epilogue=epi).card == decode
    with P.serving_phase("prefill"):
        assert ops._tuned_kernel(spec, torch.bfloat16, interpret=True,
                                 epilogue=epi).card == fused


def test_a_tier_plan_measured_without_the_dequant_never_reaches_it():
    """``ops.dense(quant=)`` launches under the dequant epilogue: a tier's
    ``Q8Plan`` from the unqualified ladder (timed without it) stays off
    that launch, the one from the dequant ladder reaches it, and neither
    crosses to the other lookup."""
    db = ops.default_plan_db()
    spec = PE.quantized_matmul_spec(M, D, F, "int8")
    dequant = codegen.Epilogue(dequant=True)
    _store(db, spec, torch.int8, modes.Q8Plan(132))
    assert ops._tuned_kernel(spec, torch.int8, interpret=True,
                             epilogue=dequant,
                             out_dtype=torch.float32).card is None
    _store(db, spec, torch.int8, modes.Q8Plan(7), epilogue=dequant.kind)
    assert ops._tuned_kernel(spec, torch.int8, interpret=True,
                             epilogue=dequant,
                             out_dtype=torch.float32).card == modes.Q8Plan(7)
    assert ops._tuned_kernel(spec, torch.int8,
                             interpret=True).card == modes.Q8Plan(132)


@pytest.mark.parametrize("case", ["cuda", "cpu", "unmeasured", "mesh",
                                  "three operands"])
def test_quant_tiers_are_measured_under_the_dequant_on_the_card(case):
    """``quant_tier_epilogue``: the dequant epilogue for a two-operand tier
    measured on the card at one rank, else None (the reference's key)."""
    spec = PE.quantize_spec(PE.matmul_spec(M, D, F), fmt="int8")
    kw = {"device": "cuda"}
    if case == "cpu":
        kw["device"] = "cpu"
    elif case == "unmeasured":
        kw["measure"] = False
    elif case == "mesh":
        kw["mesh_shape"] = (2, 1)
    elif case == "three operands":
        spec = PE.quantize_spec(PE.weighted_matmul_spec(M, D, F),
                                fmt="int8")
    got = P.quant_tier_epilogue(spec, **kw)
    if case == "cuda":
        assert got == codegen.Epilogue(dequant=True)
        assert got.kind == "qscale:id"
    else:
        assert got is None


def test_smoke_names_each_ring_kernel():
    """``chip_smoke._kernel_of`` attributes the 8-bit ring's persistent
    kernel, beside its one-CTA-a-tile kernel, to the launcher of its first
    template argument (true: int8)."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    ns = "void (anonymous namespace)::"
    for kernel, want in (("q8_ring_kernel<true, 1>", "contract_int8"),
                         ("q8_ring_persistent_kernel<true, 1>",
                          "contract_int8"),
                         ("q8_ring_persistent_kernel<true, 2>",
                          "contract_int8"),
                         ("q8_ring_persistent_kernel<false, 1>",
                          "contract_fp8")):
        assert chip_smoke._kernel_of(
            f"{ns}{kernel}(CUtensorMap_st, CUtensorMap_st, Q8Params)") == \
            want, kernel


def test_epilogue_search_is_for_the_card():
    with pytest.raises(ValueError, match="card"):
        P.search_schedule(PE.matmul_spec(8, 8, 8), dtype=torch.float32,
                          device="cpu",
                          epilogue=codegen.Epilogue(act="relu"))


# --------------------------------------------------------------------------
# the launch side: plans routed to the launcher of their kind
# --------------------------------------------------------------------------


class _Fake:
    """A launcher that records its keyword arguments and returns zeros of
    the product's (or the row reduce's) shape."""

    def __init__(self):
        self.calls = []

    def __call__(self, a, b, out_dtype, **kw):
        self.calls.append(kw)
        if kw.get("t") is not None:
            return torch.zeros(b.shape[2], dtype=out_dtype)
        return torch.zeros(a.shape[0], a.shape[1], b.shape[2],
                           dtype=out_dtype)


def test_launch_routes_a_plan_to_its_launcher(monkeypatch):
    """``_launch_cuda``: a ``Q8Plan`` goes to the 8-bit ring's launcher, a
    ``CardPlan`` to ``CONTRACT``; a plan of another kind is counted
    ``ops.card_plan.skipped`` and the launcher gets none."""
    fakes = {name: _Fake() for name in ("CONTRACT", "CONTRACT_INT8",
                                        "CONTRACT_UPCAST")}
    for name, fake in fakes.items():
        monkeypatch.setattr(cuda_gen, name, fake)
    obs.metrics_reset()
    q = PE.quantize_spec(PE.matmul_spec(M, D, F), fmt="int8")
    args = [torch.zeros(M, D, dtype=torch.int8),
            torch.zeros(F, D, dtype=torch.int8).t()]
    cuda_gen._launch_cuda(q, *args, out_dtype=torch.float32,
                          card=modes.Q8Plan(132))
    assert fakes["CONTRACT_INT8"].calls[-1]["plan"] == modes.Q8Plan(132)
    cuda_gen._launch_cuda(q, *args, out_dtype=torch.float32,
                          card=cuda_gen.CardPlan("ring", 128, 1))
    assert "plan" not in fakes["CONTRACT_INT8"].calls[-1]
    w = PE.weighted_matmul_spec(M, D, F)
    wargs = [torch.zeros(M, D), torch.zeros(D, F), torch.zeros(D)]
    cuda_gen._launch_cuda(w, *wargs, out_dtype=torch.float32,
                          card=cuda_gen.CardPlan("tc32", 128, 2))
    assert fakes["CONTRACT"].calls[-1]["plan"] == cuda_gen.CardPlan(
        "tc32", 128, 2)
    cuda_gen._launch_cuda(w, *wargs, out_dtype=torch.float32,
                          card=modes.Q8Plan(0))
    assert "plan" not in fakes["CONTRACT"].calls[-1]
    counters = obs.metrics_json()["counters"]
    assert counters.get("ops.card_plan.skipped") == 2


def test_chain_launch_runs_its_plans_association(monkeypatch):
    """A ``ChainPlan`` picks the association and reaches the launcher; the
    heuristic's is ``cuda_gen.chain_plan``'s."""
    seen = []

    def record(x, y, z, out_dtype, *, epilogue=None, vectors=None, out=None,
               plan=None):
        seen.append((tuple(x.shape), plan))
        return out

    monkeypatch.setattr(cuda_gen, "CONTRACT_CHAIN", record)
    spec = PE.chain_matmul_spec(4096, 128, 4096, 128)
    args = [torch.zeros(4096, 128), torch.zeros(128, 4096),
            torch.zeros(4096, 128)]
    cuda_gen._launch_cuda(spec, *args, out_dtype=torch.float32)
    assert seen[-1] == ((128, 4096), modes.ChainPlan("yz", 8))
    cuda_gen._launch_cuda(spec, *args, out_dtype=torch.float32,
                          card=modes.ChainPlan("xy", 2))
    assert seen[-1] == ((4096, 128), modes.ChainPlan("xy", 2))
    with pytest.raises(ValueError, match="association"):
        cuda_gen._launch_cuda(spec, *args, out_dtype=torch.float32,
                              card=modes.ChainPlan("x", 1))


# --------------------------------------------------------------------------
# measurement: the f64 oracle and the epilogue's vectors
# --------------------------------------------------------------------------


def test_three_operand_oracle_folds_pairwise():
    rng = np.random.default_rng(3300)
    w = PE.weighted_matmul_spec(6, 5, 4)
    for spec in (w, *derived_specs(w).values(),
                 PE.chain_matmul_spec(3, 4, 5, 6)):
        arrays = {n: rng.standard_normal(tuple(spec.extents[i] for i in ax))
                  for n, ax in spec.operands.items()}
        got = measure._oracle(spec, [torch.from_numpy(a)
                                     for a in arrays.values()])
        want = measure.einsum_reference(spec, arrays)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)


def test_three_operand_oracle_reads_the_spec_not_the_kernels_fold(
        monkeypatch):
    """The oracle folds from the spec's indices alone: with the kernels'
    fold classifier broken it still gives the einsum's answer."""
    def broken(_spec):
        raise AssertionError("the oracle read cuda_gen._classify")

    monkeypatch.setattr(cuda_gen, "_classify", broken)
    rng = np.random.default_rng(3301)
    w = PE.weighted_matmul_spec(7, 3, 5)
    for spec in (w, derived_specs(w)["g"], PE.chain_matmul_spec(2, 6, 3, 4)):
        tensors = [torch.from_numpy(rng.standard_normal(
            tuple(spec.extents[i] for i in ax))) for ax in
            spec.operands.values()]
        got = measure._oracle(spec, tensors)
        want = torch.einsum(PE.einsum_formula(spec), *tensors)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_epilogue_vectors_are_seeded_and_positive_where_they_must_be():
    spec = PE.matmul_spec(4, 4, 16)
    epi = codegen.Epilogue(act="gelu", bias=True, scale=True, norm=True,
                           dequant=True)
    a = measure.epilogue_vectors(spec, epi, "cpu")
    b = measure.epilogue_vectors(spec, epi, "cpu")
    assert sorted(a) == sorted(epi.vector_names)
    assert all(torch.equal(a[n], b[n]) and a[n].shape == (16,) for n in a)
    assert bool((a["var"] >= 0.5).all()) and bool((a["qscale"] > 0).all())


def test_sweep_quant_writes_the_tier_ladder_ops_reads(tmp_path):
    """``sweep --quant int8`` (host-timed here) persists the tier's ladder
    under the key ``ops.dense(quant="int8")`` looks up."""
    from repro_torch.search import sweep

    db = str(tmp_path / "sweep.json")
    rc, results = sweep.run(["--spec", "matmul", "--shapes", "128,128,128",
                             "--quant", "int8", "--device", "cpu",
                             "--plan-db", db])
    assert rc == 0 and len(results) == 1
    spec = results[0][1]
    assert spec.quant is not None and spec.quant.dtype == "int8"
    q = PE.quantized_matmul_spec(128, 128, 128, "int8")
    assert P.PlanDB(db).get(q, torch.int8, "cpu") is not None
    with pytest.raises(SystemExit):
        sweep.run(["--spec", "matmul", "--shapes", "8,8,8", "--quant",
                   "fp8", "--with-grads", "--device", "cpu"])


# --------------------------------------------------------------------------
# the ops under a stored plan against the JAX reference (interpret mode)
# --------------------------------------------------------------------------


def _to(arrays, dtype):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                  dtype))
          for a in arrays]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_dense_under_stored_plans_matches_reference(dtype):
    """``weighted_dense`` and its three cotangents, each spec's ladder
    holding a plan: the CPU results are the plain versions', equal to the
    reference's at its tolerances."""
    rng = np.random.default_rng(3310)
    m, d, f = 6, 8, 4
    arrays = (rng.standard_normal((m, d)), rng.standard_normal((d, f)),
              rng.standard_normal(d))
    db = ops.default_plan_db()
    fwd = PE.weighted_matmul_spec(m, d, f)
    for i, spec in enumerate((fwd, *derived_specs(fwd).values())):
        _store(db, spec, getattr(torch, dtype),
               cuda_gen.CardPlan("ring", 128, 1 + i))
    jx, tx = _to(arrays, dtype)
    tx = [t.requires_grad_(True) for t in tx]
    pout = ops.weighted_dense(*tx, interpret=True)
    rout, rvjp = jax.vjp(lambda *a: ref_ops.weighted_dense(
        *a, interpret=True), *jx)
    _close(pout, rout, *TOL[dtype], "weighted_dense under plans")
    cot = rng.standard_normal((m, f))
    rgrads = rvjp(jnp.asarray(cot, rout.dtype))
    pgrads = torch.autograd.grad(pout, tx, torch.from_numpy(cot).to(
        pout.dtype))
    tol = (1e-3, 1e-3) if dtype == "float32" else TOL[dtype]
    for name, p, r in zip(("dx", "dw", "dg"), pgrads, rgrads):
        _close(p, r, *tol, f"weighted_dense {name} under plans")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_act_under_its_epilogue_plan_matches_reference(dtype):
    rng = np.random.default_rng(3320)
    m, d, f = 8, 6, 4
    arrays = (rng.standard_normal((m, d)), rng.standard_normal((d, f)),
              rng.standard_normal(f), rng.standard_normal(f) * 0.1,
              np.abs(rng.standard_normal(f)) + 0.5)
    epi = codegen.Epilogue(act="gelu", bias=True, norm=True, eps=1e-5)
    spec = PE.matmul_spec(m, d, f)
    plan = cuda_gen.CardPlan("ring", 256, 2)
    _store(ops.default_plan_db(), spec, getattr(torch, dtype), plan,
           epilogue=epi.kind)
    assert ops._tuned_kernel(spec, getattr(torch, dtype), interpret=True,
                             epilogue=epi).card == plan
    jx, tx = _to(arrays, dtype)
    got = ops.dense_act(*tx, act="gelu", eps=1e-5, interpret=True)
    ref = ref_ops.dense_act(*jx, act="gelu", eps=1e-5, interpret=True)
    _close(got, ref, *TOL[dtype], "dense_act under its epilogue plan")


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_dense_quant_under_a_tier_plan_matches_reference(fmt):
    rng = np.random.default_rng(3330)
    x = rng.standard_normal((128, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 128)) / 8).astype(np.float32)
    spec = PE.quantized_matmul_spec(128, 128, 128, fmt)
    dt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    _store(ops.default_plan_db(), spec, dt, modes.Q8Plan(7),
           epilogue=codegen.Epilogue(dequant=True).kind)
    got = ops.dense(torch.from_numpy(x), torch.from_numpy(w), quant=fmt,
                    interpret=True)
    want = ref_ops.dense(jnp.asarray(x), jnp.asarray(w), quant=fmt,
                         interpret=True)
    _close(got, want, 1e-5, 1e-5, f"dense(quant={fmt!r}) under a plan")
    qx, sx = RQ.quantize_tensor(jnp.asarray(x), fmt)
    assert np.asarray(sx) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_dense_under_a_plan_matches_reference(dtype):
    rng = np.random.default_rng(3340)
    m, k1, k2, n = 33, 17, 40, 5
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((m, k1), (k1, k2), (k2, n))]
    spec = PE.chain_matmul_spec(m, k1, k2, n)
    _store(ops.default_plan_db(), spec, getattr(torch, dtype),
           modes.ChainPlan("xy", 1))
    jx, tx = _to(arrays, dtype)
    tx = [t.requires_grad_(True) for t in tx]
    rout, rvjp = jax.vjp(lambda a, b, c: ref_ops.chain_dense(
        a, b, c, interpret=True), *jx)
    pout = ops.chain_dense(*tx, interpret=True)
    _close(pout, rout, *TOL[dtype], "chain_dense under a plan")
    cot = rng.standard_normal((m, n)).astype(np.float32)
    rgrads = rvjp(jnp.asarray(cot).astype(rout.dtype))
    pgrads = torch.autograd.grad(pout, tx, torch.tensor(cot).to(pout.dtype))
    for name, p, r in zip("ABC", pgrads, rgrads):
        _close(p, r, *TOL[dtype], f"chain_dense d{name} under a plan")


def test_explain_names_the_new_plan_kinds():
    from repro_torch.obs.explain import _card_plan

    assert _card_plan(modes.Q8Plan(132).as_dict()) == "q8 ring 132"
    assert _card_plan(modes.ChainPlan("yz", 8).as_dict()) == "chain yz x8"
    assert _card_plan(cuda_gen.CardPlan("ring", 256, 2).as_dict()) == \
        "ring 256x2"
