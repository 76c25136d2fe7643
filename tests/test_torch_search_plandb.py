"""The write side of the port's plan DB (``search.plandb``) against the
reference's, and the card plan's way from a rung to a launch.

* ``entry_from``'s JSON and ``grad_plan_keys`` byte-identical to the
  reference's; a ``card`` field only where one is given;
* the golden fixture (``tests/data/plan_db_golden.json``) rebuilt through
  the port's search and write side, entry for entry, byte for byte, for
  every point, the two ``@mesh=2x4`` points through the mesh tier;
* the concurrency contract of ``tests/test_plandb_concurrency.py`` for
  the port's writers: two processes writing forward and backward ladders
  of the same shapes lose no entry, one lock file, exact counts under
  threads;
* a ``card`` rung round-trips through ``PlanDB.best_entry`` and
  ``ops._tuned_kernel`` compiles its plan into the kernel, under memo
  keys that tell plans apart; ``search_gemm_plans`` followed by
  ``ops.dense`` picks up the persisted winner;
* where a card is visible, a ladder or tuner entry timed on the host is
  keyed ``cpu`` and never answers a card search, nor the other way round;
* ``serve --search-gemms`` on the small f32 model on the CPU writes the
  prefill ladders (with the derived backward specs) and the decode
  ladders under the reference's phase keys, and a restart finds them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.core.enumerate as RE
import repro.search as R
from repro.grad import derived_specs as r_derived
from repro.search.plandb import entry_from as r_entry_from
from repro.search.plandb import grad_plan_keys as r_grad_plan_keys
from repro.search.plandb import plan_key as r_plan_key

import repro_torch.codegen.cache as p_cache
import repro_torch.core.enumerate as PE
import repro_torch.search as P
from repro_torch import ops
from repro_torch.codegen import cuda_gen
from repro_torch.codegen.schedules import default_schedule
from repro_torch.grad import derived_specs as p_derived
from repro_torch.search.plandb import entry_from, grad_plan_keys, plan_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "plan_db_golden.json")
GOLDEN_HW = "golden/fixture-hw"


def _blob(x) -> str:
    return json.dumps(x, sort_keys=True, separators=(",", ":"))


ENTRY_KW = [
    dict(score=1.5, lower_bound=0.25, fits_vmem=True),
    dict(score=3, lower_bound=2, fits_vmem=False, measured_s=0.125,
         source="default", collective="ring",
         explain={"compute_s": 1e-6, "seq_steps": 3}),
    dict(score=float("inf"), lower_bound=0.0, fits_vmem=True,
         measured_s=None, source="mesh-naive"),
]


@pytest.mark.parametrize("kw", ENTRY_KW, ids=("plain", "full", "inf"))
@pytest.mark.parametrize("blocks", ({}, {"i": 8, "k": 16}))
def test_entry_from_is_the_reference_json(kw, blocks):
    r_spec, p_spec = RE.matmul_spec(32, 16, 64), PE.matmul_spec(32, 16, 64)
    r_sched = R.candidate_schedule(r_spec, r_spec.indices, blocks)
    p_sched = P.candidate_schedule(p_spec, p_spec.indices, blocks)
    assert json.dumps(entry_from(p_sched, **kw)) == \
        json.dumps(r_entry_from(r_sched, **kw))
    plan = cuda_gen.CardPlan("ring", 256, 2)
    with_card = entry_from(p_sched, card=plan.as_dict(), **kw)
    assert with_card.pop("card") == {"body": "ring", "tile_n": 256,
                                     "splits": 2}
    assert json.dumps(with_card) == json.dumps(r_entry_from(r_sched, **kw))


GRAD_SPECS = [("matmul", (64, 32, 128)), ("weighted_matmul", (8, 16, 8)),
              ("chain_matmul", (8, 8, 16, 8)),
              ("transposed_matmul", (16, 8, 32)),
              ("batched_matmul", (2, 8, 16, 8)),
              ("attention", (2, 16, 16, 8)),
              ("grouped_matmul", (2, 8, 16, 16))]


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("family,extents", GRAD_SPECS,
                         ids=[f for f, _ in GRAD_SPECS])
def test_grad_plan_keys_match_reference(family, extents, dtype):
    r = R.spec_from_name(family, extents)
    p = P.spec_from_name(family, extents)
    got = grad_plan_keys(p, getattr(torch, dtype), hardware=GOLDEN_HW)
    want = r_grad_plan_keys(r, np.dtype(dtype), hardware=GOLDEN_HW)
    assert got == want
    assert sorted(got) == sorted(p_derived(p))
    fwd = plan_key(p, getattr(torch, dtype), hardware=GOLDEN_HW)
    assert fwd not in got.values()


_R_FWD, _P_FWD = RE.matmul_spec(512, 512, 512), PE.matmul_spec(512, 512, 512)
_R_ATTN, _P_ATTN = RE.attention_spec(4, 64, 64, 8), PE.attention_spec(
    4, 64, 64, 8)
_R_GRP, _P_GRP = (RE.uniform_grouped_spec(4, 16, 32, 32),
                  PE.uniform_grouped_spec(4, 16, 32, 32))


def _golden_points():
    """(label, reference spec, port spec, dtype name): the fixture's
    single-device points, as ``tests/test_plandb_golden.py`` lists them."""
    rd, pd = r_derived(_R_FWD), p_derived(_P_FWD)
    ra, pa = r_derived(_R_ATTN), p_derived(_P_ATTN)
    rg, pg = r_derived(_R_GRP), p_derived(_P_GRP)
    return [
        ("matmul-f32", _R_FWD, _P_FWD, "float32"),
        ("matmul-bf16", _R_FWD, _P_FWD, "bfloat16"),
        ("matmul.dA", rd["A"], pd["A"], "float32"),
        ("matmul.dB", rd["B"], pd["B"], "float32"),
        ("attention", _R_ATTN, _P_ATTN, "float32"),
        ("attention.dQ", ra["Q"], pa["Q"], "float32"),
        ("attention.dK", ra["K"], pa["K"], "float32"),
        ("attention.dV", ra["V"], pa["V"], "float32"),
        ("grouped_matmul", _R_GRP, _P_GRP, "float32"),
        ("grouped_matmul.dX", rg["X"], pg["X"], "float32"),
        ("grouped_matmul.dW", rg["W"], pg["W"], "float32"),
        ("matmul@int8", RE.quantize_spec(_R_FWD, fmt="int8"),
         PE.quantize_spec(_P_FWD, fmt="int8"), "int8"),
        ("matmul@fp8", RE.quantize_spec(_R_FWD, fmt="fp8"),
         PE.quantize_spec(_P_FWD, fmt="fp8"), "float8_e4m3fn"),
    ]


GOLDEN = _golden_points()


@pytest.mark.parametrize("label,r_spec,p_spec,dtype", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_plan_db_rebuilt_through_the_write_side(
        label, r_spec, p_spec, dtype, tmp_path, monkeypatch):
    """The reference's regeneration recipe run through the port: the same
    key and the same entry, byte for byte."""
    monkeypatch.setattr(p_cache, "hardware_fingerprint", lambda: GOLDEN_HW)
    with open(FIXTURE) as f:
        fixture = json.load(f)
    db = P.PlanDB(str(tmp_path / "plans.json"))
    res = P.search_schedule(p_spec, dtype=getattr(torch, dtype),
                            beam_width=4, topk=3, measure=False, plan_db=db,
                            use_cached_plan=False)
    key = r_plan_key(r_spec, np.dtype(dtype), hardware=GOLDEN_HW)
    assert res.db_key == key, label
    with open(db.path) as f:
        written = json.load(f)
    assert _blob(written[key]) == _blob(fixture[key]), label
    # and the stored winner is what ops would look up
    sched, rung = db.best_entry(p_spec, getattr(torch, dtype))
    assert rung == fixture[key]["ranked"][0] and "card" not in rung


def test_golden_mesh_points_need_the_mesh_tier(tmp_path, monkeypatch):
    """The fixture's mesh points (``matmul@mesh=2x4`` and its ``.dA``),
    rebuilt through the port's mesh tier (queue A item 6c) by the
    reference's recipe: the same keys and entries, byte for byte."""
    monkeypatch.setattr(p_cache, "hardware_fingerprint", lambda: GOLDEN_HW)
    with open(FIXTURE) as f:
        fixture = json.load(f)
    db = P.PlanDB(str(tmp_path / "plans.json"))
    for r_spec, p_spec in ((_R_FWD, _P_FWD),
                           (r_derived(_R_FWD)["A"], p_derived(_P_FWD)["A"])):
        res = P.search_schedule(p_spec, dtype=torch.float32, beam_width=4,
                                topk=3, measure=False, plan_db=db,
                                use_cached_plan=False, mesh_shape=(2, 4))
        key = r_plan_key(r_spec, np.dtype("float32"), hardware=GOLDEN_HW,
                         mesh="2x4")
        assert res.db_key == key and res.mesh == "2x4"
        with open(db.path) as f:
            written = json.load(f)
        assert _blob(written[key]) == _blob(fixture[key]), p_spec.name
        sched, rung = db.best_sharded_entry(p_spec, torch.float32,
                                            mesh="2x4")
        assert sched is not None and "collective" in rung


_WRITER = """
import os, sys, time
sys.path.insert(0, {src!r})
import torch
from repro_torch.core.enumerate import matmul_spec
from repro_torch.grad import derived_specs
from repro_torch.codegen.schedules import default_schedule
from repro_torch.search.plandb import PlanDB, entry_from

which = sys.argv[1]
n_shapes = int(sys.argv[2])
db = PlanDB(os.environ["REPRO_PLAN_DB"])
deadline = float(os.environ["WRITER_START"])
while time.time() < deadline:   # start both processes together
    time.sleep(0.001)
for t in range(n_shapes):
    spec = matmul_spec(128 * (t + 1), 128, 128)
    points = {{"fwd": spec, **derived_specs(spec)}}
    for label, s in points.items():
        if (label == "fwd") != (which == "0"):
            continue
        db.put(s, torch.float32,
               [entry_from(default_schedule(s), score=1.0, lower_bound=0.0,
                           fits_vmem=True,
                           card={{"body": "ring", "tile_n": 128,
                                 "splits": t + 1}})])
print("writer", which, "done")
"""


def test_two_process_writers_keep_all_entries(tmp_path):
    path = str(tmp_path / "plans.json")
    n_shapes = 14
    env = dict(os.environ, REPRO_PLAN_DB=path,
               WRITER_START=str(time.time() + 2.0))
    script = _WRITER.format(src=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", script, w,
                               str(n_shapes)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for w in ("0", "1")]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"writer failed:\n{out}\n{err}"
    with open(path) as f:
        raw = json.load(f)
    expected = set()
    for t in range(n_shapes):
        spec = PE.matmul_spec(128 * (t + 1), 128, 128)
        expected.add(plan_key(spec, torch.float32))
        expected |= set(grad_plan_keys(spec, torch.float32).values())
    assert not expected - set(raw), "plan entries lost to concurrent writers"
    db = P.PlanDB(path)
    for t in (0, 5):
        spec = PE.matmul_spec(128 * (t + 1), 128, 128)
        for s in (spec, *p_derived(spec).values()):
            _, rung = db.best_entry(s, torch.float32)
            assert rung["card"]["splits"] == t + 1
    assert sorted(os.listdir(tmp_path)) == ["plans.json", "plans.json.lock"]


def test_threaded_plan_lookups_count_exactly(tmp_path):
    from repro_torch import obs

    db = P.PlanDB(str(tmp_path / "plans.json"))
    spec, other = PE.matmul_spec(8, 8, 8), PE.matmul_spec(16, 8, 8)
    db.put(spec, torch.float32, [entry_from(default_schedule(spec),
                                            score=1.0, lower_bound=0.0,
                                            fits_vmem=True)])
    db._cache.hits = db._cache.misses = 0
    obs.metrics_reset()
    n_threads, n_iter = 8, 100
    barrier = threading.Barrier(n_threads)

    def reader():
        barrier.wait()
        for _ in range(n_iter):
            db.best_entry(spec, torch.float32)
            db.best_entry(other, torch.float32)

    threads = [threading.Thread(target=reader) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert db._cache.hits == db._cache.misses == n_threads * n_iter
    counters = obs.metrics_json()["counters"]
    assert counters["plandb.hit"] == n_threads * n_iter
    obs.metrics_reset()


def _card_ladder(db, spec, dtype, plan, phase=None):
    return db.put(spec, dtype, [
        entry_from(default_schedule(spec), score=1.0, lower_bound=0.5,
                   fits_vmem=True, measured_s=1e-4, card=plan.as_dict()),
        entry_from(default_schedule(spec), score=2.0, lower_bound=0.5,
                   fits_vmem=True, measured_s=2e-4, source="default",
                   card=cuda_gen.CardPlan("ring", 128, 1).as_dict()),
    ], phase=phase)


def test_card_rung_reaches_the_compiled_kernel(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    db = P.default_plan_db()
    spec = PE.matmul_spec(128, 128, 256)
    plan = cuda_gen.CardPlan("ring", 256, 2)
    _card_ladder(db, spec, torch.float32, plan)
    sched, rung = db.best_entry(spec, torch.float32)
    assert cuda_gen.CardPlan.from_dict(rung["card"]) == plan
    res = P.search_schedule(spec, dtype=torch.float32, plan_db=db)
    assert res.best.card == plan and res.ranked[1].source == "default"
    kern = ops._tuned_kernel(spec, torch.float32, interpret=True)
    assert kern.card == plan
    # an epilogue's launch runs another body than the measured product
    from repro_torch.codegen import Epilogue

    fused = ops._tuned_kernel(spec, torch.float32, interpret=True,
                              epilogue=Epilogue(act="relu"))
    assert fused.card is None
    # the serving phase's own ladder wins inside its scope
    decode = cuda_gen.CardPlan("ring", 128, 3)
    _card_ladder(db, spec, torch.float32, decode, phase="decode")
    with P.serving_phase("decode"):
        assert ops._tuned_kernel(spec, torch.float32,
                                 interpret=True).card == decode
    assert ops._tuned_kernel(spec, torch.float32, interpret=True).card == \
        plan
    # memo keys tell plans apart: another plan is another kernel
    a = cuda_gen.cached_compile(spec, sched, card=plan)
    b = cuda_gen.cached_compile(spec, sched, card=decode)
    c = cuda_gen.cached_compile(spec, sched)
    assert a is not b and a is not c and b is not c
    assert (a.card, b.card, c.card) == (plan, decode, None)
    assert cuda_gen.cached_compile(spec, sched, card=plan) is a
    # a rewritten ladder replaces the process memo's kernel
    other = cuda_gen.CardPlan("ring", 128, 2)
    _card_ladder(db, spec, torch.float32, other)
    assert ops._tuned_kernel(spec, torch.float32, interpret=True).card == \
        other
    # on CPU tensors the plan changes nothing: the plain version runs
    x, w = torch.randn(128, 128), torch.randn(128, 256)
    torch.testing.assert_close(ops.dense(x, w, interpret=True), x @ w,
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="fused"):
        cuda_gen.compile_kernel(PE.attention_spec(2, 8, 8, 8),
                                default_schedule(PE.attention_spec(
                                    2, 8, 8, 8)), card=plan)


#: the fingerprint of a machine with a card (``hardware_fingerprint``)
CARD_HW = "cuda/NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("device", ["cpu", None])
@pytest.mark.parametrize("measure", [True, False])
def test_host_and_card_ladders_never_share_a_key(tmp_path, monkeypatch,
                                                 device, measure):
    """Where a card is visible, a ladder timed on the host goes under
    ``cpu`` and a card ladder under the card's fingerprint: neither
    answers a search of the other.  Without a card (here) the search
    defaults to the host."""
    monkeypatch.setattr(p_cache, "hardware_fingerprint", lambda: CARD_HW)
    db = P.PlanDB(str(tmp_path / "plans.json"))
    spec = PE.matmul_spec(16, 32, 16)
    kw = dict(dtype=torch.float32, beam_width=2, topk=1, plan_db=db,
              device=device, measure=measure, repeats=1)
    host = P.search_schedule(spec, **kw)
    assert host.db_key == plan_key(spec, torch.float32, hardware="cpu")
    assert db.get(spec, torch.float32) is None  # nothing under the card's
    plan = cuda_gen.CardPlan("ring", 256, 2)
    card_key = _card_ladder(db, spec, torch.float32, plan)
    assert card_key == plan_key(spec, torch.float32, hardware=CARD_HW)
    assert card_key != host.db_key
    again = P.search_schedule(spec, **kw)
    assert again.db_key == host.db_key
    assert all(p.card is None for p in again.ranked)
    _, rung = db.best_entry(spec, torch.float32)
    assert rung["card"] == plan.as_dict()


def test_tuner_keys_a_measured_entry_by_where_it_was_measured(
        tmp_path, monkeypatch):
    """A host-timed tuner entry is keyed ``cpu`` whatever the machine's
    fingerprint: written where a card is visible, it is found where none
    is, and an analytic request finds neither."""
    from repro_torch.codegen import AutotuneCache, tune_schedule

    cache = AutotuneCache(str(tmp_path / "tune.json"))
    spec = PE.matmul_spec(16, 32, 16)
    rng = np.random.default_rng(0)
    arrays = {"A": rng.standard_normal((16, 32)).astype(np.float32),
              "B": rng.standard_normal((32, 16)).astype(np.float32)}
    monkeypatch.setattr(p_cache, "hardware_fingerprint", lambda: CARD_HW)
    first = tune_schedule(spec, cache=cache, measure_with=arrays)
    monkeypatch.setattr(p_cache, "hardware_fingerprint", lambda: "cpu")
    again = tune_schedule(spec, cache=cache, measure_with=arrays)
    assert (cache.hits, cache.misses) == (1, 1)
    assert first.levels == again.levels
    tune_schedule(spec, cache=cache)
    assert (cache.hits, cache.misses) == (1, 2)


def test_search_gemm_plans_then_dense_serves_the_winner(tmp_path,
                                                        monkeypatch):
    from repro_torch.codegen.cache import schedule_to_dict

    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    db = P.default_plan_db()
    n = P.search_gemm_plans([(128, 128, 128)], dtype=torch.float32,
                            beam_width=4, topk=2, plan_db=db,
                            with_grads=True)
    assert n == 3
    spec = PE.matmul_spec(128, 128, 128)
    res = P.search_schedule(spec, dtype=torch.float32, plan_db=db)
    hits = db.lookup_hits
    x = torch.randn(128, 128, requires_grad=True)
    w = torch.randn(128, 128, requires_grad=True)
    out = ops.dense(x, w, interpret=True)
    out.sum().backward()
    assert db.lookup_hits >= hits + 3  # forward, dA and dB ladders
    kern = ops._tuned_kernel(spec, torch.float32, interpret=True)
    assert schedule_to_dict(kern.schedule) == schedule_to_dict(
        res.best.schedule)
    torch.testing.assert_close(out, x @ w, rtol=1e-5, atol=1e-4)


def test_serve_search_gemms_writes_phase_ladders(tmp_path, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setattr(p_cache, "hardware_fingerprint", lambda: GOLDEN_HW)
    cfg = get_config("qwen3-8b").smoke()
    d, f = cfg.d_model, cfg.d_ff
    shapes = ((16, d, d), (16, d, f))
    flags = ["--smoke", "--device", "cpu", "--requests", "2",
             "--prompt-len", "8", "--max-new", "3", "--lanes", "2",
             "--search-gemms", ";".join(",".join(map(str, s))
                                        for s in shapes),
             "--warm-gemms", f"16,{d},{d}"]
    stats, _, engine = serve.main(flags)
    assert stats["tokens"] > 0
    # CPU tensors run the plain versions: no launch, no plan to apply
    assert (stats["card_plans_applied"], stats["card_plans_skipped"]) == (
        0, 0)
    with open(tmp_path / "plans.json") as f:
        written = json.load(f)
    bf16 = np.dtype("bfloat16")
    want = set()
    for m, k, n in shapes:
        r = RE.matmul_spec(m, k, n)
        want.add(r_plan_key(r, bf16, hardware=GOLDEN_HW, phase="prefill"))
        for dspec in r_derived(r).values():
            want.add(r_plan_key(dspec, bf16, hardware=GOLDEN_HW,
                                phase="prefill"))
        want.add(r_plan_key(RE.matmul_spec(2, k, n), bf16,
                            hardware=GOLDEN_HW, phase="decode"))
    assert want <= set(written)
    assert {v["phase"] for k, v in written.items() if k in want} == {
        "prefill", "decode"}
    assert all(written[k]["ranked"][0]["measured_s"] is not None
               for k in want)
    # a restart finds every ladder and measures nothing
    db = P.default_plan_db()
    hits = db.lookup_hits
    from repro_torch import obs

    obs.metrics_reset()
    serve.main(flags + ["--no-search-grads"])
    assert db.lookup_hits >= hits + 2 * len(shapes)
    assert obs.metrics_json()["counters"].get("search.measured", 0) == 0
