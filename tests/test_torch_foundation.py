"""The port's framework-free layers equal the reference's.

On a seeded matrix of specs (matmul, transposed, batched, tensor
contraction, weighted, chain) and legal block choices, the port and the
reference must produce identical ``default_schedule`` levels,
``build_plan`` AxisPlans, ``tune_schedule`` winners, ``cache_key`` strings
and ``plan_key`` strings (hardware pinned to ``golden/fixture-hw`` as the
golden tests do).  Both committed golden files in ``tests/data/`` must read
back through the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import jax  # noqa: F401  (registers numpy's bfloat16 / float8 dtypes)
import numpy as np
import pytest
import torch

import repro.codegen.cache as ref_cache
import repro.core.enumerate as RE
import repro_torch.codegen.cache as port_cache
import repro_torch.core.enumerate as PE
from repro.codegen import build_plan as ref_build_plan
from repro.codegen import default_schedule as ref_default_schedule
from repro.codegen.tune import tune_schedule as ref_tune
from repro.core.cost import TPU as REF_TPU
from repro.search.plandb import plan_key as ref_plan_key
from repro_torch.codegen import build_plan as port_build_plan
from repro_torch.codegen import default_schedule as port_default_schedule
from repro_torch.codegen.tune import TUNER_VERSION
from repro_torch.codegen.tune import tune_schedule as port_tune
from repro_torch.core.cost import TPU as PORT_TPU
from repro_torch.search import PlanDB
from repro_torch.search.plandb import plan_key as port_plan_key

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_HW = "golden/fixture-hw"

#: family -> (ctor name, arity, seed offset); offsets keep streams disjoint
FAMILIES = {
    "matmul": ("matmul_spec", 3, 100),
    "transposed_matmul": ("transposed_matmul_spec", 3, 200),
    "batched_matmul": ("batched_matmul_spec", 4, 300),
    "tensor_contraction": ("tensor_contraction_spec", 5, 400),
    "weighted_matmul": ("weighted_matmul_spec", 3, 500),
    "chain_matmul": ("chain_matmul_spec", 4, 600),
}
SEEDS = range(4)
CASES = [(fam, seed) for fam in FAMILIES for seed in SEEDS]
EXTENT_POOL = (2, 4, 6, 8, 12)


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def _draw(family: str, seed: int):
    """(reference spec, port spec, blocks) from one seeded stream."""
    ctor, arity, offset = FAMILIES[family]
    rng = np.random.default_rng(offset + seed)
    extents = [int(rng.choice(EXTENT_POOL)) for _ in range(arity)]
    ref = getattr(RE, ctor)(*extents)
    port = getattr(PE, ctor)(*extents)
    blocks = {i: int(rng.choice(_divisors(ref.extents[i])))
              for i in ref.indices}
    return ref, port, blocks


def to_port_spec(spec):
    """The port's spec with the same identity as a reference spec."""
    root = spec.root()
    base = dict(name=root.name, operands=dict(root.operands),
                output=tuple(root.output), extents=dict(root.extents),
                reducer=root.reducer)
    if root.quant is not None:
        q = root.quant
        base["quant"] = PE.QuantMeta(q.dtype, q.accum, q.scale)
    kind = getattr(root, "fused_kind", "")
    if kind == "attention":
        return PE.AttentionSpec(**base, causal=root.causal)
    if kind == "grouped_matmul":
        return PE.GroupedSpec(**base, group_sizes=tuple(root.group_sizes))
    return PE.ContractionSpec(**base)


@pytest.mark.parametrize("family,seed", CASES)
def test_default_schedule_and_plan_match(family, seed):
    ref, port, blocks = _draw(family, seed)
    rs = ref_default_schedule(ref, blocks)
    ps = port_default_schedule(port, blocks)
    assert [dataclasses.astuple(l) for l in ps.levels] == [
        dataclasses.astuple(l) for l in rs.levels
    ]
    assert ps.spec.split_chain() == rs.spec.split_chain()
    assert port_cache.schedule_to_dict(ps) == ref_cache.schedule_to_dict(rs)
    rp, pp = ref_build_plan(rs), port_build_plan(ps)
    assert pp.grid == rp.grid and pp.seq == rp.seq
    assert {k: dataclasses.asdict(v) for k, v in pp.axes.items()} == {
        k: dataclasses.asdict(v) for k, v in rp.axes.items()
    }


def test_tpu_model_is_the_references():
    assert PORT_TPU == REF_TPU


#: shapes for the tuner: the serving GEMMs, the golden points, small ones
TUNE_POINTS = [
    ("matmul_spec", (512, 4096, 12288), "bfloat16"),
    ("matmul_spec", (128, 12288, 4096), "bfloat16"),
    ("matmul_spec", (2048, 4096, 4096), "float32"),
    ("chain_matmul_spec", (1024, 2048, 2048, 1024), "float32"),
    ("batched_matmul_spec", (4, 64, 128, 256), "float32"),
    ("transposed_matmul_spec", (256, 512, 128), "bfloat16"),
    ("weighted_matmul_spec", (128, 256, 64), "float32"),
]


@pytest.mark.parametrize(
    "ctor,args,dtype", TUNE_POINTS,
    ids=[f"{c}{a}-{d}" for c, a, d in TUNE_POINTS],
)
def test_tune_schedule_winner_matches(tmp_path, monkeypatch, ctor, args,
                                      dtype):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    ref = ref_tune(getattr(RE, ctor)(*args), dtype=np.dtype(dtype))
    port = port_tune(getattr(PE, ctor)(*args), dtype=getattr(torch, dtype))
    assert port_cache.schedule_to_dict(port) == ref_cache.schedule_to_dict(ref)
    # and the port's entry hits on the second call
    cache = port_cache.default_cache()
    hits = cache.hits
    port_tune(getattr(PE, ctor)(*args), dtype=getattr(torch, dtype))
    assert cache.hits == hits + 1


@pytest.mark.parametrize("family,seed", CASES)
def test_cache_and_plan_keys_match(family, seed):
    ref, port, _ = _draw(family, seed)
    extra = {"tuner": TUNER_VERSION, "keep": 3, "measured": False,
             "hw": sorted((k, v) for k, v in REF_TPU.items()
                          if isinstance(v, (int, float)))}
    for np_dt, t_dt in ((np.dtype(np.float32), torch.float32),
                        (np.dtype("bfloat16"), torch.bfloat16)):
        assert port_cache.cache_key(
            port, dtype=t_dt, hardware=GOLDEN_HW, extra=extra
        ) == ref_cache.cache_key(
            ref, dtype=np_dt, hardware=GOLDEN_HW, extra=extra
        )
        for kw in ({}, {"phase": "prefill"}, {"phase": "decode"},
                   {"mesh": "2x4"}):
            assert port_plan_key(port, t_dt, GOLDEN_HW, **kw) == ref_plan_key(
                ref, np_dt, GOLDEN_HW, **kw
            )


def test_golden_autotune_cache_reads_back(tmp_path, monkeypatch):
    monkeypatch.setattr(port_cache, "hardware_fingerprint", lambda: GOLDEN_HW)
    path = tmp_path / "autotune.json"
    shutil.copy(os.path.join(DATA, "autotune_cache_golden.json"), path)
    with open(path) as f:
        stored = {json.dumps(v["schedule"], sort_keys=True)
                  for v in json.load(f).values()}
    cache = port_cache.AutotuneCache(str(path))
    points = [
        (PE.matmul_spec(2048, 4096, 4096), torch.float32),
        (PE.matmul_spec(2048, 4096, 4096), torch.bfloat16),
        (PE.chain_matmul_spec(1024, 2048, 2048, 1024), torch.float32),
    ]
    for spec, dt in points:
        sched = port_tune(spec, dtype=dt, cache=cache,
                          use_default_cache=False)
        assert json.dumps(port_cache.schedule_to_dict(sched),
                          sort_keys=True) in stored
    assert cache.hits == len(points) and cache.misses == 0


def _golden_plan_points():
    from repro.grad import derived_specs

    fwd = RE.matmul_spec(512, 512, 512)
    d = derived_specs(fwd)
    attn = RE.attention_spec(4, 64, 64, 8)
    da = derived_specs(attn)
    grp = RE.uniform_grouped_spec(4, 16, 32, 32)
    dg = derived_specs(grp)
    f32 = np.dtype(np.float32)
    return [
        (fwd, f32, None), (fwd, np.dtype("bfloat16"), None),
        (d["A"], f32, None), (d["B"], f32, None),
        (fwd, f32, "2x4"), (d["A"], f32, "2x4"),
        (attn, f32, None),
        (da["Q"], f32, None), (da["K"], f32, None), (da["V"], f32, None),
        (grp, f32, None), (dg["X"], f32, None), (dg["W"], f32, None),
        (RE.quantize_spec(fwd, fmt="int8"), np.dtype(np.int8), None),
        (RE.quantize_spec(fwd, fmt="fp8"), np.dtype("float8_e4m3fn"), None),
    ]


def test_golden_plan_db_resolves(tmp_path, monkeypatch):
    monkeypatch.setattr(port_cache, "hardware_fingerprint", lambda: GOLDEN_HW)
    path = tmp_path / "plans.json"
    shutil.copy(os.path.join(DATA, "plan_db_golden.json"), path)
    with open(path) as f:
        data = json.load(f)
    db = PlanDB(str(path))
    points = _golden_plan_points()
    assert len(points) == len(data)
    for spec, dtype, mesh in points:
        port_spec = to_port_spec(spec)
        key = port_plan_key(port_spec, dtype, GOLDEN_HW, mesh=mesh)
        assert key in data, spec.name
        sched = db.best_schedule(port_spec, dtype, mesh=mesh)
        assert sched is not None, spec.name
        assert port_cache.schedule_to_dict(sched) == (
            data[key]["ranked"][0]["schedule"]
        )
    # torch dtypes name the same keys as numpy's
    fwd = PE.matmul_spec(512, 512, 512)
    assert port_plan_key(fwd, torch.bfloat16, GOLDEN_HW) in data
    assert port_plan_key(
        PE.quantize_spec(fwd, fmt="int8"), torch.int8, GOLDEN_HW
    ) in data


# --------------------------------------------------------------------------
# plan-DB lookup order in ops._tuned_kernel (the reference's cases)
# --------------------------------------------------------------------------


def test_plandb_phase_ladders_are_separate(tmp_path):
    spec = PE.matmul_spec(128, 128, 128)
    db = PlanDB(str(tmp_path / "plans.json"))
    entry = {"schedule": port_cache.schedule_to_dict(
        port_default_schedule(spec))}
    db.put(spec, torch.float32, [entry], phase="decode")
    assert db.best_schedule(spec, torch.float32) is None
    assert db.best_schedule(spec, torch.float32, phase="prefill") is None
    assert db.best_schedule(spec, torch.float32, phase="decode") is not None


def test_tuned_kernel_consults_active_phase_first(tmp_path, monkeypatch):
    import repro_torch.ops as port_ops
    from repro_torch.search import active_phase, serving_phase

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    lookups = []

    class Recording:
        # ops reads the winning rung with its schedule (its ``card`` plan)
        def best_entry(self, spec, dtype, phase=None):
            lookups.append(phase)
            return None, {}                  # force the tuner fallback

    monkeypatch.setattr(port_ops, "default_plan_db", lambda: Recording())
    spec = PE.matmul_spec(128, 128, 128)
    with serving_phase("decode"):
        assert active_phase() == "decode"
        port_ops._tuned_kernel(spec, torch.float32, interpret=True)
    assert active_phase() is None
    assert lookups == ["decode", None]
    lookups.clear()
    port_ops._tuned_kernel(spec, torch.float32, interpret=True)
    assert lookups == [None]


def test_warm_dense_cache_fills_the_tuner_cache(tmp_path, monkeypatch):
    from repro_torch.ops import warm_dense_cache

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    assert warm_dense_cache([(128, 256, 128), (256, 128, 512)]) == 2
    cache = port_cache.default_cache()
    hits = cache.hits
    port_tune(PE.matmul_spec(128, 256, 128), dtype=torch.bfloat16)
    assert cache.hits == hits + 1
