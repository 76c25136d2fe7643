"""``codegen.bind_mesh`` on gloo ranks of the CPU against the f64 einsum
oracle, ``core.interp`` and the reference's own ``MeshBoundKernel``.

The matrix of the reference's ``tests/test_mesh_search.py``: on each
conventional mesh (1x1, 1x2, 2x2, 2x4: one world of 1, 2, 4 and 8
spawned ranks), every legal mesh variant x collective of
``space.mesh_variants`` for three families, at seeded orders and
blockings (and the whole-extent schedule for matmul), lowered through
``codegen.cached_compile(mesh=)`` over ``search.mesh_for_schedules``:
f32 everywhere and bf16 on every third variant, at the reference's
tolerances, every rank returning the same full output.  A seeded subset
of the 2x2 cases is held against the reference's ``MeshBoundKernel``
output under 4 forced devices.  Also: an epilogue deferred behind a
sharded reduce (act(psum(partial) + bias)), a call on DTensors, and the
refusals (the fused families' exact message, a mesh without the plan's
axes, an unknown collective).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks

import _mesh_ranks as R

MESH_FOR_DEVICES = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4)}
#: the 2x2 cases held against the reference's kernel: (family, variant)
REF_SUBSET = [("matmul", vi) for vi in range(0, 18, 3)] + [
    ("weighted_matmul", 1), ("weighted_matmul", 4),
    ("transposed_matmul", 2), ("transposed_matmul", 5)]

REF_CODE = """
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.core.enumerate import (matmul_spec, transposed_matmul_spec,
                                  weighted_matmul_spec)
from repro.codegen import cached_compile
from repro.search import mesh_for_schedules, reference_arrays, schedule_mesh_axes
from repro.search.space import local_extents, make_candidate, mesh_variants

DEVICES, SHAPE = 4, (2, 2)
CTOR = {"matmul": (matmul_spec, (8, 4, 8), 1000),
        "weighted_matmul": (weighted_matmul_spec, (4, 8, 4), 3000),
        "transposed_matmul": (transposed_matmul_spec, (8, 8, 4), 5000)}
out = {}
for fam, vi in __SUBSET__:
    ctor, extents, offset = CTOR[fam]
    spec = ctor(*extents)
    v = mesh_variants(spec, SHAPE)[vi]
    rng = np.random.default_rng(offset + 37 * DEVICES + vi)
    loc = local_extents(spec, v.as_dict())
    order = list(spec.indices)
    rng.shuffle(order)
    blocks = {i: int(rng.choice([d for d in range(1, loc[i] + 1)
                                 if loc[i] % d == 0])) for i in spec.indices}
    sched = make_candidate(spec, tuple(order), blocks, mesh=v.as_dict(),
                           collective=v.collective).to_schedule()
    sharded = bool(schedule_mesh_axes(sched))
    mesh = mesh_for_schedules([sched]) if sharded else None
    kern = cached_compile(spec, sched, interpret=True, mesh=mesh,
                          collective=v.collective or "psum")
    arrays = reference_arrays(spec, dtype=np.float32, seed=offset + vi)
    got = kern(*(jnp.asarray(arrays[n]) for n in spec.operands))
    out[f"{fam}/{vi}"] = np.asarray(got, np.float64).tolist()
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("ranks"))
    out = {1: [R.bind_matrix(0, 1, MESH_FOR_DEVICES[1])]}
    for devices in (2, 4, 8):
        out[devices] = spawn_ranks(
            R.bind_matrix, devices, (devices, MESH_FOR_DEVICES[devices]),
            store_dir=store, threads=1, timeout_s=300)
    return out


@pytest.mark.parametrize("devices", sorted(MESH_FOR_DEVICES))
def test_mesh_schedule_differential_matrix(matrices, devices):
    ranks = matrices[devices]
    rows = ranks[0]
    for row in rows:
        what = (f"{row['fam']} devices={devices} variant={row['vi']} "
                f"case={row['ci']} dtype={row['dtype']} "
                f"mesh={row['assignment']} coll={row['collective']}")
        np.testing.assert_allclose(row["interp"], row["ref"], rtol=1e-4,
                                   atol=1e-4, err_msg=what)
        rtol, atol = R.TOL[row["dtype"]]
        np.testing.assert_allclose(row["got"], row["ref"], rtol=rtol,
                                   atol=atol, err_msg=what)
        assert row["bound"] == ("MeshBoundKernel" if row["sharded"]
                                else "CompiledKernel"), what
    for other in ranks[1:]:
        for a, b in zip(other, rows):
            np.testing.assert_array_equal(a["got"], b["got"])
    assert len(rows) >= (3 if devices == 1 else 12)
    if devices > 1:
        assert any(r["sharded"] and r["collective"] == "ring" for r in rows)
        assert any(r["sharded"] and r["dtype"] == "bfloat16" for r in rows)


def test_mesh_kernels_equal_the_references(matrices):
    from conftest import run_forced_devices

    out = run_forced_devices(REF_CODE.replace("__SUBSET__",
                                              repr(REF_SUBSET)),
                             devices=4, timeout=900)
    line = next(ln for ln in out.splitlines() if ln.startswith("JSON"))
    ref = json.loads(line[4:])
    port = {f"{r['fam']}/{r['vi']}": r["got"] for r in matrices[4][0]
            if r["ci"] == 0 and r["dtype"] == "float32"}
    assert set(ref) <= set(port)
    for key, want in ref.items():
        np.testing.assert_allclose(port[key], np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def epilogue_ranks(tmp_path_factory):
    return spawn_ranks(R.epilogue_and_dtensor, 2, threads=1, timeout_s=120,
                       store_dir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("coll", ["psum", "ring"])
def test_epilogue_is_deferred_behind_a_sharded_reduce(epilogue_ranks, coll):
    from repro_torch.codegen.epilogue import ACTIVATIONS

    gelu = ACTIVATIONS["gelu"]  # the reference's (tanh-approximated) gelu
    a, b, bias = epilogue_ranks[0]["inputs"]
    acc = a.astype(np.float64) @ b.astype(np.float64) + bias
    want = gelu(torch.tensor(acc)).numpy()
    for out in epilogue_ranks:
        np.testing.assert_allclose(out[coll], want, rtol=1e-4, atol=1e-4)
    # the wrong order, psum(act(partial + bias)), is far from it
    half = a.shape[1] // 2
    parts = [a[:, s:s + half].astype(np.float64)
             @ b[s:s + half].astype(np.float64) + bias for s in (0, half)]
    wrong = sum(gelu(torch.tensor(p)).numpy() for p in parts)
    assert np.abs(wrong - want).max() > 0.1


def test_a_dtensor_call_keeps_the_plan_placements(epilogue_ranks):
    a, b, _ = epilogue_ranks[0]["inputs"]
    for out in epilogue_ranks:
        d = out["dtensor"]
        assert d["is_dtensor"]
        assert d["placements"] == ["R", "S(1)"]  # Replicate(), Shard(1)
        assert d["local"] == (8, 4)
        np.testing.assert_allclose(d["full"], a @ b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["plain"], a @ b, rtol=1e-4,
                                   atol=1e-4)


def test_fused_families_refuse_a_mesh():
    from repro_torch import codegen
    from repro_torch.core.enumerate import attention_spec

    spec = attention_spec(2, 8, 8, 4, 4)
    sched = codegen.default_schedule(spec)
    with pytest.raises(NotImplementedError,
                       match="^fused families have no mesh tier yet$"):
        codegen.compile_fused(spec, sched, mesh=object())
    with pytest.raises(NotImplementedError,
                       match="^fused families have no mesh tier yet$"):
        codegen.compile(spec, sched, mesh=object())


def test_bind_mesh_refuses_meshes_the_plan_does_not_fit():
    from repro_torch import codegen
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.search.space import make_candidate

    spec = matmul_spec(8, 8, 8)
    sched = make_candidate(spec, spec.indices, {},
                           mesh={"j": ("model", 2)},
                           collective="psum").to_schedule()
    kern = codegen.compile(spec, sched)
    with pytest.raises(ValueError, match="lacks"):
        codegen.bind_mesh(kern, MeshShape((2,), ("data",)))
    with pytest.raises(ValueError, match="shards"):
        codegen.bind_mesh(kern, MeshShape((1, 4), ("data", "model")))
    with pytest.raises(ValueError, match="unknown collective"):
        codegen.bind_mesh(kern, MeshShape((1, 2), ("data", "model")),
                          collective="tree")
