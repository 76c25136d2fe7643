"""The port's collectives (``codegen.collectives``), ``optim.compress`` and
``launch.pipeline`` on 8 gloo ranks of the CPU, against their oracles and
the reference's outputs.

One world of 8 spawned ranks (``launch.mesh.spawn_ranks``, a
``FileStore`` under ``tmp_path``) runs every case (``_mesh_ranks
.collectives``):

* for p in {1, 2, 4, 8} (a (8 / p) x p mesh, the collectives over its
  p-rank axis): ``ring_psum`` == ``all_reduce`` (psum and ring) == the sum
  oracle, payloads with a remainder chunk and the p == 1 cut path among
  them, and ``ring_gather_matmul`` == ``naive_gather_matmul`` == x @ w, at
  the reference's rtol 1e-4 / atol 1e-5 (``tests/test_launch.py``);
* ``hierarchical_psum`` on (pod 2, data 4) within 0.02 relative of the
  exact sum and equal to the reference's output (8 forced devices) at the
  f32 TOL;
* a 4-stage ``pipeline_apply`` equal to the sequential stack at 1e-5 and
  to the reference's output.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro_torch.launch.mesh import spawn_ranks

import _mesh_ranks as R

RTOL, ATOL = 1e-4, 1e-5

REF_CODE = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_debug_mesh
from repro.launch.pipeline import pipeline_apply
from repro.optim.compress import hierarchical_psum

mesh = make_debug_mesh((2, 4), ("pod", "data"))
x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 64)),
                jnp.float32)
g = shard_map(lambda xs: hierarchical_psum(xs, pod_axis="pod",
                                           inner_axis="data", compress=True),
              mesh=mesh, in_specs=P(("pod", "data")), out_specs=P(),
              check_rep=False)
hier = np.asarray(g(x))

mesh = make_debug_mesh((4,), ("pipe",))
rng = np.random.default_rng(0)
ws = jnp.asarray(rng.standard_normal((4, 8, 8)) * 0.5, jnp.float32)
xs = jnp.asarray(rng.standard_normal((6, 3, 8)), jnp.float32)
piped = shard_map(
    lambda w, mb: pipeline_apply(lambda a, v: jnp.tanh(v @ a), w, mb, "pipe"),
    mesh=mesh, in_specs=(P("pipe", None, None), P()), out_specs=P(),
    check_rep=False)
print("JSON" + json.dumps({"hier": hier.tolist(),
                           "pipe": np.asarray(piped(ws, xs)).tolist()}))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(R.collectives, 8, (100,), threads=1, timeout_s=240,
                       store_dir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def reference():
    from conftest import run_forced_devices

    out = run_forced_devices(REF_CODE, devices=8, timeout=600)
    line = next(ln for ln in out.splitlines() if ln.startswith("JSON"))
    return {k: np.asarray(v, np.float32)
            for k, v in json.loads(line[4:]).items()}


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_ring_collectives_match_the_oracles(ranks, p):
    checked = 0
    for rank, out in enumerate(ranks):
        for case in out["cases"]:
            if case["p"] != p:
                continue
            what = f"rank {rank} p={p}"
            for k in ("naive", "ring"):
                np.testing.assert_allclose(case[k], case["matmul_oracle"],
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{what} {k}")
            for k in ("psum", "ring_psum", "ring_all_reduce"):
                np.testing.assert_allclose(case[k], case["sum_oracle"],
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{what} {k}")
            # the collective leaves the caller's tensor as it was
            np.testing.assert_array_equal(case["mine_after"],
                                          case["mine_before"])
            checked += 1
    assert checked == 3 * 8


def test_every_rank_returns_the_same_result(ranks):
    for out in ranks[1:]:
        for a, b in zip(out["cases"], ranks[0]["cases"]):
            for k in ("ring", "naive", "ring_psum", "psum"):
                np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(out["hier"], ranks[0]["hier"])
        np.testing.assert_array_equal(out["pipe"], ranks[0]["pipe"])


def test_hierarchical_psum_against_the_exact_sum_and_the_reference(
        ranks, reference):
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    want = x.sum(0)
    got = ranks[0]["hier"]
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 0.02, rel
    np.testing.assert_allclose(ranks[0]["hier_exact"][0], want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.reshape(reference["hier"].shape),
                               reference["hier"], rtol=1e-4, atol=1e-4)


def test_pipeline_equals_the_sequential_stack_and_the_reference(
        ranks, reference):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((4, 8, 8)) * 0.5).astype(np.float32)
    xs = rng.standard_normal((6, 3, 8)).astype(np.float32)
    want = xs
    for s in range(4):
        want = np.tanh(want @ ws[s])
    np.testing.assert_allclose(ranks[0]["pipe"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["pipe"], reference["pipe"],
                               rtol=1e-5, atol=1e-5)
    assert abs(ranks[0]["bubble"] - 3 / 9) < 1e-9
