"""Train steps on DTensor-sharded parameters, on 2x2 meshes of gloo ranks
on the CPU.

* deepseek-7b smoke, its parameters placed by ``tree_shardings`` under
  the ``tp``, ``dp`` and ``zero1`` profiles (``launch.steps.shard_tree``):
  from the reference's weights, lr 1e-2, the first 3 losses equal the
  reference's under 4 forced devices (``tests/test_launch.py``'s case) at
  the f32 TOL and the port's replicated mesh step (every GEMM through the
  ops' sharding rules, every other op through DTensor); under ``tp`` the
  loss falls by more than 0.1 in 20 steps; every leaf's local shape is
  the one the reference's ``PartitionSpec`` implies on 2x2; the step's
  outputs keep the bundle's placements.
* kimi-k2 smoke with ``REPRO_MOE_GROUPED=1``, with and without
  ``REPRO_MOE_CONSTRAINT=1``: the first 3 losses equal the reference's
  under 4 forced devices with the same variables, B3 and B4 each through
  their rule.
* A prefill into DTensor caches and two decode steps give the plain
  steps' logits.
* The collective bytes a rank's recorder reads on one real 2x2 step of a
  one-layer stand-in equal the fake 2x2 world's dry-run of the same cell
  (``launch.dryrun.run_cell(mesh="2x2")``), kind for kind.
"""

from __future__ import annotations

import functools
import json
import math

import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.launch import sharding as RS
from repro.launch import steps as RSteps
from repro.models.api import get_api as ref_api
from repro_torch.launch.mesh import spawn_ranks

import _sharded_ranks as R
from test_torch_mesh_launch import REF_TRAIN, _json_line

TOL = 2e-4  # the f32 TOL of the reference's own loss comparisons

REF_MOE = REF_TRAIN.replace('get_config("deepseek-7b")',
                            'get_config("kimi-k2-1t-a32b")')
#: the same steps' losses, then each step's (grad_norm, clip_scale)
REF_DENSE = REF_TRAIN.replace(
    'print("JSON" + json.dumps(losses))',
    'print("JSON" + json.dumps([losses, [[float(m[k]) for k in '
    '("grad_norm", "clip_scale")] for m in metrics]]))').replace(
    "    losses = []\n", "    losses, metrics = [], []\n").replace(
    '        losses.append(float(m["loss"]))\n',
    '        losses.append(float(m["loss"]))\n        metrics.append(m)\n')
assert REF_DENSE.count("metrics") == 3


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_step"))


@pytest.fixture(scope="module")
def dense(store):
    from conftest import run_forced_devices

    path = f"{store}/deepseek_params.npz"
    ref = _json_line(run_forced_devices(
        REF_DENSE.replace("__PATH__", repr(path)), devices=4, timeout=900))
    ranks = spawn_ranks(R.sharded_train, 4, (path, 20), store_dir=store,
                        threads=1, timeout_s=600)
    return ref, ranks


@functools.lru_cache(maxsize=None)
def _ref_moe(store, constraint):
    from conftest import run_forced_devices

    path = f"{store}/kimi_params_{int(constraint)}.npz"
    env = {"REPRO_MOE_GROUPED": "1"}
    if constraint:
        env["REPRO_MOE_CONSTRAINT"] = "1"
    ref = _json_line(run_forced_devices(
        REF_MOE.replace("__PATH__", repr(path)), devices=4, timeout=900,
        env_extra=env))
    return path, ref


@pytest.mark.parametrize("profile", ["tp", "dp", "zero1"])
def test_sharded_losses_equal_the_reference(dense, profile):
    (ref, _), ranks = dense
    for out in ranks:
        losses = out[profile]["losses"]
        assert all(map(math.isfinite, losses)), losses
        np.testing.assert_allclose(losses[:3], ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(losses[:3], out["replicated"], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("profile", ["tp", "dp", "zero1"])
def test_sharded_grad_norm_equals_the_reference(dense, profile):
    """The global gradient norm and the clip scale of the first 3 steps
    equal the reference's (Adam cancels a steady gradient scale, so the
    losses alone cannot show a wrong clip)."""
    (_, ref), ranks = dense
    assert ref[0][1] < 1.0, ref  # the clip is active
    for out in ranks:
        np.testing.assert_allclose(out[profile]["norms"], ref, rtol=TOL,
                                   atol=TOL)


def test_the_loss_falls(dense):
    _, ranks = dense
    losses = ranks[0]["tp"]["losses"]
    assert len(losses) == 20
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


class _StandIn:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("profile", ["tp", "dp", "zero1"])
def test_local_shapes_are_the_references(dense, profile, monkeypatch):
    """Each rank's shard of each leaf has the shape the reference's
    ``PartitionSpec`` for that leaf implies on a 2x2 mesh."""
    monkeypatch.setenv("REPRO_SHARDING", profile)
    rc = ref_config("deepseek-7b").smoke()
    shapes, axes = RSteps.eval_params(rc, ref_api(rc))
    mesh = _StandIn((2, 2), ("data", "model"))
    shapes, axes = dict(_flat(shapes)), dict(_flat(axes))
    specs = {p: RS.spec_for(mesh, axes[p], tuple(s.shape))
             for p, s in shapes.items()}
    _, ranks = dense
    for out in ranks:
        got = out[profile]["local_shapes"]
        assert set(got) == {"/".join(p) for p in shapes}
        for path, shp in shapes.items():
            want = list(shp.shape)
            for d, entry in enumerate(specs[path]):
                for ax in ((entry,) if isinstance(entry, str)
                           else entry or ()):
                    want[d] //= mesh.shape[ax]
            assert list(got["/".join(path)]) == want, (profile, path)


@pytest.mark.parametrize("constraint", [False, True])
def test_sharded_moe_equals_the_reference(store, constraint):
    path, ref = _ref_moe(store, constraint)
    ranks = spawn_ranks(R.sharded_moe, 4, (path, constraint), store_dir=store,
                        threads=1, timeout_s=600)
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref, rtol=TOL, atol=TOL)
        # gate, up, down and their recompute, dX; and dW: each B3 / B4
        # call through its rule
        assert out["grouped"] > 0 and out["grouped_dw"] > 0


def test_recorded_bytes_equal_the_dry_run(store):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    got = spawn_ranks(R.recorded_step, 4, (), store_dir=store, threads=1,
                      timeout_s=300)
    seq, batch = R.RECORD_SHAPE
    rec = dryrun.run_cell("qwen3-8b", "train_4k", device="cpu",
                          cfg=R.record_cfg(),
                          shape=ShapeConfig("train", seq, batch, "train"),
                          mesh="2x2")
    assert rec["status"] == "ok", rec
    assert (rec["mesh"], rec["chips"]) == ("2x2", 4)
    assert got[0] == rec["collectives"], json.dumps([got[0],
                                                     rec["collectives"]])
    assert all(out == got[0] for out in got[1:])
    assert rec["collectives"]["count"] > 0


def test_sharded_prefill_and_decode_equal_the_plain_steps(store):
    """Serving on DTensors: a prefill into sharded caches and 2 decode
    steps give the plain steps' logits (f32 TOL, scaled)."""
    ranks = spawn_ranks(R.sharded_serving, 4, (), store_dir=store,
                        threads=1, timeout_s=300)
    for out in ranks:
        assert out["cache_sharded"]
        assert max(out["diffs"]) <= TOL * max(out["scale"], 1.0), out
