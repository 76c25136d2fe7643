"""Elastic restore across meshes: checkpoints are layout-free, and
``checkpoint.restore(shardings=, mesh=)`` places every leaf on whatever
mesh the world now has.

* A DTensor tree saved on a 2x2 mesh of gloo ranks (gathered, written by
  rank 0) restores under 1x2, under 4x1 and into one process without
  shardings, every parameter leaf bit for bit, each rank holding the
  shard the new mesh's rules give it.
* Under 1x2, a fault loop whose step raises ``StepFailure`` restores the
  checkpoint and replays: the step's loss equals the uninterrupted 2x2
  run's at the f32 TOL.
* ``launch.train.train`` on a mesh resumes another mesh's checkpoint:
  2 steps on 2x2, then 1 more on 1x2, the losses of 3 uninterrupted 2x2
  steps.
* ``restore(shardings=)`` in a world of one equals the reference's
  ``restore(shardings=)`` under a forced device, leaf for leaf.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.api import get_api
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw as optim

import _sharded_ranks as R

TOL = 2e-4


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    ckpt_dir = str(root / "ckpt")
    ranks = spawn_ranks(R.elastic_save, 4, (ckpt_dir, 3), store_dir=str(root),
                        threads=1, timeout_s=300)
    return str(root), ckpt_dir, ranks


@pytest.fixture(scope="module")
def on_1x2(saved):
    root, ckpt_dir, _ = saved
    return spawn_ranks(R.elastic_restore, 2, (ckpt_dir, (1, 2), True),
                       store_dir=root, threads=1, timeout_s=300)


@pytest.fixture(scope="module")
def on_4x1(saved):
    root, ckpt_dir, _ = saved
    return spawn_ranks(R.elastic_restore, 4, (ckpt_dir, (4, 1), False),
                       store_dir=root, threads=1, timeout_s=300)


def test_every_rank_saved_the_same_leaves(saved):
    _, _, ranks = saved
    for out in ranks[1:]:
        assert out["saved"] == ranks[0]["saved"]
        assert out["losses"] == ranks[0]["losses"]


@pytest.mark.parametrize("world", ["1x2", "4x1"])
def test_restore_on_another_mesh_is_bit_for_bit(saved, on_1x2, on_4x1,
                                                world):
    _, _, ranks = saved
    got = on_1x2 if world == "1x2" else on_4x1
    for out in got:
        assert out["start"] == 2
        assert out["restored"] == ranks[0]["saved"]


def test_restored_shards_follow_the_new_mesh(on_1x2, on_4x1):
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import param_shardings

    cfg = get_config("qwen3-8b").smoke()
    api = get_api(cfg)
    for got, shape in ((on_1x2, (1, 2)), (on_4x1, (4, 1))):
        mesh = MeshShape(shape, ("data", "model"))
        shapes, _, specs = param_shardings(mesh, cfg, api)
        for path, leaf in optim.leaves(shapes):
            want = list(leaf.shape)
            for d, entry in enumerate(optim.at_path(specs, path).spec):
                for ax in ((entry,) if isinstance(entry, str)
                           else entry or ()):
                    want[d] //= mesh.shape[ax]
            assert list(got[0]["local_shapes"]["/".join(path)]) == want


def test_restore_without_shardings_is_bit_for_bit(saved):
    _, ckpt_dir, ranks = saved
    cfg = get_config("qwen3-8b").smoke()
    like = get_api(cfg).init(cfg, torch.Generator().manual_seed(1), "cpu")
    template = (like, optim.init(like, AdamWConfig(lr=1e-2)))
    (params, _), manifest = ckpt.restore(ckpt_dir, template, step=2)
    assert manifest["step"] == 2
    got = {"/".join(p): t.view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.uint8).numpy().tobytes()
           for p, t in optim.leaves(params)}
    assert got == ranks[0]["saved"]


def test_a_step_failure_on_the_new_mesh_restores_and_replays(saved, on_1x2):
    _, _, ranks = saved
    want = ranks[0]["losses"][2]
    for out in on_1x2:
        assert out["failures"] == 1 and out["restores"] == 1
        np.testing.assert_allclose(out["losses"][2], want, rtol=TOL,
                                   atol=TOL)


def test_train_resumes_on_another_mesh(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    first = spawn_ranks(R.train_cli, 4, (ckpt_dir, (2, 2), 2),
                        store_dir=str(tmp_path), threads=1, timeout_s=300)
    resumed = spawn_ranks(R.train_cli, 2, (ckpt_dir, (1, 2), 3),
                          store_dir=str(tmp_path), threads=1, timeout_s=300)
    whole = spawn_ranks(R.train_cli, 4, (None, (2, 2), 3),
                        store_dir=str(tmp_path), threads=1, timeout_s=300)
    got = first[0]["losses"] + resumed[0]["losses"]
    # the 2-step run's warm-up cosine agrees with the 3-step run's on its
    # two steps, and the resumed run takes the 3-step schedule's third
    assert len(resumed[0]["losses"]) == 1
    np.testing.assert_allclose(got, whole[0]["losses"], rtol=TOL, atol=TOL)


REF_RESTORE = """
import json
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import checkpoint as rc
from repro.launch.mesh import make_debug_mesh

flat = dict(np.load(__ARRAYS__))
mesh = make_debug_mesh((1, 1), ("data", "model"))
template = {k: np.zeros(v.shape, v.dtype) for k, v in flat.items()}
shardings = {k: NamedSharding(mesh, P()) for k in flat}
tree, manifest = rc.restore(__DIR__, template, shardings=shardings)
print("JSON" + json.dumps({k: np.asarray(v, np.float64).tolist()
                           for k, v in tree.items()}))
"""


def test_world_of_one_restore_equals_the_references(tmp_path):
    from conftest import run_forced_devices
    from test_torch_mesh_launch import _json_line

    rng = np.random.default_rng(3)
    tree = {"a": torch.tensor(rng.standard_normal((4, 6)).astype(np.float32)),
            "b": torch.tensor(rng.standard_normal(5).astype(np.float32))}
    ckpt_dir = str(tmp_path / "ck")
    ckpt.save(ckpt_dir, 1, tree)
    arrays = str(tmp_path / "arrays.npz")
    np.savez(arrays, **{k: v.numpy() for k, v in tree.items()})
    ref = _json_line(run_forced_devices(
        REF_RESTORE.replace("__ARRAYS__", repr(arrays)).replace(
            "__DIR__", repr(ckpt_dir)), devices=1, timeout=300))
    got = spawn_ranks(R.restore_world_of_one, 1, (ckpt_dir,),
                      store_dir=str(tmp_path), threads=1, timeout_s=120)[0]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
