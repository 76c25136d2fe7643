"""The pod and multi-pod dry-run, ``perf``'s sharding knobs, the
collective recorder and capture on a mesh.

In-process, each in a ``launch.mesh.fake_world`` (torn down after):

* ``dryrun.run_cell(mesh="pod" | "multipod")`` of a stand-in whose
  extents the 16-wide axes divide: per-device flops x chips equal the
  one-card record's within 1 %, per-device memory is a fraction of it,
  the tags are the reference's ``__sp`` / ``__mp``;
* the collective recorder on one op worked out by hand: a product whose
  contracted index is sharded over ``data`` leaves a ``Partial`` sum,
  and gathering it is one all-reduce of the output's local bytes;
* the four knobs change the record as the reference intends, and each
  variable is restored: ``zero1`` keeps parameters off ``data`` and
  takes int8 moments (less argument memory), ``dp`` shards no weight over
  ``model`` and the batch over both axes, ``moe_constraint`` replaces
  the gathered tokens by all-to-alls of the dispatched slots (fewer
  all-gather bytes), ``unembed`` takes ``data`` off the unembedding;
* ``analysis.analyze_cell`` of a pod record has a non-zero collective
  term.

On gloo ranks: ``capture.sweep_captured(mesh_shape="1x2")`` on 2 ranks
persists the mesh-qualified ladders of the plain points under the
reference's keys and none for the fused one; ``serve --capture --mesh
1x2 --smoke`` gives the tokens of uncaptured ``serve --mesh 1x2`` and of
the reference's engine on the same weights.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, perf
from repro_torch.launch.mesh import (MeshShape, fake_world, make_debug_mesh,
                                     spawn_ranks)
from repro_torch.roofline.analysis import analyze_cell

import _mesh_ranks as MR
import _sharded_ranks as R

#: a stand-in qwen3-8b whose extents 16 and 32 ranks divide, no remat
DENSE = dict(n_layers=1, d_model=256, n_heads=16, n_kv_heads=16, head_dim=16,
             d_ff=512, vocab=512, remat=False)
TRAIN = ShapeConfig("train_4k", 32, 32, "train")


def _dense():
    return dataclasses.replace(get_config("qwen3-8b").smoke(), **DENSE)


def _moe():
    base = get_config("kimi-k2-1t-a32b").smoke()
    return dataclasses.replace(
        base, n_layers=2, d_model=256, n_heads=16, n_kv_heads=16,
        head_dim=16, d_ff=512, vocab=512, remat=False,
        moe=dataclasses.replace(base.moe, n_experts=32, expert_ff=128,
                                dense_ff=512, shared_expert_ff=128))


@pytest.fixture(scope="module")
def one():
    return dryrun.run_cell("qwen3-8b", "train_4k", device="cpu",
                           cfg=_dense(), shape=TRAIN)


@pytest.mark.parametrize("mesh,desc,chips", [("pod", "16x16", 256),
                                              ("multipod", "2x16x16", 512)])
def test_pod_records_per_device(one, mesh, desc, chips):
    rec = dryrun.run_cell("qwen3-8b", "train_4k", device="cpu", cfg=_dense(),
                          shape=TRAIN, mesh=mesh)
    assert rec["status"] == "ok", rec
    assert (rec["mesh"], rec["chips"], rec["hw"]) == (desc, chips, "h100")
    assert rec["flops"] == rec["parsed"]["dot_flops"] > 0
    np.testing.assert_allclose(rec["flops"] * chips, one["flops"],
                               rtol=1e-2)
    assert rec["memory"]["argument_size_in_bytes"] < \
        one["memory"]["argument_size_in_bytes"] / 64
    colls = rec["collectives"]
    assert set(colls) == set(dryrun.COLLECTIVES) | {"count"}
    assert colls["count"] > 0 and colls["all-gather"] > 0
    assert rec["parsed"]["collective_bytes"] == sum(
        colls[k] for k in dryrun.COLLECTIVES)


def test_pod_tags_are_the_references(tmp_path, monkeypatch):
    real = dryrun.run_cell

    def small(arch, shape, device="cuda", mesh="1"):
        return real(arch, shape, device=device, cfg=_dense(), shape=TRAIN,
                    mesh=mesh)

    monkeypatch.setattr(dryrun, "run_cell", small)
    out = str(tmp_path / "r")
    dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--mesh",
                 "both", "--out", out, "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["qwen3-8b__train_4k__mp.json",
                                       "qwen3-8b__train_4k__sp.json"]


def test_recorder_bytes_worked_out_by_hand():
    """x (16, 32) and w (32, 24) f32, both sharded on their contracted
    index over ``data`` (x dim 1, w dim 0), replicated over ``model``: the
    rule's cheapest layout is theirs, a ``Partial`` output with no
    collective; gathering it is one all-reduce whose output is the
    (16, 24) f32 block, 1536 bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import ops

    with fake_world(4):
        dm = make_debug_mesh((2, 2), ("data", "model")).device_mesh
        x = distribute_tensor(torch.ones(16, 32), dm, [Shard(1), Replicate()])
        w = distribute_tensor(torch.ones(32, 24), dm, [Shard(0), Replicate()])
        holder = {}
        fwd = dryrun.collective_bytes(
            lambda: holder.update(y=ops.dense(x, w, differentiable=False)))
        y = holder["y"]
        assert y.placements[0].is_partial() and y.placements[1].is_replicate()
        gathered = dryrun.collective_bytes(y.full_tensor)
    zero = {k: 0 for k in dryrun.COLLECTIVES}
    assert fwd == dict(zero, count=0)
    assert gathered == dict(zero, **{"all-reduce": 16 * 24 * 4, "count": 1})


def _pod(tmp_path, cfg, arch="qwen3-8b"):
    base_dir = str(tmp_path / "results")
    os.makedirs(base_dir, exist_ok=True)
    base = dryrun.run_cell(arch, "train_4k", device="cpu", cfg=cfg,
                           shape=TRAIN, mesh="pod")
    with open(os.path.join(base_dir, f"{arch}__train_4k__sp.json"), "w") as f:
        json.dump(base, f)
    kw = dict(device="cpu", out=str(tmp_path / "perf"), baseline_dir=base_dir,
              cfg=cfg, shape_cfg=TRAIN, mesh="pod")
    return base, kw


def _record(tmp_path, arch, knob):
    path = os.path.join(str(tmp_path / "perf"),
                        f"{arch}__train_4k__sp__{knob}.json")
    with open(path) as f:
        return json.load(f)


KNOB_VARS = ("REPRO_SHARDING", "REPRO_OPT_INT8", "REPRO_MOE_CONSTRAINT",
             "REPRO_UNEMBED_FIX")


def _specs(profile, cfg, **env):
    """Each parameter leaf's ``PartitionSpec`` entries on the pod mesh
    under ``profile`` (and ``env``)."""
    from repro_torch.launch.steps import param_shardings
    from repro_torch.models.api import get_api
    from repro_torch.optim import adamw as optim

    saved = {k: os.environ.get(k) for k in ("REPRO_SHARDING", *env)}
    os.environ["REPRO_SHARDING"] = profile
    os.environ.update(env)
    try:
        _, _, sh = param_shardings(MeshShape((16, 16), ("data", "model")),
                                   cfg, get_api(cfg))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"/".join(p): t.spec for p, t in optim.leaves(sh)}


def test_knobs_change_the_record_as_intended(tmp_path):
    cfg = _dense()
    base, kw = _pod(tmp_path, cfg)
    rows = {k: perf.run("qwen3-8b", "train_4k", [k], **kw)
            for k in ("dp", "zero1", "unembed")}
    for k, row in rows.items():
        assert row["status"] == "ok" and "vs_baseline" in row, k
        assert all(os.environ.get(v) is None for v in KNOB_VARS), k
    # zero1: parameters off ``data`` (but vocab), int8 moments: less
    # argument memory than the same profile's f32 moments
    zero1 = _specs("zero1", cfg)
    assert not any("data" in str(e) for path, spec in zero1.items()
                   if "embedding" not in path for e in spec)
    os.environ["REPRO_SHARDING"] = "zero1"
    try:
        f32 = dryrun.run_cell("qwen3-8b", "train_4k", device="cpu", cfg=cfg,
                              shape=TRAIN, mesh="pod")
    finally:
        os.environ.pop("REPRO_SHARDING")
    assert _record(tmp_path, "qwen3-8b", "zero1")["memory"][
        "argument_size_in_bytes"] < f32["memory"]["argument_size_in_bytes"]
    # dp: no weight over ``model`` but the vocab, the batch on both axes
    dp = _specs("dp", cfg)
    assert not any("model" in str(e) for path, spec in dp.items()
                   if "embedding" not in path for e in spec)
    assert _record(tmp_path, "qwen3-8b", "dp")["collectives"] != \
        base["collectives"]
    # unembed: the unembedding over vocab only
    assert "data" not in str(_specs("tp", cfg, REPRO_UNEMBED_FIX="1")[
        "embedding/unembed"])
    assert "data" in str(_specs("tp", cfg)["embedding/unembed"])
    assert rows["unembed"]["vs_baseline"]["collective_s"][0] != \
        rows["unembed"]["vs_baseline"]["collective_s"][1]


def test_moe_constraint_replaces_the_token_gather(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_MOE_GROUPED", "1")
    base, kw = _pod(tmp_path, _moe(), arch="kimi-k2-1t-a32b")
    row = perf.run("kimi-k2-1t-a32b", "train_4k", ["moe_constraint"], **kw)
    assert row["status"] == "ok"
    assert os.environ.get("REPRO_MOE_CONSTRAINT") is None
    got = _record(tmp_path, "kimi-k2-1t-a32b", "moe_constraint")
    # the dispatched slots go to their experts' ranks by all-to-alls, in
    # place of gathering every token on every rank
    assert base["collectives"]["all-to-all"] == 0
    assert got["collectives"]["all-to-all"] > 0
    assert got["collectives"]["all-gather"] < base["collectives"]["all-gather"]


def test_analysis_counts_a_collective_term():
    rec = dryrun.run_cell("qwen3-8b", "train_4k", device="cpu", cfg=_dense(),
                          shape=TRAIN, mesh="pod")
    row = analyze_cell(rec)
    assert row["collective_s"] > 0
    assert row["collective_bytes"] == rec["parsed"]["collective_bytes"]


# -- capture on a mesh ---------------------------------------------------------


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return str(tmp_path_factory.mktemp("capture_mesh"))


def test_sweep_captured_on_a_mesh_persists_mesh_ladders(store):
    got = spawn_ranks(R.sweep_captured_mesh, 2, (f"{store}/plans.json",),
                      store_dir=store, threads=1, timeout_s=300)
    for out in got:
        assert out["n"] == 5  # 2 plain points x 2 tiers + the fused one
        found = out["found"]
        assert found["train:a@None"] and found["train:a@1x2"]
        assert found["train:b@None"] and found["train:b@1x2"]
        assert found["prefill:attention@None"]
        assert not found["prefill:attention@1x2"]
    # the mesh-qualified key is the reference's
    from repro.core.enumerate import matmul_spec as ref_matmul_spec
    from repro.search.plandb import plan_key as ref_plan_key
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.search.plandb import plan_key

    assert plan_key(matmul_spec(16, 32, 32), torch.float32, hardware="cpu",
                    mesh="1x2") == ref_plan_key(
        ref_matmul_spec(16, 32, 32), np.dtype("float32"), hardware="cpu",
        mesh="1x2")


def test_serve_capture_on_a_mesh_serves_the_references_tokens(store):
    from conftest import run_forced_devices
    from test_torch_mesh_launch import REF_SERVE, SERVE_FLAGS, _json_line

    path = f"{store}/qwen3_params.npz"
    ref = _json_line(run_forced_devices(
        REF_SERVE.replace("__PATH__", repr(path)), devices=2, timeout=900))
    flags = SERVE_FLAGS + ["--mesh", "1x2", "--no-search-grads"]
    captured = spawn_ranks(
        MR.serve_reference_weights, 2,
        (f"{store}/serve_captured.json", path, flags + ["--capture"]),
        store_dir=store, threads=1, timeout_s=600)
    plain = spawn_ranks(
        MR.serve_reference_weights, 2,
        (f"{store}/serve_plain.json", path, flags),
        store_dir=store, threads=1, timeout_s=600)
    for c, p in zip(captured, plain):
        assert c["meshed"] and p["meshed"]
        assert c["tokens"] == p["tokens"]
        assert {str(k): v for k, v in c["tokens"].items()} == ref
