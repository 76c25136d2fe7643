"""The mesh tier end to end on gloo ranks of the CPU: the search on a
mesh, ``ops.dense`` under it, training under a mesh and ``serve --mesh``.

* Acceptance (8 ranks, a 2x4 mesh; the port's counterpart of the
  reference's ``test_mesh_swept_model_serves_and_trains_sharded``):
  ``search_schedule_with_grads(matmul_spec(128, 128, 128),
  mesh_shape=(2, 4))`` gives sharded rungs for fwd, dA and dB, every rank
  the same ladders; under ``set_mesh`` ``ops._mesh_plan_kernel`` returns a
  ``MeshBoundKernel`` and ``ops.dense``'s loss and both gradients equal the
  unsharded ones within 1e-4, the forward, ``.dA`` and ``.dB`` each
  through a mesh-bound kernel.
* ``make_train_step(mesh=)`` on a 2x2 mesh (4 ranks), deepseek-7b smoke,
  lr 1e-2, 20 steps from the reference's weights: the loss falls by more
  than 0.1, the first 3 losses equal the reference's under 4 forced
  devices at the f32 TOL, and every rank ends with the same parameters.
* ``serve --mesh 1x2 --smoke`` on 2 ranks (both engines): every rank's
  tokens equal the single-rank port's, and on the reference's weights
  equal the reference's ``serve --mesh 1x2`` (2 forced devices).
* The sweep CLI's and the single-process search's mesh behaviour.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro_torch.launch.mesh import spawn_ranks

import _mesh_ranks as R

STEPS = 20

REF_TRAIN = """
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.data.pipeline import DataConfig, batch_at
from repro.launch.mesh import make_debug_mesh, set_mesh
from repro.launch.steps import make_train_step
from repro.models.api import get_api
from repro.optim import AdamWConfig
from repro.optim import adamw as optim

cfg = get_config("deepseek-7b").smoke()
api = get_api(cfg)
mesh = make_debug_mesh((2, 2), ("data", "model"))
flat = {}


def walk(t, p):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, p + [k])
    else:
        flat["/".join(p)] = np.asarray(t)


with set_mesh(mesh):
    params, _ = api.init(cfg, jax.random.key(0))
    walk(params, [])
    np.savez(__PATH__, **flat)
    ocfg = AdamWConfig(lr=1e-2, moments_dtype="float32")
    opt = optim.init(params, ocfg)
    step = jax.jit(make_train_step(cfg, ocfg))
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    losses = []
    for i in range(3):
        b = {k: jnp.asarray(v) for k, v in batch_at(dc, i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
print("JSON" + json.dumps(losses))
"""

REF_SERVE = """
import json
import numpy as np
import jax
from repro.configs import get_config
from repro.launch.serving import ContinuousEngine, Gateway, synthetic_trace
from repro.models.api import get_api

cfg = get_config("qwen3-8b").smoke()
params, _ = get_api(cfg).init(cfg, jax.random.key(0))
flat = {}


def walk(t, p):
    if isinstance(t, dict):
        for k, v in t.items():
            walk(v, p + [k])
    else:
        flat["/".join(p)] = np.asarray(t)


walk(params, [])
np.savez(__PATH__, **flat)
# what `serve --smoke --mesh 1x2` with the flags below builds
REQ, PLEN, NEW, LANES, PAGE = 2, 8, 4, 2, 16
trace = synthetic_trace(REQ, vocab=cfg.vocab, seed=0, rate_hz=0.0,
                        prompt_lens=tuple(sorted({max(1, PLEN // 4),
                                                  max(1, PLEN // 2), PLEN})),
                        max_news=tuple(sorted({max(1, NEW // 4), NEW})))
max_ctx = PLEN + NEW + 1
engine = ContinuousEngine(cfg, lanes=LANES, page_size=PAGE,
                          n_pages=1 + LANES * -(-max_ctx // PAGE),
                          max_ctx=max_ctx, mesh_shape="1x2")
Gateway(engine).run(trace)
print("JSON" + json.dumps({r.rid: list(r.out_tokens) for r in trace}))
"""

SERVE_FLAGS = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
               "--requests", "2", "--prompt-len", "8", "--max-new", "4",
               "--lanes", "2", "--rate-hz", "0"]


def _json_line(out):
    line = next(ln for ln in out.splitlines() if ln.startswith("JSON"))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def accepted(store):
    return spawn_ranks(R.acceptance, 8, (f"{store}/plans_2x4.json",),
                       store_dir=store, threads=1, timeout_s=300)


def test_mesh_search_gives_sharded_rungs_on_every_rank(accepted):
    ladders = accepted[0]["ladders"]
    assert set(ladders) == {"fwd", "dA", "dB"}
    for label, rungs in ladders.items():
        assert any(sharded for _, _, sharded, _, _ in rungs), label
        # the world hosts the mesh: every rung was measured
        assert all(measured for _, _, _, measured, _ in rungs), label
        assert any(src == "mesh-naive" for src, *_ in rungs), label
    for out in accepted[1:]:
        assert out["ladders"] == ladders


def test_dense_under_the_mesh_runs_mesh_bound_kernels(accepted):
    for out in accepted:
        assert out["is_bound"], out["kernel"]
        assert out["mesh_levels"]
        # the forward and both derived backward specs went through a
        # mesh-bound kernel
        assert set(out["calls"]) == {"mesh.calls.matmul",
                                     "mesh.calls.matmul.dA",
                                     "mesh.calls.matmul.dB"}, out["calls"]
        (bl, bgx, bgw), (ml, mgx, mgw) = out["base"], out["sharded"]
        np.testing.assert_allclose(ml, bl, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mgx, bgx, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mgw, bgw, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def trained(store):
    from conftest import run_forced_devices

    path = f"{store}/deepseek_params.npz"
    ref = _json_line(run_forced_devices(
        REF_TRAIN.replace("__PATH__", repr(path)), devices=4, timeout=900))
    ranks = spawn_ranks(R.train, 4, (path, STEPS), store_dir=store,
                        threads=1, timeout_s=600)
    return ref, ranks


def test_train_step_under_a_mesh_learns_and_matches_the_reference(trained):
    ref, ranks = trained
    losses = ranks[0]["losses"]
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    np.testing.assert_allclose(losses[:3], ref, rtol=2e-4, atol=2e-4)


def test_every_rank_holds_the_same_parameters(trained):
    _, ranks = trained
    for out in ranks[1:]:
        assert out["losses"] == ranks[0]["losses"]
        assert out["digest"] == ranks[0]["digest"]


@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_serve_mesh_tokens_equal_the_single_rank_port(engine, store):
    from repro_torch.launch import serve

    flags = SERVE_FLAGS + ["--engine", engine]
    ranks = spawn_ranks(
        R.serve_cli, 2, (f"{store}/serve_{engine}.json",
                         flags + ["--mesh", "1x2"]),
        store_dir=store, threads=1, timeout_s=300)
    _, trace, _ = serve.main(flags)
    want = {r.rid: list(r.out_tokens) for r in trace}
    for out in ranks:
        assert out["meshed"]
        assert out["tokens"] == want


def test_serve_mesh_tokens_equal_the_references(store):
    from conftest import run_forced_devices

    path = f"{store}/qwen3_params.npz"
    ref = _json_line(run_forced_devices(
        REF_SERVE.replace("__PATH__", repr(path)), devices=2, timeout=900))
    ranks = spawn_ranks(
        R.serve_reference_weights, 2,
        (f"{store}/serve_ref.json", path, SERVE_FLAGS + ["--mesh", "1x2"]),
        store_dir=store, threads=1, timeout_s=300)
    for out in ranks:
        assert out["meshed"]
        assert {str(k): v for k, v in out["tokens"].items()} == ref


def test_a_world_without_the_mesh_serves_single_rank(tmp_path, capsys):
    from repro_torch.launch import serve

    stats, trace, engine = serve.main(SERVE_FLAGS + ["--mesh", "2x4"])
    assert engine.mesh is None
    assert all(r.state == "finished" for r in trace)
    assert "serving single-rank" in capsys.readouterr().out


def test_single_process_mesh_search_ranks_sharded_plans_behind(tmp_path):
    """No world hosts the mesh: sharded candidates keep their analytic
    score and rank behind the measured single-rank plans, as in the
    reference; the ladder round-trips under the mesh-qualified key."""
    from repro_torch.core.enumerate import matmul_spec
    from repro_torch.search import PlanDB, search_schedule

    spec = matmul_spec(64, 64, 64)
    db = PlanDB(str(tmp_path / "plans.json"))
    res = search_schedule(spec, beam_width=4, topk=3, measure=True,
                          interpret=True, plan_db=db, mesh_shape=(2, 4),
                          device="cpu")
    assert res.mesh == "2x4"
    assert any(p.sharded for p in res.ranked)
    for p in res.ranked:
        assert (p.measured_s is None) == p.sharded
    assert res.best.measured_s is not None
    sched, entry = db.best_sharded_entry(spec, "float32", mesh="2x4")
    assert sched is not None and "collective" in entry
    assert db.best_schedule(spec, "float32") is None
