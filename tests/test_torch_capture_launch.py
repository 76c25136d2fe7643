"""The launchers through whole-model capture, against the reference.

* ``make_train_step(capture=True)`` for 3 steps against the reference's
  captured train step (its capture run through the ``jax.core`` names
  ``tests/test_torch_capture.py`` sets back), and ``train --capture``
  against ``train`` without it;
* ``serve --capture``: the f32 small dense model's greedy tokens through
  the captured steps of both engines equal the reference engine's on the
  same weights and trace (``REPRO_INTERPRET=1``, so the aligned sites and
  the single-block attention motif dispatch to the kernels' plain
  versions), and the CLI serves both engines with ``--capture``;
* ``python -m repro_torch.search.sweep --from-model`` harvests the
  reference's ``model_gemm_specs`` set (the motif's two specs as one);
* the mesh refusals that stay, each naming ROADMAP.md item 6c (part 2).
"""

from __future__ import annotations

import jax
import jax.extend.core as jex_core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import capture as ref_capture
from repro.configs import get_config as ref_get_config
from repro.data import pipeline as ref_data
from repro.launch import steps as ref_steps
from repro.launch.serving import ContinuousEngine as RefEngine
from repro.launch.serving import FixedEngine as RefFixed
from repro.launch.serving import synthetic_trace as ref_trace
from repro.optim import adamw as ref_adamw
from repro_torch import capture, obs
from repro_torch.configs import get_config as port_get_config
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.launch.serving import (ContinuousEngine, FixedEngine,
                                        Gateway, synthetic_trace)
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as port_adamw

from test_torch_model import reference_params, small_configs

TOL = (2e-4, 2e-4)  # f32 training, as tests/test_torch_train.py


@pytest.fixture(autouse=True)
def _shim_and_isolate(tmp_path, monkeypatch):
    for name in ("Var", "Literal", "Jaxpr", "ClosedJaxpr"):
        monkeypatch.setattr(jax.core, name, getattr(jex_core, name),
                            raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_INTERPRET", "1")
    monkeypatch.delenv("REPRO_CAPTURE", raising=False)
    monkeypatch.delenv("REPRO_MOE_GROUPED", raising=False)
    monkeypatch.delenv("REPRO_OBS", raising=False)
    monkeypatch.setenv("REPRO_LOG", "quiet")
    obs.metrics_reset()
    yield
    obs.metrics_reset()


def _scaled_close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol[0],
                               atol=tol[1], err_msg=what)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def test_captured_train_steps_match_reference():
    """3 captured train steps of the dense demo config against the
    reference's captured steps: losses and the parameters after."""
    rcfg = ref_capture.demo_configs()["dense"]
    pcfg = capture.demo_configs()["dense"]
    ref_params, np_params = reference_params(rcfg, seed=4)
    opt_r = ref_adamw.AdamWConfig(lr=3e-3)
    opt_p = port_adamw.AdamWConfig(lr=3e-3)
    rstep = ref_steps.make_train_step(
        rcfg, opt_r, lr_schedule=ref_adamw.warmup_cosine(warmup=1, total=3),
        capture=True)
    pstep = port_steps.make_train_step(
        pcfg, opt_p, lr_schedule=port_adamw.warmup_cosine(warmup=1, total=3),
        capture=True)
    rstate = ref_adamw.init(ref_params, opt_r)
    params = PT.params_from_reference(pcfg, np_params, device="cpu")
    pstate = port_adamw.init(params, opt_p)
    rp = ref_params
    data = ref_data.DataConfig(vocab=rcfg.vocab, seq_len=capture.DEMO_SEQ,
                               global_batch=capture.DEMO_BATCH)
    for step in range(3):
        b = ref_data.batch_at(data, step)
        rb = {k: jnp.asarray(v) for k, v in b.items()}
        pb = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
        rp, rstate, rm = rstep(rp, rstate, rb)
        params, pstate, pm = pstep(params, pstate, pb)
        _scaled_close(float(pm["loss"]), float(rm["loss"]),
                      f"loss at step {step}")
    flat = dict(port_adamw.leaves(params))
    for path, r in jax.tree_util.tree_flatten_with_path(rp)[0]:
        key = tuple(k.key for k in path)
        _scaled_close(flat[key].detach().numpy(), np.asarray(r),
                      f"param {key} after 3 steps")


def test_train_cli_capture_matches_uncaptured():
    flags = ["--arch", "qwen3-8b", "--smoke", "--steps", "3", "--batch",
             "2", "--seq", "16", "--device", "cpu"]
    _, plain, _ = port_train.main(flags)
    _, captured, _ = port_train.main(flags + ["--capture"])
    assert len(captured) == 3 and all(np.isfinite(captured))
    _scaled_close(captured, plain, "train --capture losses")


def test_make_train_step_capture_reads_the_environment(monkeypatch):
    """``$REPRO_CAPTURE=1`` captures the loss; a step under a mesh is
    built since the mesh tier (``tests/test_torch_mesh_launch.py`` runs
    one on ranks)."""
    cfg = port_get_config("qwen3-8b").smoke()
    opt = port_adamw.AdamWConfig()
    monkeypatch.setenv("REPRO_CAPTURE", "1")
    step = port_steps.make_train_step(cfg, opt)
    params = PT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = port_adamw.init(params, opt)
    toks = torch.zeros((2, 16), dtype=torch.int32)
    _, _, m = step(params, state, {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(m["loss"]))
    assert callable(port_steps.make_train_step(cfg, opt, mesh=object()))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def _traces(vocab, prompt_len, n=4, max_new=3):
    kw = dict(vocab=vocab, seed=5, rate_hz=0.0, prompt_lens=(prompt_len,),
              max_news=(max_new,))
    return ref_trace(n, **kw), synthetic_trace(n, **kw)


def _attention_dispatched(fn) -> bool:
    return any(s.op == "attention" and s.dispatched
               for r in fn.reports for s in r.sites)


def _tokens_equal(r_trace, p_trace):
    for a, b in zip(r_trace, p_trace):
        assert np.array_equal(a.prompt, b.prompt)
        assert b.state == "finished" and len(b.out_tokens) == b.max_new
        assert b.out_tokens == a.out_tokens, (
            f"request {b.rid}: port {b.out_tokens} != reference "
            f"{a.out_tokens}")


def test_continuous_capture_tokens_match_reference():
    """Prompts that fill their 128-token pages prefill unmasked, so the
    attention motif dispatches (one ``ops.attention`` a layer); the tokens
    are the reference engine's."""
    ref_cfg, port_cfg = small_configs()
    ref_params, np_params = reference_params(ref_cfg, seed=1)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    r_trace, p_trace = _traces(ref_cfg.vocab, 128)
    kw = dict(lanes=2, page_size=128, n_pages=9, max_ctx=256)
    RefEngine(ref_cfg, params=ref_params, **kw).run(r_trace)
    eng = ContinuousEngine(port_cfg, params=port_params, device="cpu",
                           capture=True, **kw)
    Gateway(eng).run(p_trace)
    _tokens_equal(r_trace, p_trace)
    assert _attention_dispatched(eng.prefill.step)
    assert set(eng.capture_stats["reports"]) == {"prefill", "decode"}
    assert eng.capture_stats["points"] > 0


def test_fixed_capture_tokens_match_reference():
    """The fixed server with capture on both sides: equal-length prompts
    fill every slot, so no row is padded and the motif dispatches."""
    ref_cfg, port_cfg = small_configs()
    ref_params, np_params = reference_params(ref_cfg, seed=2)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    r_trace, p_trace = _traces(ref_cfg.vocab, 64)
    kw = dict(lanes=2, max_ctx=68, capture=True)
    RefFixed(ref_cfg, params=ref_params, **kw).run(r_trace)
    eng = FixedEngine(port_cfg, params=port_params, device="cpu", **kw)
    Gateway(eng).run(p_trace)
    _tokens_equal(r_trace, p_trace)
    assert _attention_dispatched(eng.server._prefill_step)


@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_serve_cli_capture_serves_both_engines(engine):
    flags = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--engine",
             engine, "--capture", "--requests", "2", "--prompt-len", "8",
             "--max-new", "3", "--lanes", "2", "--rate-hz", "0",
             "--no-search-grads"]
    stats, trace, eng = port_serve.main(flags)
    assert stats["tokens"] == sum(r.max_new for r in trace)
    assert all(r.state == "finished" for r in trace)


@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_serve_cli_still_refuses_a_mesh(engine):
    """``serve --capture --mesh`` now serves: a world of one cannot host
    the 2x4 mesh, so it sweeps the captured specs at the mesh tier and
    serves single-rank, the same tokens as ``--capture`` alone."""
    flags = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--engine",
             engine, "--capture", "--requests", "2", "--prompt-len", "8",
             "--max-new", "3", "--lanes", "2", "--rate-hz", "0",
             "--no-search-grads"]
    _, meshed, eng = port_serve.main(flags + ["--mesh", "2x4"])
    _, plain, _ = port_serve.main(flags)
    assert getattr(eng, "server", eng).mesh is None
    assert [r.out_tokens for r in meshed] == [r.out_tokens for r in plain]
    assert all(r.state == "finished" for r in meshed)


def test_sweep_captured_refuses_a_mesh(tmp_path):
    """``sweep_captured(mesh_shape=)`` sweeps each plain point at the mesh
    tier too, under the reference's mesh-qualified key, and a fused point
    at mesh=None only (the fused families have no mesh tier)."""
    from repro.core.enumerate import matmul_spec as ref_matmul_spec
    from repro.search.plandb import plan_key as ref_plan_key
    from repro_torch.core.enumerate import attention_spec, matmul_spec
    from repro_torch.search import PlanDB
    from repro_torch.search.plandb import plan_key

    db = PlanDB(str(tmp_path / "plans.json"))
    points = [("train:matmul", matmul_spec(128, 128, 128), "float32"),
              ("prefill:attention", attention_spec(2, 8, 8, 16), "float32")]
    n = capture.sweep_captured(points, with_grads=False, plan_db=db,
                               measure=False, mesh_shape="2x4",
                               device="cpu")
    assert n == 3  # matmul at mesh=None and 2x4, attention at mesh=None
    sched, entry = db.best_sharded_entry(points[0][1], "float32", mesh="2x4")
    assert sched is not None and "collective" in entry
    assert db.best_sharded_entry(points[1][1], "float32",
                                 mesh="2x4")[0] is None
    assert plan_key(points[0][1], torch.float32, hardware="h100",
                    mesh="2x4") == ref_plan_key(
        ref_matmul_spec(128, 128, 128), np.dtype("float32"), hardware="h100",
        mesh="2x4")


# --------------------------------------------------------------------------
# sweep --from-model
# --------------------------------------------------------------------------


def _spec_set(points):
    return {capture.spec_key(spec, str(dt)) for _, spec, dt in points}


def test_sweep_from_model_harvests_the_reference_spec_set(tmp_path):
    """``sweep --from-model qwen3-8b --model-smoke``: the port's harvested
    specs are the reference's ``model_gemm_specs``, except that the
    reference's attention P.V (``batched_matmul``, its motif missed on
    jax 0.9) is the port's one ``attention`` spec; every point
    round-trips through the plan DB."""
    from repro_torch.search import sweep

    code, results = sweep.run([
        "--from-model", "qwen3-8b", "--model-smoke", "--device", "cpu",
        "--no-measure", "--plan-db", str(tmp_path / "plans.json")])
    assert code == 0 and results
    port = {capture.spec_key(spec.root(), "")[:2] for _, spec, _, _ in
            results}
    ref_pts = ref_capture.model_gemm_specs(
        ref_get_config("qwen3-8b").smoke(), batch=2, seq=64,
        kinds=("train", "prefill", "decode"), interpret=True)
    ref = set()
    for _, spec, _ in ref_pts:
        if spec.name == "batched_matmul":
            e = spec.extents
            ref.add(("attention", tuple(sorted(
                {"h": e["b"], "s": e["i"], "t": e["j"], "d": e["k"],
                 "e": e["k"]}.items()))))
        else:
            ref.add(capture.spec_key(spec, "")[:2])
    assert port == ref
    with pytest.raises(SystemExit, match="--from-model"):
        sweep.run(["--from-model", "qwen3-8b", "--shapes", "8,8,8",
                   "--device", "cpu"])
