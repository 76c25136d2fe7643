"""The port's one-card dry-run, op counter, roofline table and perf
harness against the reference.

* ``roofline.op_count`` on a smoke train step (qwen3-8b and kimi-k2,
  each remat policy) and prefill step, traced on fake tensors, against
  ``roofline.hlo_parse.analyze_hlo`` of the reference's jitted step:
  ``dot_flops`` within 1 % (they are equal) and ``dot_bytes`` too.
* ``roofline.analysis``: ``param_counts`` equal to the reference's
  (``jax.eval_shape``) for all ten archs at full size; ``model_flops``
  and ``analyze_cell`` equal to the reference's on the same records (the
  port's own records without ``hw``, and ``tests/test_launch.py::
  test_roofline_terms_math``'s); a ``"hw": "h100"`` record priced at
  ``core.cost.H100``.
* ``launch.dryrun.run_cell`` ``ok`` for one cell of each family, with the
  kernels' builder and launchers made to raise; its record's keys; the
  CLI's skip-existing, error records and mesh refusal.
* The kernels' ``repro_torch`` ops on fake CUDA tensors: ``ops.dense``,
  ``batched_dense``, ``grouped_dense``, ``dense_act`` and ``attention``
  each one op, the fake output's shape and dtype, the registered flops,
  nothing built or launched; the fake implementations' refusals.
* ``launch.perf``: ``remat_dots`` against the baseline record,
  ``causal_skip``, ``donate`` changing nothing, the sharding knobs
  refused.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models.api import get_api as ref_get_api
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw as ref_adamw
from repro.roofline import analysis as ref_analysis
from repro.roofline.hlo_parse import analyze_hlo
from repro_torch import codegen, ops
from repro_torch.codegen import build, cuda_gen, fused_gen, modes
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.cost import H100
from repro_torch.core.enumerate import attention_spec, matmul_spec
from repro_torch.launch import dryrun, perf
from repro_torch.launch import steps as port_steps
from repro_torch.ops import library
from repro_torch.roofline import analysis as port_analysis
from repro_torch.roofline.op_count import count_step

B, S = 2, 16


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.delenv("REPRO_MOE_GROUPED", raising=False)
    monkeypatch.delenv("REPRO_CAUSAL_SKIP", raising=False)
    monkeypatch.delenv("REPRO_REMAT_POLICY", raising=False)
    monkeypatch.setenv("REPRO_LOG", "quiet")


@pytest.fixture
def no_kernels(monkeypatch):
    """Any build, load or launch raises."""
    def refuse(*a, **k):
        raise AssertionError("a dry-run built or launched a kernel")

    monkeypatch.setattr(build, "load", refuse)
    for launcher in (cuda_gen.ContractLauncher, fused_gen.GroupedLauncher,
                     fused_gen.GroupedDwLauncher, fused_gen.AttentionLauncher,
                     modes.Contract8Launcher, modes.ChainLauncher):
        monkeypatch.setattr(launcher, "__call__", refuse)


def _ref_hlo(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def _close(got, want, what):
    assert abs(got - want) <= 1e-2 * abs(want), (what, got, want)


@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_train_step_counts_match_analyze_hlo(arch, policy, monkeypatch,
                                             no_kernels):
    monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    rcfg = ref_get_config(arch).smoke()
    params, _ = ref_get_api(rcfg).init(rcfg, jax.random.key(0))
    oc = RefAdamWConfig()
    tok = jnp.zeros((B, S), jnp.int32)
    want = _ref_hlo(ref_make_train_step(rcfg, oc), params,
                    ref_adamw.init(params, oc), {"tokens": tok, "labels": tok})
    cfg = port_get_config(arch).smoke()
    with FakeTensorMode():
        b = port_steps.train_bundle(cfg, ShapeConfig("t", S, B, "train"),
                                    device="cpu")
        got = count_step(b.fn, *b.in_shapes)
    _close(got["dot_flops"], want["dot_flops"], "dot_flops")
    _close(got["dot_bytes"], want["dot_bytes"], "dot_bytes")
    assert got["collective_bytes"] == 0.0 and got["n_ops"] > 0
    assert got["peak_live_bytes"] >= got["argument_bytes"] > 0
    assert got["saved_bytes"] > 0


@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b"])
def test_prefill_step_counts_match_analyze_hlo(arch, no_kernels):
    rcfg = ref_get_config(arch).smoke()
    params, _ = ref_get_api(rcfg).init(rcfg, jax.random.key(0))
    tok = jnp.zeros((B, S), jnp.int32)
    want = _ref_hlo(lambda p, t: ref_get_api(rcfg).prefill(
        p, rcfg, {"tokens": t}, S), params, tok)
    cfg = port_get_config(arch).smoke()
    with FakeTensorMode():
        b = port_steps.prefill_bundle(cfg, ShapeConfig("p", S, B, "prefill"),
                                      device="cpu")
        got = count_step(b.fn, *b.in_shapes)
    _close(got["dot_flops"], want["dot_flops"], "dot_flops")
    assert got["saved_bytes"] == 0.0


def test_saved_bytes_grow_with_what_the_policy_saves(monkeypatch):
    cfg = port_get_config("qwen3-8b").smoke()
    saved = {}
    for policy in ("nothing", "dots_no_batch", "dots"):
        monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
        rec = dryrun.run_cell("qwen3-8b", "t", device="cpu", cfg=cfg,
                              shape=ShapeConfig("t", S, B, "train"))
        saved[policy] = rec["memory"]["saved_bytes"]
    assert saved["nothing"] < saved["dots_no_batch"] < saved["dots"]


def test_param_counts_match_reference_for_every_arch():
    for arch in ARCH_IDS:
        assert port_analysis.param_counts(arch) == \
            ref_analysis.param_counts(arch), arch


def _records(tmp_path):
    cfg = port_get_config("qwen3-8b").smoke()
    recs = []
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        kind = name.split("_")[0]
        rec = dryrun.run_cell("qwen3-8b", name, device="cpu", cfg=cfg,
                              shape=ShapeConfig(name, S, B, kind))
        recs.append(rec)
    return recs


def test_model_flops_and_analyze_cell_match_reference(tmp_path):
    counts = ref_analysis.param_counts("qwen3-8b")
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert port_analysis.model_flops("qwen3-8b", shape, counts) == \
            ref_analysis.model_flops("qwen3-8b", shape, counts)
    math_rec = dict(
        status="ok", arch="x", shape="train_4k", mesh="16x16", chips=256,
        step="train_step", flops=197e12, bytes_accessed=819e9,
        collectives={"all-gather": 50e9, "all-reduce": 0,
                     "reduce-scatter": 0, "all-to-all": 0,
                     "collective-permute": 0, "count": 1},
    )
    got = port_analysis.analyze_cell(math_rec)
    assert got == ref_analysis.analyze_cell(math_rec)
    assert got["compute_s"] == pytest.approx(1.0)
    for rec in _records(tmp_path):
        rec = {k: v for k, v in rec.items() if k not in ("hw", "device")}
        assert port_analysis.analyze_cell(rec, counts) == \
            ref_analysis.analyze_cell(rec, counts)


def test_h100_records_take_the_cards_rates(tmp_path):
    rec = _records(tmp_path)[0]
    row = port_analysis.analyze_cell(rec)
    p = rec["parsed"]
    assert row["compute_s"] == p["dot_flops"] / H100["peak_bf16"]
    assert row["memory_s"] == (p["dot_bytes"] + p["out_bytes_proxy"]) / \
        H100["hbm_bw"]
    assert row["collective_s"] == 0.0
    os.makedirs(tmp_path / "res")
    for r in _records(tmp_path):
        with open(tmp_path / "res" / f"{r['shape']}.json", "w") as f:
            json.dump(r, f)
    table = port_analysis.markdown_table(
        port_analysis.analyze_all(str(tmp_path / "res")))
    assert table.count("| qwen3-8b |") == 3


# one cell of each family, smoke-sized, on the plain path's fake tensors
FAMILY_CELLS = [
    ("qwen3-8b", "train"), ("kimi-k2-1t-a32b", "prefill"),
    ("mamba2-130m", "decode"), ("zamba2-2.7b", "train"),
    ("whisper-base", "prefill"), ("internvl2-1b", "decode"),
]


@pytest.mark.parametrize("arch,kind", FAMILY_CELLS)
def test_run_cell_ok_for_each_family(arch, kind, no_kernels):
    cfg = port_get_config(arch).smoke()
    seq = 512 if arch == "internvl2-1b" else 32  # past its 256 patches
    rec = dryrun.run_cell(arch, kind, device="cpu", cfg=cfg,
                          shape=ShapeConfig(kind, seq, 2, kind))
    assert rec["status"] == "ok", rec
    assert rec["step"] == f"{'serve' if kind == 'decode' else kind}_step"
    assert (rec["mesh"], rec["chips"], rec["hw"]) == ("1", 1, "h100")
    assert rec["flops"] == rec["parsed"]["dot_flops"] > 0
    mem = rec["memory"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert all(v == 0 for v in rec["collectives"].values())


def test_dryrun_cli_records_skips_errors_and_refuses_meshes(tmp_path,
                                                             monkeypatch):
    cfg = port_get_config("qwen3-8b").smoke()
    real = dryrun.run_cell

    # on the pod mesh a stand-in whose extents the 16-wide axes divide
    pod_cfg = dataclasses.replace(cfg, n_layers=1, d_model=256, n_heads=16,
                                  n_kv_heads=16, head_dim=16, d_ff=512,
                                  vocab=512)

    def small(arch, shape, device="cuda", mesh="1"):
        if arch != "qwen3-8b":
            raise RuntimeError("boom")
        if mesh != "1":
            return real(arch, shape, device=device, cfg=pod_cfg,
                        shape=ShapeConfig("prefill", 32, 32, "prefill"),
                        mesh=mesh)
        return real(arch, shape, device=device, cfg=cfg,
                    shape=ShapeConfig("prefill", S, B, "prefill"))

    monkeypatch.setattr(dryrun, "run_cell", small)
    out = str(tmp_path / "r")
    for arch in ("qwen3-8b", "mamba2-130m"):
        dryrun.main(["--arch", arch, "--shape", "prefill_32k", "--out", out,
                     "--device", "cpu"])
    with open(os.path.join(out, "qwen3-8b__prefill_32k__1.json")) as f:
        assert json.load(f)["status"] == "ok"
    with open(os.path.join(out, "mamba2-130m__prefill_32k__1.json")) as f:
        err = json.load(f)
    assert err["status"] == "error" and "boom" in err["error"]
    monkeypatch.setattr(dryrun, "run_cell", None)  # skip-existing: not run
    dryrun.main(["--arch", "qwen3-8b", "--shape", "prefill_32k", "--out",
                 out, "--device", "cpu"])
    # the meshes: one rank's share of the step, under the reference's tag
    monkeypatch.setattr(dryrun, "run_cell", small)
    dryrun.main(["--arch", "qwen3-8b", "--shape", "prefill_32k", "--mesh",
                 "pod", "--out", out, "--device", "cpu"])
    with open(os.path.join(out, "qwen3-8b__prefill_32k__sp.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok", rec
    assert (rec["mesh"], rec["chips"]) == ("16x16", 256)
    # collective_bytes: what a call's collectives move on this rank
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import fake_world, make_debug_mesh

    with fake_world(4):
        mesh = make_debug_mesh((2, 2), ("data", "model"))
        x = distribute_tensor(torch.ones(8, 4), mesh.device_mesh,
                              [Shard(0), Replicate()])
        got = dryrun.collective_bytes(
            lambda: x.redistribute(mesh.device_mesh,
                                   [Replicate(), Replicate()]))
    assert got == {"all-gather": 8 * 4 * 4, "all-reduce": 0,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 0, "count": 1}


def _fake_cuda(*shapes, dtype=torch.bfloat16):
    return [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]


@pytest.mark.parametrize("call,want_shape,flops", [
    (lambda: ops.dense(*_fake_cuda((64, 128), (128, 256))), (64, 256),
     2 * 64 * 128 * 256),
    (lambda: ops.batched_dense(*_fake_cuda((3, 64, 128), (3, 128, 32))),
     (3, 64, 32), 2 * 3 * 64 * 128 * 32),
    (lambda: ops.grouped_dense(*_fake_cuda((10, 64), (3, 64, 32)),
                               (4, 0, 6)), (10, 32), 2 * 10 * 64 * 32),
    (lambda: ops.attention(*_fake_cuda((4, 32, 64), (4, 48, 64),
                                       (4, 48, 16)), causal=True),
     (4, 32, 16), 2 * 4 * 32 * 48 * (64 + 16)),
    (lambda: ops.dense_act(*_fake_cuda((64, 128), (128, 256)),
                           *_fake_cuda((256,), (256,), (256,),
                                       dtype=torch.float32)),
     (64, 256), 2 * 64 * 128 * 256),
])
def test_fake_cuda_calls_are_one_op_each(call, want_shape, flops,
                                         no_kernels):
    with FakeTensorMode(), torch.no_grad():
        fc = FlopCounterMode(display=False)
        with fc:
            out = call()
    assert out.device.type == "cuda" and tuple(out.shape) == want_shape
    assert out.dtype == torch.bfloat16
    assert fc.get_total_flops() == flops
    ours = {str(k) for k in fc.get_flop_counts()["Global"]}
    assert len(ours) == 1 and ours <= {str(o.overloadpacket)
                                       for o in library.PRODUCT_OPS}


def test_fake_implementations_refuse_what_the_launchers_refuse():
    spec = matmul_spec(8, 16, 32)
    key = library.key_of(codegen.compile(spec,
                                         codegen.default_schedule(spec)))
    with FakeTensorMode():
        a = torch.empty((8, 16), dtype=torch.int64, device="cuda")
        b = torch.empty((16, 32), dtype=torch.int64, device="cuda")
        with pytest.raises(TypeError, match="operands"):
            library.CONTRACT_OP(key, [a, b], [], torch.float32)
        a, b = _fake_cuda((8, 16), (16, 32))
        with pytest.raises(TypeError, match="writes"):
            library.CONTRACT_OP(key, [a, b], [], torch.float16)
        out = library.CONTRACT_OP(key, [a, b], [], torch.float32)
        assert tuple(out.shape) == (8, 32) and out.dtype == torch.float32
        q, k, v = _fake_cuda((2, 8, 300), (2, 8, 300), (2, 8, 300))
        att = ops._tuned_kernel(attention_spec(2, 8, 8, 300, e=300),
                                torch.bfloat16)
        with pytest.raises(ValueError, match="up to"):
            library.ATTENTION_OP(library.key_of(att), q, k, v, None,
                                 torch.bfloat16)


def test_perf_knobs(tmp_path, capsys):
    cfg = dataclasses.replace(port_get_config("qwen3-8b").smoke(),
                              n_layers=2)
    shape = ShapeConfig("prefill", 64, 1, "train")
    base_dir = str(tmp_path / "results")
    os.makedirs(base_dir)
    base = dryrun.run_cell("qwen3-8b", "train_4k", device="cpu", cfg=cfg,
                           shape=shape)
    with open(os.path.join(base_dir, "qwen3-8b__train_4k__1.json"), "w") as f:
        json.dump(base, f)
    kw = dict(device="cpu", out=str(tmp_path / "perf"),
              baseline_dir=base_dir, cfg=cfg, shape_cfg=shape)
    row = perf.run("qwen3-8b", "train_4k", ["remat_dots"], **kw)
    assert "--- vs baseline ---" in capsys.readouterr().out
    b, n = row["vs_baseline"]["compute_s"]
    assert n < b  # the saved products are not recomputed
    assert os.environ.get("REPRO_REMAT_POLICY") is None  # restored
    row = perf.run("qwen3-8b", "train_4k", ["donate"], **kw)
    assert row["donate"] == perf.DONATE_NOTE
    assert row["vs_baseline"]["compute_s"][0] == \
        row["vs_baseline"]["compute_s"][1]
    row = perf.run("qwen3-8b", "train_4k", ["causal_skip"], **kw)
    assert row["status"] == "ok"
    for knob in perf.MESH_KNOBS:  # a sharding knob needs a mesh
        with pytest.raises(ValueError, match="--mesh pod"):
            perf.run("qwen3-8b", "train_4k", [knob], **kw)
    row = perf.run("qwen3-8b", "train_4k", ["dp"], mesh="pod", **kw)
    assert row["status"] == "ok" and row["mesh"] == "16x16"
    assert os.environ.get("REPRO_SHARDING") is None  # restored
