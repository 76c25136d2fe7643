"""The port's MoE slice against the reference: grouped GEMM, routing, the
MoE model and its serving.

Inputs are made with numpy from a seed and handed to both packages.

* ``ops.grouped_dense(interpret=True)`` (the port's ``FusedKernel`` on CPU
  tensors, i.e. kernel B3's plain version) against the reference's
  ``ops.grouped_dense(interpret=True)`` (its Pallas kernel in interpret
  mode) over ragged, empty and size-1 partitions, at the reference's own
  tolerances (``tests/test_grouped.py``: f32 rtol 1e-5 / atol 1e-6, bf16
  1e-2), with the bf16 store-then-cast quirk and the three validation
  errors;
* the dX orientation against the reference's compiled
  ``grouped_matmul.dX`` spec;
* ``GroupedSpec`` schedules, plans, tuner winners, cache and plan keys
  equal to the reference's;
* ``moe_apply`` on both branches (einsum, ``REPRO_MOE_GROUPED=1``) for the
  kimi-k2 and llama4 ``smoke()`` configs: equal ``expert_idx``, outputs at
  rtol 1e-5;
* prefill and decode logits of both smoke configs (f32, rtol 1e-4 / atol
  1e-5, weights carried across by ``params_from_reference``), and bf16
  prefill logits of the qwen3 and kimi smoke configs at a scaled
  tolerance;
* greedy tokens of the port's ``ContinuousEngine`` equal to the
  reference's under ``REPRO_MOE_GROUPED=1``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.codegen.cache as ref_cache
import repro.core.enumerate as RE
import repro_torch.codegen.cache as port_cache
import repro_torch.core.enumerate as PE
from repro import codegen as ref_codegen
from repro import ops as ref_ops
from repro.configs import get_config as ref_get_config
from repro.grad import derived_specs as ref_derived_specs
from repro.launch.serving import ContinuousEngine as RefEngine
from repro.launch.serving import synthetic_trace as ref_trace
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.search.plandb import plan_key as ref_plan_key
from repro_torch import codegen as port_codegen
from repro_torch import ops as port_ops
from repro_torch.codegen.tune import TUNER_VERSION
from repro_torch.configs import get_config as port_get_config
from repro_torch.launch.serving import ContinuousEngine, synthetic_trace
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.search.plandb import plan_key as port_plan_key

from test_torch_foundation import GOLDEN_HW, to_port_spec

MOE_ARCHS = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b")


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.delenv("REPRO_MOE_GROUPED", raising=False)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(a, np.float32).astype(np.float64)


# --------------------------------------------------------------------------
# ops.grouped_dense and kernel B3's plain version
# --------------------------------------------------------------------------

#: hand-pinned partitions (the reference's) plus seeded ragged ones
PARTITIONS = [
    (0, 5, 0), (5, 0, 0), (0, 0, 5), (1, 1, 1, 1, 1), (5,),
    (0, 0, 0, 5, 0), (3, 0, 4, 1), (7, 1, 0, 9, 2), (0, 12, 1, 0, 6),
]


def _operands(rng, sizes, k, f, np_dtype):
    x = rng.standard_normal((sum(sizes), k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, f)).astype(np.float32)
    if np_dtype == "bfloat16":  # bf16-exact values, so both sides agree
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        w = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)
    return x, w


def _both(x, w, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    return (jnp.asarray(x, jdt), jnp.asarray(w, jdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))


@pytest.mark.parametrize("sizes", PARTITIONS, ids=str)
@pytest.mark.parametrize("interpret", [True, False])
def test_grouped_dense_f32_matches_reference(sizes, interpret):
    rng = np.random.default_rng(sum(sizes) * 31 + len(sizes))
    x, w = _operands(rng, sizes, 8, 4, "float32")
    jx, jw, tx, tw = _both(x, w, "float32")
    want = ref_ops.grouped_dense(jx, jw, sizes, interpret=interpret)
    got = port_ops.grouped_dense(tx, tw, sizes, interpret=interpret)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f64(got), _f64(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sizes", PARTITIONS[5:], ids=str)
def test_grouped_dense_bf16_matches_reference(sizes):
    rng = np.random.default_rng(len(sizes) + 7)
    x, w = _operands(rng, sizes, 4, 4, "bfloat16")
    jx, jw, tx, tw = _both(x, w, "bfloat16")
    for interpret in (True, False):
        want = ref_ops.grouped_dense(jx, jw, sizes, interpret=interpret)
        got = port_ops.grouped_dense(tx, tw, sizes, interpret=interpret)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f64(got), _f64(want), rtol=1e-2,
                                   atol=1e-2)


def test_grouped_dense_bf16_store_then_cast():
    """The kernel route stores in x's dtype and then casts to out_dtype (as
    the reference's ``_grouped_raw`` does); the loop route returns
    out_dtype directly, unrounded."""
    sizes = (3, 0, 4, 1, 6)
    rng = np.random.default_rng(99)
    x, w = _operands(rng, sizes, 16, 8, "bfloat16")
    jx, jw, tx, tw = _both(x, w, "bfloat16")
    kern = port_ops.grouped_dense(tx, tw, sizes, out_dtype=torch.float32,
                                  interpret=True)
    loop = port_ops.grouped_dense(tx, tw, sizes, out_dtype=torch.float32)
    assert kern.dtype == loop.dtype == torch.float32
    assert torch.equal(kern, kern.bfloat16().float())  # rounded to bf16
    assert not torch.equal(loop, loop.bfloat16().float())  # not rounded
    ref_kern = ref_ops.grouped_dense(jx, jw, sizes, out_dtype=jnp.float32,
                                     interpret=True)
    ref_loop = ref_ops.grouped_dense(jx, jw, sizes, out_dtype=jnp.float32)
    np.testing.assert_allclose(_f64(kern), _f64(ref_kern), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(_f64(loop), _f64(ref_loop), rtol=1e-5,
                               atol=1e-6)


def test_grouped_dense_zero_rows_total():
    w = torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, 4, 8)).astype(np.float32)
    )
    out = port_ops.grouped_dense(torch.zeros((0, 4)), w, (0, 0, 0),
                                 interpret=True)
    assert tuple(out.shape) == (0, 8)


@pytest.mark.parametrize("args,match", [
    (((4, 3), (2, 3, 5), (2, 1)), "sum to"),        # sum != rows
    (((4, 3), (2, 3, 5), (2, 1, 1)), "expert slabs"),  # len != g
    (((3,), (2, 3, 5), (2, 2)), "expects x"),       # x not 2-D
])
def test_grouped_dense_validation_matches_reference(args, match):
    xs, ws, sizes = args
    with pytest.raises(ValueError, match=match):
        ref_ops.grouped_dense(jnp.zeros(xs), jnp.zeros(ws), sizes,
                              interpret=True)
    with pytest.raises(ValueError, match=match):
        port_ops.grouped_dense(torch.zeros(xs), torch.zeros(ws), sizes,
                               interpret=True)


@pytest.mark.parametrize("sizes", [(3, 0, 4, 1), (0, 6, 0), (2, 2, 5)],
                         ids=str)
def test_grouped_dx_orientation_matches_reference(sizes):
    """``grouped_matmul.dX`` contracts against w's LAST axis: the port runs
    it through the same kernel (plain version on CPU) with w's strides
    swapped; the reference compiles its derived spec to Pallas."""
    k, f = 6, 5
    spec = RE.grouped_matmul_spec(sizes, k, f)
    dspec = ref_derived_specs(spec)["X"]
    rng = np.random.default_rng(len(sizes) * 5 + sum(sizes))
    dout = rng.standard_normal((sum(sizes), f)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, f)).astype(np.float32)
    ref_kern = ref_codegen.compile(
        dspec, ref_codegen.default_schedule(dspec), interpret=True
    )
    want = ref_kern(jnp.asarray(dout), jnp.asarray(w))
    pspec = to_port_spec(dspec)
    kern = port_codegen.compile(pspec, port_codegen.default_schedule(pspec))
    assert isinstance(kern, port_codegen.FusedKernel) and kern.contract_last
    got = kern(torch.from_numpy(dout), torch.from_numpy(w))
    np.testing.assert_allclose(_f64(got), _f64(want), rtol=1e-5, atol=1e-6)
    oracle = np.concatenate([
        dout[o:o + s] @ w[g].T for g, (o, s) in enumerate(
            zip(np.cumsum((0,) + sizes[:-1]), sizes))
    ])
    np.testing.assert_allclose(_f64(got), oracle, rtol=1e-5, atol=1e-5)


def test_fused_kinds_still_to_port_raise():
    spec = PE.grouped_matmul_spec((2, 3), 4, 4)
    dw = to_port_spec(ref_derived_specs(RE.grouped_matmul_spec((2, 3), 4, 4))
                      ["W"])
    attn = PE.attention_spec(2, 8, 8, 4)
    for s, what in ((dw, "B4"), (attn, "B2")):
        with pytest.raises(NotImplementedError, match=what):
            port_codegen.compile(s, port_codegen.default_schedule(s))
    sched = port_codegen.default_schedule(spec)
    with pytest.raises(NotImplementedError, match="take no epilogue"):
        port_codegen.compile_fused(spec, sched, epilogue=object())
    with pytest.raises(NotImplementedError, match="no mesh tier"):
        port_codegen.compile_fused(spec, sched, mesh=object())
    with pytest.raises(TypeError, match="kv_lengths"):
        port_codegen.compile(spec, sched)(torch.zeros(5, 4),
                                          torch.zeros(2, 4, 4),
                                          kv_lengths=[1])


# --------------------------------------------------------------------------
# GroupedSpec through the framework-free layers
# --------------------------------------------------------------------------

GROUPED_POINTS = [
    ((16,) * 384, 7168, 2048, "bfloat16"),   # kimi-k2 gate/up, C = 16
    ((4,) * 384, 2048, 7168, "bfloat16"),    # kimi-k2 down, C = 4
    ((3, 0, 4, 1), 8, 16, "float32"),
    ((0, 12, 1, 0, 6), 32, 24, "float32"),
]


@pytest.mark.parametrize("sizes,k,f,dtype", GROUPED_POINTS,
                         ids=lambda v: str(v)[:24])
def test_grouped_spec_schedule_plan_and_keys_match(tmp_path, monkeypatch,
                                                   sizes, k, f, dtype):
    from repro.codegen import build_plan as ref_build_plan
    from repro.codegen import default_schedule as ref_default_schedule
    from repro.codegen.tune import tune_schedule as ref_tune
    from repro.core.cost import TPU as REF_TPU

    ref = RE.grouped_matmul_spec(sizes, k, f)
    port = PE.grouped_matmul_spec(sizes, k, f)
    assert port == to_port_spec(ref)
    rs = ref_default_schedule(ref)
    ps = port_codegen.default_schedule(port)
    assert port_cache.schedule_to_dict(ps) == ref_cache.schedule_to_dict(rs)
    rp, pp = ref_build_plan(rs), port_codegen.build_plan(ps)
    assert pp.grid == rp.grid and pp.seq == rp.seq
    assert {n: dataclasses.asdict(a) for n, a in pp.axes.items()} == {
        n: dataclasses.asdict(a) for n, a in rp.axes.items()
    }
    rt = ref_tune(ref, dtype=np.dtype(dtype))
    pt = port_codegen.tune_schedule(port, dtype=getattr(torch, dtype))
    assert port_cache.schedule_to_dict(pt) == ref_cache.schedule_to_dict(rt)
    extra = {"tuner": TUNER_VERSION, "keep": 3, "measured": False,
             "hw": sorted((n, v) for n, v in REF_TPU.items()
                          if isinstance(v, (int, float)))}
    t_dt, np_dt = getattr(torch, dtype), np.dtype(dtype)
    assert port_cache.cache_key(
        port, dtype=t_dt, hardware=GOLDEN_HW, extra=extra
    ) == ref_cache.cache_key(ref, dtype=np_dt, hardware=GOLDEN_HW,
                             extra=extra)
    for kw in ({}, {"phase": "prefill"}, {"phase": "decode"}):
        assert port_plan_key(port, t_dt, GOLDEN_HW, **kw) == ref_plan_key(
            ref, np_dt, GOLDEN_HW, **kw
        )


# --------------------------------------------------------------------------
# moe_apply, the MoE model and its serving
# --------------------------------------------------------------------------


def _configs(arch, **overrides):
    ref = dataclasses.replace(ref_get_config(arch).smoke(), **overrides)
    port = dataclasses.replace(port_get_config(arch).smoke(), **overrides)
    return ref, port


def _reference_params(ref_cfg, seed):
    params, _ = RT.init(ref_cfg, jax.random.key(seed))
    return params, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    ref_cfg, port_cfg = _configs(request.param)
    ref_params, np_params = _reference_params(ref_cfg, seed=3)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    return ref_cfg, port_cfg, ref_params, port_params


def _moe_layer(params):
    """The first MoE layer's params of a stacked tree (numpy or torch)."""
    for seg in params.values():
        if isinstance(seg, dict) and "moe" in seg:
            return {k: _layer0(v) for k, v in seg["moe"]["moe"].items()}
    raise AssertionError("no MoE segment")


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def test_moe_params_carry_across(moe_model):
    ref_cfg, port_cfg, ref_params, port_params = moe_model
    layer = _moe_layer(port_params)
    assert layer["router"].dtype == torch.float32
    m = port_cfg.moe
    assert tuple(layer["w_gate"].shape) == (m.n_experts, port_cfg.d_model,
                                            m.expert_ff)
    assert tuple(layer["w_down"].shape) == (m.n_experts, m.expert_ff,
                                            port_cfg.d_model)


@pytest.mark.parametrize("grouped", ["0", "1"])
def test_moe_apply_matches_reference(moe_model, grouped, monkeypatch):
    ref_cfg, port_cfg, ref_params, port_params = moe_model
    monkeypatch.setenv("REPRO_MOE_GROUPED", grouped)
    rl, pl_ = _moe_layer(ref_params), _moe_layer(port_params)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 24, ref_cfg.d_model)).astype(np.float32)
    N = 48
    C = PM.capacity(port_cfg, N)
    assert C == RM.capacity(ref_cfg, N)

    _, want_idx = lax.top_k(
        jnp.dot(jnp.asarray(x).reshape(N, -1), rl["router"]),
        ref_cfg.moe.top_k,
    )
    _, got_idx, _, slot, _ = PM.route(pl_, port_cfg,
                                      torch.from_numpy(x).reshape(N, -1), C)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))

    want = RM.moe_apply(rl, ref_cfg, jnp.asarray(x))
    got = PM.moe_apply(pl_, port_cfg, torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_f64(got), _f64(want), rtol=1e-5, atol=1e-6)


def test_capacity_matches_reference():
    for arch in MOE_ARCHS:
        ref_cfg, port_cfg = ref_get_config(arch), port_get_config(arch)
        for n in (1, 4, 37, 128, 256, 512, 4096):
            assert PM.capacity(port_cfg, n) == RM.capacity(ref_cfg, n)
    # kimi-k2's serving path: 512/256/128-token prefills and 4-lane decode
    kimi = port_get_config("kimi-k2-1t-a32b")
    assert [PM.capacity(kimi, n) for n in (512, 256, 128, 4)] == [
        16, 8, 4, 4]


def test_moe_overflow_tokens_are_dropped(moe_model):
    """Tokens past an expert's capacity go to slot E*C; padded tokens are
    routed and take capacity as in the reference."""
    _, port_cfg, _, port_params = moe_model
    layer = _moe_layer(port_params)
    xf = torch.ones((64, port_cfg.d_model))  # every token picks the same k
    C = PM.capacity(port_cfg, 64)
    _, idx, _, slot, _ = PM.route(layer, port_cfg, xf, C)
    E = port_cfg.moe.n_experts
    assert int((slot == E * C).sum()) == 64 * port_cfg.moe.top_k - (
        C * port_cfg.moe.top_k
    )


@pytest.mark.parametrize("grouped", ["0", "1"])
def test_moe_prefill_then_decode_matches_reference(moe_model, grouped,
                                                   monkeypatch):
    ref_cfg, port_cfg, ref_params, port_params = moe_model
    monkeypatch.setenv("REPRO_MOE_GROUPED", grouped)
    rng = np.random.default_rng(21)
    S, max_len = 16, 20
    tokens = rng.integers(0, ref_cfg.vocab, size=(2, S)).astype(np.int32)
    lengths = np.array([S, 11], np.int32)
    tokens[1, 11:] = 0
    r_logits, r_caches = RT.prefill(
        ref_params, ref_cfg, jnp.asarray(tokens), max_len,
        lengths=jnp.asarray(lengths),
    )
    p_logits, p_caches = PT.prefill(
        port_params, port_cfg, torch.from_numpy(tokens).long(), max_len,
        lengths=torch.from_numpy(lengths).long(),
    )
    np.testing.assert_allclose(_f64(p_logits), _f64(r_logits), rtol=1e-4,
                               atol=1e-5, err_msg="prefill logits")
    for step in range(3):
        nxt = rng.integers(0, ref_cfg.vocab, size=(2, 1)).astype(np.int32)
        r_logits, r_caches = RT.decode_step(ref_params, ref_cfg, r_caches,
                                            jnp.asarray(nxt))
        p_logits, p_caches = PT.decode_step(port_params, port_cfg, p_caches,
                                            torch.from_numpy(nxt).long())
        np.testing.assert_allclose(
            _f64(p_logits), _f64(r_logits), rtol=1e-4, atol=1e-5,
            err_msg=f"decode step {step} logits",
        )


#: scaled bf16 tolerance: max |port - reference| / max |reference| over the
#: logits, held to the reference's own bf16 tolerance for generated kernels
#: (``tests/test_differential.py``: 6e-2).  bf16 keeps 8 significant bits,
#: so each rounding is worth up to 2^-9 ~ 2e-3 relative, and the two
#: frameworks round at different places (JAX casts each f32-accumulated
#: product once; PyTorch's CPU bf16 matmul and elementwise ops round where
#: they produce bf16).  At the smoke width (d_model 32) a logit sums only 32
#: terms, so those roundings do not average out: over seeds 0-7 the scaled
#: difference is 0.006-0.016, and 0.021 for this test's seed.
BF16_SCALED_TOL = 6e-2


@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b"])
def test_bf16_prefill_logits_match_reference(arch, monkeypatch):
    monkeypatch.setenv("REPRO_MOE_GROUPED", "1")
    ref_cfg, port_cfg = _configs(arch, dtype="bfloat16")
    ref_params, np_params = _reference_params(ref_cfg, seed=5)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, ref_cfg.vocab, size=(2, 16)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    want, _ = RT.prefill(ref_params, ref_cfg, jnp.asarray(tokens), 20,
                         lengths=jnp.asarray(lengths))
    got, _ = PT.prefill(port_params, port_cfg,
                        torch.from_numpy(tokens).long(), 20,
                        lengths=torch.from_numpy(lengths).long())
    assert got.dtype == torch.float32  # the unembedding stays f32
    want = _f64(want)
    scaled = np.abs(_f64(got) - want).max() / np.abs(want).max()
    assert scaled <= BF16_SCALED_TOL, scaled


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_tokens_match_reference(arch, monkeypatch):
    monkeypatch.setenv("REPRO_MOE_GROUPED", "1")
    ref_cfg, port_cfg = _configs(arch)
    ref_params, np_params = _reference_params(ref_cfg, seed=1)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    kw = dict(vocab=ref_cfg.vocab, seed=13, rate_hz=0.0,
              prompt_lens=(5, 9, 16), max_news=(3, 6))
    r_trace, p_trace = ref_trace(4, **kw), synthetic_trace(4, **kw)
    eng = dict(lanes=2, page_size=8, n_pages=9, max_ctx=24)
    RefEngine(ref_cfg, params=ref_params, **eng).run(r_trace)
    ContinuousEngine(port_cfg, params=port_params, device="cpu",
                     **eng).run(p_trace)
    for a, b in zip(r_trace, p_trace):
        assert len(b.out_tokens) == b.max_new
        assert b.out_tokens == a.out_tokens, (
            f"request {b.rid}: port {b.out_tokens} != reference "
            f"{a.out_tokens}"
        )
