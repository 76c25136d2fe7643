"""The paper's fused single-contraction ops against the reference.

``ops.dense_act`` (eqs 3-5, B1's epilogue) and ``ops.weighted_dense`` (eq
2, B1's weighted family), forward and backward, on the CPU: the port runs
its kernels' plain versions (``interpret=True`` makes the call take the
kernel route, as in the reference), the reference runs its Pallas kernels
in interpret mode.  Inputs are made with numpy from the seeds of the
reference's ``tests/test_differential.py`` and handed to both packages;
tolerances are that file's ``TOL`` on values scaled by max(|ref|, 1): f32
(1e-4, 1e-4), bf16 (6e-2, 6e-2), and 1e-3 on the cotangents.

Also: ``Epilogue.apply`` for every activation and field, the derived
``weighted_matmul.*`` specs with their tuned schedules and plan keys, the
refusals that remain (an epilogue on the row-reduce mode or a fused spec),
the chain and int8/fp8 specs compiling beside them, and the CUDA launch
path's folding of every new mode (``cuda_gen._launch_cuda``) run against
an emulation of the kernel's arithmetic, since the kernel itself needs
the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codegen.cache as ref_cache
import repro.core.enumerate as RE
import repro_torch.codegen.cache as port_cache
import repro_torch.core.enumerate as PE
from repro import codegen as ref_codegen
from repro import grad as ref_grad
from repro import ops as ref_ops
from repro.core.cost import TPU as REF_TPU
from repro.search.plandb import plan_key as ref_plan_key
from repro_torch import codegen as port_codegen
from repro_torch import grad as port_grad
from repro_torch import ops as port_ops
from repro_torch.codegen import cuda_gen
from repro_torch.codegen.tune import TUNER_VERSION
from repro_torch.search.plandb import plan_key as port_plan_key

from test_torch_foundation import GOLDEN_HW, to_port_spec

#: tests/test_differential.py's TOL, on values scaled by max(|ref|, 1)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 6e-2)}
EXTENT_POOL = (2, 3, 4, 6, 8)   # test_differential.py:67
WD_SEEDS = tuple(range(6))      # test_differential.py:195
ACTS = ("relu", "gelu", "tanh", "silu", "id")
EPSES = (1e-5, 1e-3)


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(a, np.float32).astype(np.float64)


def _close(got, want, rtol, atol, what):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=atol, err_msg=what)


def _to(arrays, dtype):
    """numpy arrays -> (jax arrays, torch tensors), both in ``dtype``."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                  dtype))
          for a in arrays]
    return jx, tx


# --------------------------------------------------------------------------
# Epilogue
# --------------------------------------------------------------------------


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("fields", [(), ("scale",), ("bias",), ("norm",),
                                    ("scale", "bias", "norm")],
                         ids=lambda f: "+".join(f) or "none")
def test_epilogue_apply_matches_reference(act, fields):
    kw = {f: True for f in fields}
    ref = ref_codegen.Epilogue(act=act, eps=1e-3, **kw)
    port = port_codegen.Epilogue(act=act, eps=1e-3, **kw)
    assert port.vector_names == ref.vector_names
    assert port.is_identity == ref.is_identity
    assert [f.name for f in __import__("dataclasses").fields(port)] == [
        f.name for f in __import__("dataclasses").fields(ref)]
    rng = np.random.default_rng(ACTS.index(act))
    acc = rng.standard_normal((5, 7)).astype(np.float32) * 3
    vecs = {"scale": rng.standard_normal(7), "bias": rng.standard_normal(7),
            "mean": rng.standard_normal(7) * 0.1,
            "var": np.abs(rng.standard_normal(7)) + 0.5}
    vecs = {k: v.astype(np.float32).reshape(1, -1) for k, v in vecs.items()
            if k in ref.vector_names}
    want = ref.apply(jnp.asarray(acc), {k: jnp.asarray(v)
                                        for k, v in vecs.items()})
    got = port.apply(torch.from_numpy(acc), {k: torch.from_numpy(v)
                                             for k, v in vecs.items()})
    np.testing.assert_allclose(_f64(got), _f64(want), rtol=1e-6, atol=1e-6)


def test_epilogue_refusals():
    with pytest.raises(ValueError, match="unknown activation"):
        port_codegen.Epilogue(act="swish")
    # the dequant stage, once refused, is ported: qscale comes first
    assert port_codegen.Epilogue(dequant=True, bias=True).vector_names == (
        "qscale", "bias")
    assert port_codegen.Epilogue().is_identity
    # gelu is the tanh approximation, jax.nn.gelu's default
    z = torch.linspace(-4, 4, 33)
    np.testing.assert_allclose(
        _f64(port_codegen.ACTIVATIONS["gelu"](z)),
        _f64(jax.nn.gelu(jnp.asarray(z.numpy()))), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# ops.dense_act: the reference's epilogue matrix
# --------------------------------------------------------------------------


def _dense_act_inputs(act, eps):
    rng = np.random.default_rng(8000 + ACTS.index(act) * 10
                                + EPSES.index(eps))
    m, d, f = 8, 6, 4
    return (rng.standard_normal((m, d)), rng.standard_normal((d, f)),
            rng.standard_normal(f), rng.standard_normal(f) * 0.1,
            np.abs(rng.standard_normal(f)) + 0.5)


def _dense_act_oracle(x, w, beta, mean, var, act, eps):
    acc = x.astype(np.float64) @ w.astype(np.float64)
    z = (acc + beta - mean) / np.sqrt(var + eps)
    fns = {
        "relu": lambda t: np.maximum(t, 0.0),
        "gelu": lambda t: 0.5 * t * (1 + np.tanh(
            np.sqrt(2 / np.pi) * (t + 0.044715 * t ** 3))),
        "tanh": np.tanh,
        "silu": lambda t: t / (1 + np.exp(-t)),
        "id": lambda t: t,
    }
    return fns[act](z)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", EPSES)
@pytest.mark.parametrize("act", ACTS)
def test_dense_act_epilogue_matrix(act, eps, dtype):
    """Every epilogue variant of ``ops.dense_act`` on the kernel route
    against the f64 oracle (inputs rounded to ``dtype`` first) and against
    the reference's own output."""
    arrays = _dense_act_inputs(act, eps)
    jx, tx = _to(arrays, dtype)
    quantized = [_f64(t) for t in tx]
    want = _dense_act_oracle(*quantized, act, eps)
    got = port_ops.dense_act(*tx, act=act, eps=eps, interpret=True)
    ref = ref_ops.dense_act(*jx, act=act, eps=eps, interpret=True)
    assert got.dtype == getattr(torch, dtype)
    rtol, atol = TOL[dtype]
    _close(got, want, rtol, atol, f"dense_act({act}, {eps}) vs oracle")
    _close(got, ref, rtol, atol, f"dense_act({act}, {eps}) vs reference")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ("relu", "gelu", "tanh", "id"))
def test_dense_act_plain_path_matches_reference(act, dtype):
    """Off the kernel route both packages fall back to
    ``fused_dense_act_ref`` (no silu there, as in the reference)."""
    arrays = _dense_act_inputs(act, 1e-5)
    jx, tx = _to(arrays, dtype)
    got = port_ops.dense_act(*tx, act=act)
    ref = ref_ops.dense_act(*jx, act=act)
    assert got.grad_fn is None and got.dtype == getattr(torch, dtype)
    _close(got, ref, *TOL[dtype], f"plain dense_act({act})")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_dense_act_gradients_match_jax_vjp(act, dtype):
    """All five cotangents of ``ops.dense_act`` (the autograd.Function:
    accumulator recompute, epilogue VJP by torch autograd, dacc through
    ``matmul.dA``/``.dB``) against ``jax.vjp`` of the reference's."""
    eps = 1e-3
    arrays = _dense_act_inputs(act, eps)
    cot = np.random.default_rng(9000 + ACTS.index(act)).standard_normal(
        (8, 4))
    jx, tx = _to(arrays, dtype)
    tx = [t.requires_grad_(True) for t in tx]
    rout, rvjp = jax.vjp(lambda *a: ref_ops.dense_act(
        *a, act=act, eps=eps, interpret=True), *jx)
    rgrads = rvjp(jnp.asarray(cot, rout.dtype))
    pout = port_ops.dense_act(*tx, act=act, eps=eps, interpret=True)
    assert pout.grad_fn is not None
    pgrads = torch.autograd.grad(pout, tx, torch.from_numpy(cot).to(
        pout.dtype))
    tol = (1e-3, 1e-3) if dtype == "float32" else TOL[dtype]
    for name, p, r in zip(("x", "w", "beta", "mean", "var"), pgrads, rgrads):
        assert p.dtype == getattr(torch, dtype), name
        _close(p, r, *tol, f"dense_act({act}) cotangent {name}")


def test_dense_act_backward_launch_plan(monkeypatch):
    """The backward compiles the forward's spec once more (the
    accumulator) and then ``matmul.dA`` and ``matmul.dB``."""
    seen = []
    real = port_ops._tuned_kernel

    def spy(spec, dtype, **kw):
        seen.append((spec.name, kw.get("epilogue") is not None))
        return real(spec, dtype, **kw)

    monkeypatch.setattr(port_ops, "_tuned_kernel", spy)
    arrays = _dense_act_inputs("gelu", 1e-5)
    _, tx = _to(arrays, "float32")
    tx = [t.requires_grad_(True) for t in tx]
    port_ops.dense_act(*tx, interpret=True).sum().backward()
    assert seen == [("matmul", True), ("matmul", False),
                    ("matmul.dA", False), ("matmul.dB", False)]
    # differentiable=False on the kernel route leaves nothing to
    # differentiate
    out = port_ops.dense_act(*tx, interpret=True, differentiable=False)
    assert not out.requires_grad


# --------------------------------------------------------------------------
# ops.weighted_dense: the reference's seeds and extent pool
# --------------------------------------------------------------------------


def _weighted_inputs(seed):
    rng = np.random.default_rng(7000 + seed)
    m, d, f = (int(rng.choice(EXTENT_POOL)) for _ in range(3))
    return (rng.standard_normal((m, d)), rng.standard_normal((d, f)),
            rng.standard_normal(d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", WD_SEEDS)
def test_weighted_dense_matches_reference(seed, dtype):
    """Forward against the f64 einsum oracle and the reference's output;
    the three cotangents against ``jax.vjp`` of the reference's
    ``ops.weighted_dense`` (1e-3 in f32, the bf16 TOL in bf16)."""
    arrays = _weighted_inputs(seed)
    jx, tx = _to(arrays, dtype)
    oracle = np.einsum("ij,jk,j->ik", *(_f64(t) for t in tx))
    tx = [t.requires_grad_(True) for t in tx]
    pout = port_ops.weighted_dense(*tx, interpret=True)
    rout, rvjp = jax.vjp(lambda *a: ref_ops.weighted_dense(
        *a, interpret=True), *jx)
    rtol, atol = TOL[dtype]
    _close(pout, oracle, rtol, atol, f"weighted_dense seed={seed} oracle")
    _close(pout, rout, rtol, atol, f"weighted_dense seed={seed} reference")
    cot = np.random.default_rng(7100 + seed).standard_normal(oracle.shape)
    rgrads = rvjp(jnp.asarray(cot, rout.dtype))
    pgrads = torch.autograd.grad(pout, tx, torch.from_numpy(cot).to(
        pout.dtype))
    tol = (1e-3, 1e-3) if dtype == "float32" else TOL[dtype]
    for name, p, r in zip(("dx", "dw", "dg"), pgrads, rgrads):
        assert p.dtype == getattr(torch, dtype), name
        _close(p, r, *tol, f"weighted_dense cotangent {name} seed={seed}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_dense_plain_path_rounds_the_zipper(dtype):
    """Off the kernel route ``x * g`` is rounded in x's dtype before the
    f32-accumulated product, as the reference's fallback."""
    arrays = _weighted_inputs(3)
    jx, tx = _to(arrays, dtype)
    got = port_ops.weighted_dense(*tx)
    ref = ref_ops.weighted_dense(*jx)
    scaled = (tx[0] * tx[2][None, :]).float()
    torch.testing.assert_close(got, (scaled @ tx[1].float()).to(got.dtype))
    _close(got, ref, *TOL[dtype], "plain weighted_dense")


def test_weighted_dense_backward_launch_plan(monkeypatch):
    seen = []
    real = port_ops._tuned_kernel

    def spy(spec, dtype, **kw):
        seen.append(spec.name)
        return real(spec, dtype, **kw)

    monkeypatch.setattr(port_ops, "_tuned_kernel", spy)
    _, tx = _to(_weighted_inputs(0), "float32")
    tx = [t.requires_grad_(True) for t in tx]
    port_ops.weighted_dense(*tx, interpret=True).sum().backward()
    assert seen == ["weighted_matmul", "weighted_matmul.dA",
                    "weighted_matmul.dB", "weighted_matmul.dg"]


# --------------------------------------------------------------------------
# the derived weighted_matmul specs, their schedules and keys
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdf", [(6, 4, 8), (2048, 4096, 12288)],
                         ids=["small", "qwen3-8b-mlp"])
def test_weighted_derived_specs_and_keys_equal_reference(mdf, dtype):
    from repro.codegen.tune import tune_schedule as ref_tune

    ref, port = RE.weighted_matmul_spec(*mdf), PE.weighted_matmul_spec(*mdf)
    t_dt, np_dt = getattr(torch, dtype), np.dtype(getattr(jnp, dtype))
    extra = {"tuner": TUNER_VERSION, "keep": 3, "measured": False,
             "hw": sorted((n, v) for n, v in REF_TPU.items()
                          if isinstance(v, (int, float)))}
    rd, pd = ref_grad.derived_specs(ref), port_grad.derived_specs(port)
    assert list(pd) == list(rd) == ["A", "B", "g"]
    for r, p in [(ref, port)] + [(rd[w], pd[w]) for w in rd]:
        assert p == to_port_spec(r), r.name
        rt = ref_tune(r, dtype=np_dt)
        pt = port_codegen.tune_schedule(p, dtype=t_dt)
        assert port_cache.schedule_to_dict(pt) == \
            ref_cache.schedule_to_dict(rt), r.name
        assert port_cache.cache_key(
            p, dtype=t_dt, hardware=GOLDEN_HW, extra=extra
        ) == ref_cache.cache_key(r, dtype=np_dt, hardware=GOLDEN_HW,
                                 extra=extra)
        for kw in ({}, {"phase": "prefill"}, {"phase": "decode"}):
            assert port_plan_key(p, t_dt, GOLDEN_HW, **kw) == \
                ref_plan_key(r, np_dt, GOLDEN_HW, **kw)


def test_weighted_specs_classify_by_index_sets():
    """Each spec of the family takes the kernel mode its index sets call
    for, whatever its name."""
    spec = PE.weighted_matmul_spec(6, 4, 8)
    d = port_grad.derived_specs(spec)
    modes = {s.name: cuda_gen._classify(s) for s in (spec, *d.values())}
    assert modes["weighted_matmul"].kind == "vector"
    assert modes["weighted_matmul.dA"].kind == "vector"
    assert modes["weighted_matmul.dB"].kind == "vector"
    assert modes["weighted_matmul.dg"] == cuda_gen.Fold(
        "row_reduce", "dout", "B", ("i", "j"), "A")
    renamed = PE.ContractionSpec(
        name="anything", operands={"s": ("p",), "X": ("q", "p"),
                                   "Y": ("p", "r")},
        output=("q", "r"), extents={"p": 3, "q": 4, "r": 5})
    assert cuda_gen._classify(renamed).kind == "vector"


def test_chain_and_quant_specs_still_raise_naming_item_2b():
    """The chain and int8/fp8 specs this slice refused are ported since
    (queue A item 2b): they compile and compute.  What stays refused: an
    epilogue on the row-reduce mode and on a fused spec."""
    chain = PE.chain_matmul_spec(4, 6, 8, 10)
    kern = port_codegen.compile(chain, port_codegen.default_schedule(chain))
    a, b, c = torch.randn(4, 6), torch.randn(6, 8), torch.randn(8, 10)
    torch.testing.assert_close(kern(a, b, c), a @ b @ c, rtol=1e-4,
                               atol=1e-4)
    q = PE.quantize_spec(PE.matmul_spec(8, 8, 8), fmt="int8")
    assert port_codegen.compile(q, port_codegen.default_schedule(q)) \
        .spec.root().quant is not None
    assert port_ops.dense(torch.randn(8, 8), torch.randn(8, 8),
                          quant="fp8").shape == (8, 8)
    assert callable(port_grad.chain_dense_vjp("float32", False))
    # an epilogue on the row-reduce mode and on a fused spec is refused
    dg = port_grad.derived_specs(PE.weighted_matmul_spec(4, 6, 8))["g"]
    with pytest.raises(NotImplementedError, match="no epilogue"):
        port_codegen.compile(dg, port_codegen.default_schedule(dg),
                             epilogue=port_codegen.Epilogue(act="relu"))
    grouped = PE.grouped_matmul_spec((2, 3), 4, 4)
    with pytest.raises(NotImplementedError, match="take no epilogue"):
        port_codegen.compile(grouped, port_codegen.default_schedule(grouped),
                             epilogue=port_codegen.Epilogue(act="relu"))


def test_compiled_kernel_takes_epilogue_vectors_by_keyword():
    spec = PE.matmul_spec(4, 6, 8)
    epi = port_codegen.Epilogue(act="relu", bias=True, norm=True)
    kern = port_codegen.cached_compile(spec,
                                       port_codegen.default_schedule(spec),
                                       epilogue=epi)
    a, b = torch.randn(4, 6), torch.randn(6, 8)
    with pytest.raises(TypeError, match="missing"):
        kern(a, b, bias=torch.zeros(8))
    with pytest.raises(TypeError, match="unexpected"):
        kern(a, b, bias=torch.zeros(8), mean=torch.zeros(8),
             var=torch.ones(8), scale=torch.ones(8))
    out = kern(a, b, bias=torch.zeros(8), mean=torch.zeros(8),
               var=torch.ones(8) - 1e-5)
    torch.testing.assert_close(out, torch.relu(a @ b), rtol=1e-4, atol=1e-5)
    # memoized with the epilogue in the key
    assert port_codegen.cached_compile(
        spec, port_codegen.default_schedule(spec), epilogue=epi) is kern
    assert port_codegen.cached_compile(
        spec, port_codegen.default_schedule(spec)) is not kern


# --------------------------------------------------------------------------
# the CUDA launch path's folding, against an emulation of the kernel
# --------------------------------------------------------------------------


def _emulated_contract(a, b, out_dtype, *, kscale=None, mul=None,
                       epilogue=None, vectors=None, t=None):
    """contract.cu's arithmetic on CPU tensors: the (batch, m, n, k)
    coordinates index each vector as (coord // div) % len."""
    batch, m, k = a.shape
    n = b.shape[2]
    coords = (torch.arange(batch), torch.arange(m), torch.arange(n),
              torch.arange(k))
    shape = {0: (batch, 1, 1), 1: (1, m, 1), 2: (1, 1, n)}

    def at(vec):
        x = vec.tensor
        return x[(coords[vec.axis] // vec.div) % x.numel()]

    af = a.float()
    if kscale is not None:
        af = (af * at(kscale)[None, None, :]).to(a.dtype).float()
    acc = torch.bmm(af, b.float())
    if t is not None:
        return (acc[0] * t.float()).sum(0).to(out_dtype)
    if mul is not None:
        acc = acc * at(mul).reshape(shape[mul.axis])
    if epilogue is not None:
        acc = epilogue.apply(acc, {name: at(v).reshape(shape[v.axis])
                                   for name, v in vectors.items()})
    return acc.to(out_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_folding_against_an_emulated_kernel(monkeypatch, dtype):
    """``_launch_cuda`` folds the weighted family, epilogues on m, n and
    batch axes and a multi-index k-scale exactly as ``contract_ref``
    computes them, given the kernel's arithmetic."""
    monkeypatch.setattr(cuda_gen, "CONTRACT", _emulated_contract)
    dt = getattr(torch, dtype)
    spec = PE.weighted_matmul_spec(7, 10, 5)
    specs = [(s, None) for s in (spec, *port_grad.derived_specs(
        spec).values())]
    epi = port_codegen.Epilogue(act="gelu", scale=True, bias=True, norm=True)
    specs += [
        (PE.matmul_spec(6, 9, 4), epi),
        (PE.ContractionSpec(name="mt", operands={"A": ("i", "j"),
                                                 "B": ("j", "k")},
                            output=("k", "i"),
                            extents={"i": 6, "j": 9, "k": 4}), epi),
        (PE.ContractionSpec(name="bt", operands={"A": ("b", "i", "j"),
                                                 "B": ("b", "j", "k")},
                            output=("k", "i", "b"),
                            extents={"b": 3, "i": 5, "j": 4, "k": 2}), epi),
        # g on one of two reduce indices: a k-scale with div > 1
        (PE.ContractionSpec(name="w2", operands={"A": ("i", "p", "q"),
                                                 "B": ("p", "q", "k"),
                                                 "g": ("p",)},
                            output=("i", "k"),
                            extents={"i": 4, "p": 3, "q": 5, "k": 6}), None),
        # g on an output row inside a two-index m group
        (PE.ContractionSpec(name="w3", operands={"A": ("i", "r", "j"),
                                                 "B": ("j", "k"),
                                                 "g": ("i",)},
                            output=("i", "r", "k"),
                            extents={"i": 3, "r": 4, "j": 5, "k": 6}), None),
    ]
    rng = np.random.default_rng(5)
    for sp, ep in specs:
        arrays = {name: torch.from_numpy(rng.standard_normal(
            [sp.extents[i] for i in axes]).astype(np.float32)).to(dt)
            for name, axes in sp.operands.items()}
        vecs = {}
        if ep is not None:
            n = sp.extents[sp.output[-1]]
            vecs = {"scale": torch.randn(n), "bias": torch.randn(n),
                    "mean": torch.randn(n) * 0.1, "var": torch.rand(n) + 0.5}
        got = cuda_gen._launch_cuda(sp, *arrays.values(), out_dtype=dt,
                                    epilogue=ep, vectors=vecs)
        want = cuda_gen.contract_ref(sp, *arrays.values(), out_dtype=dt,
                                     epilogue=ep, vectors=vecs)
        assert got.shape == want.shape and got.dtype == dt, sp.name
        _close(got, want, *TOL[dtype], sp.name)
