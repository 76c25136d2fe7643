"""The port's gradients against the reference: derived specs and VJPs.

Inputs are made with numpy from a seed and handed to both packages; the
reference runs its Pallas kernels in interpret mode (``interpret=True``),
the port runs its kernels' plain versions (CPU tensors).  Tolerances are
the reference's ``tests/test_grad.py`` ``TOL``, on values scaled by
max|ref|: f32 (2e-4, 2e-4), bf16 (6e-2, 6e-2).

* ``grad.derive``: every derived spec (matmul, batched, transposed, the
  grouped dX/dW, the attention specs) equals the reference's, and so do
  its tuned schedule, cache key and plan keys;
* ``ops.dense`` (128-aligned kernel path and the plain path),
  ``batched_dense``, ``dense_transposed`` and ``grouped_dense`` (ragged,
  empty and size-1 groups), f32 and bf16, against ``jax.vjp`` of the
  reference's same entry point; ``dense_vjp`` with a 3-D ``x``;
* the grouped dW mode (kernel B4's plain version, ``grouped_dw_ref``,
  reached through ``codegen.compile``) against the reference's
  ``_grouped_dw_fn`` in interpret mode, in both operand orders;
* ``differentiable=False`` on a kernel path leaves nothing to
  differentiate, and the VJPs of modes not yet ported (chain, attention)
  raise.
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
from repro_torch.codegen.tune import TUNER_VERSION
from repro_torch.search.plandb import plan_key as port_plan_key

from test_torch_foundation import GOLDEN_HW, to_port_spec

#: (rtol, atol) on values scaled by max|ref|: tests/test_grad.py's TOL
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (6e-2, 6e-2)}


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(a, np.float32).astype(np.float64)


def _assert_close(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=atol, err_msg=what)


def _both(arrays, dtype):
    """numpy f32 arrays -> (jax arrays, torch tensors) in ``dtype``."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.tensor(a).to(getattr(torch, dtype)).requires_grad_(True)
          for a in arrays]
    return jx, tx


def _port_vjp(fn, tensors, cot):
    out = fn(*tensors)
    grads = torch.autograd.grad(out, tensors, cot)
    return out, grads


# --------------------------------------------------------------------------
# grad.derive
# --------------------------------------------------------------------------


def _spec_pairs():
    sizes = (3, 0, 5, 1)
    return [
        (RE.matmul_spec(128, 256, 384), PE.matmul_spec(128, 256, 384)),
        (RE.batched_matmul_spec(2, 4, 6, 8), PE.batched_matmul_spec(2, 4, 6, 8)),
        (RE.transposed_matmul_spec(4, 6, 8), PE.transposed_matmul_spec(4, 6, 8)),
        (RE.grouped_matmul_spec(sizes, 16, 24),
         PE.grouped_matmul_spec(sizes, 16, 24)),
        (RE.grouped_matmul_spec((320,) * 4, 256, 128),
         PE.grouped_matmul_spec((320,) * 4, 256, 128)),
        (RE.attention_spec(2, 8, 8, 4, causal=True),
         PE.attention_spec(2, 8, 8, 4, causal=True)),
    ]


@pytest.mark.parametrize("pair", _spec_pairs(),
                         ids=lambda p: f"{p[0].name}-{p[0].extents}")
def test_derived_specs_equal_reference(pair):
    ref, port = pair
    rd, pd = ref_grad.derived_specs(ref), port_grad.derived_specs(port)
    assert list(pd) == list(rd)
    for wrt in rd:
        assert pd[wrt] == to_port_spec(rd[wrt]), wrt
        assert pd[wrt].name == rd[wrt].name == f"{ref.name}.d{wrt}"
        assert port_grad.derived_spec(port, wrt) == pd[wrt]
    assert port_grad.COTANGENT == ref_grad.COTANGENT == "dout"


def test_derive_refusals_match_reference():
    for bad in ("C", "dout"):
        for mod, spec in ((ref_grad, RE.matmul_spec(4, 4, 4)),
                          (port_grad, PE.matmul_spec(4, 4, 4))):
            with pytest.raises(ValueError):
                mod.derived_spec(spec, bad)
    for mod, E in ((ref_grad, RE), (port_grad, PE)):
        spec = E.ContractionSpec(
            name="rowsum", operands={"A": ("i", "j")}, output=("i",),
            extents={"i": 4, "j": 4},
        )
        with pytest.raises(NotImplementedError):
            mod.derived_spec(spec, "A")


@pytest.mark.parametrize("pair", _spec_pairs()[:5],
                         ids=lambda p: f"{p[0].name}-{p[0].extents}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_derived_spec_keys_equal_reference(pair, dtype):
    """Each backward GEMM keys its own derived spec: tuned schedule, cache
    key and plan keys equal the reference's."""
    from repro.codegen.tune import tune_schedule as ref_tune

    ref, port = pair
    t_dt, np_dt = getattr(torch, dtype), np.dtype(getattr(jnp, dtype))
    extra = {"tuner": TUNER_VERSION, "keep": 3, "measured": False,
             "hw": sorted((n, v) for n, v in REF_TPU.items()
                          if isinstance(v, (int, float)))}
    rd, pd = ref_grad.derived_specs(ref), port_grad.derived_specs(port)
    for wrt in rd:
        rt = ref_tune(rd[wrt], dtype=np_dt)
        pt = port_codegen.tune_schedule(pd[wrt], dtype=t_dt)
        assert port_cache.schedule_to_dict(pt) == \
            ref_cache.schedule_to_dict(rt), wrt
        assert port_cache.cache_key(
            pd[wrt], dtype=t_dt, hardware=GOLDEN_HW, extra=extra
        ) == ref_cache.cache_key(rd[wrt], dtype=np_dt, hardware=GOLDEN_HW,
                                 extra=extra)
        for kw in ({}, {"phase": "prefill"}, {"phase": "decode"}):
            assert port_plan_key(pd[wrt], t_dt, GOLDEN_HW, **kw) == \
                ref_plan_key(rd[wrt], np_dt, GOLDEN_HW, **kw)


# --------------------------------------------------------------------------
# the VJPs against jax.vjp
# --------------------------------------------------------------------------


def _vjp_case(ref_fn, port_fn, arrays, cot, dtype, what):
    jx, tx = _both(arrays, dtype)
    rout, rvjp = jax.vjp(ref_fn, *jx)
    rgrads = rvjp(jnp.asarray(cot).astype(rout.dtype))
    pout, pgrads = _port_vjp(
        port_fn, tx, torch.tensor(cot).to(getattr(torch, dtype)))
    _assert_close(pout, rout, dtype, f"{what} forward")
    for i, (p, r) in enumerate(zip(pgrads, rgrads)):
        assert p.dtype == getattr(torch, dtype), (what, i)
        _assert_close(p, r, dtype, f"{what} grad of operand {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interpret", [True, False],
                         ids=["kernel", "plain"])
def test_dense_vjp_matches_reference(dtype, interpret):
    rng = np.random.default_rng(100)
    x = rng.standard_normal((128, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    cot = rng.standard_normal((128, 128)).astype(np.float32)
    _vjp_case(lambda a, b: ref_ops.dense(a, b, interpret=interpret),
              lambda a, b: port_ops.dense(a, b, interpret=interpret),
              (x, w), cot, dtype, f"dense interpret={interpret}")


def test_dense_kernel_path_runs_the_derived_specs(monkeypatch):
    """On the kernel path the backward goes through the autograd.Function
    and compiles matmul.dA and matmul.dB through ``_tuned_kernel``."""
    seen = []
    real = port_ops._tuned_kernel

    def spy(spec, dtype, **kw):
        seen.append(spec.name)
        return real(spec, dtype, **kw)

    monkeypatch.setattr(port_ops, "_tuned_kernel", spy)
    x = torch.randn(128, 128, requires_grad=True)
    w = torch.randn(128, 256, requires_grad=True)
    out = port_ops.dense(x, w, interpret=True)
    assert type(out.grad_fn).__name__ == "_DenseBackward"
    out.sum().backward()
    assert seen == ["matmul", "matmul.dA", "matmul.dB"]
    ones = torch.ones(128, 256)
    torch.testing.assert_close(x.grad, ones @ w.detach().T)
    torch.testing.assert_close(w.grad, x.detach().T @ ones)


def test_dense_vjp_with_3d_x_uses_the_f32_einsum():
    rng = np.random.default_rng(101)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    cot = rng.standard_normal((2, 3, 5)).astype(np.float32)
    _vjp_case(ref_grad.dense_vjp("float32", True),
              port_grad.dense_vjp("float32", True),
              (x, w), cot, "float32", "dense_vjp 3-D x")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_dense_vjp_matches_reference(dtype):
    rng = np.random.default_rng(200)
    x = rng.standard_normal((2, 4, 6)).astype(np.float32)
    w = rng.standard_normal((2, 6, 8)).astype(np.float32)
    cot = rng.standard_normal((2, 4, 8)).astype(np.float32)
    _vjp_case(lambda a, b: ref_ops.batched_dense(a, b, interpret=True),
              lambda a, b: port_ops.batched_dense(a, b, interpret=True),
              (x, w), cot, dtype, "batched_dense")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_transposed_vjp_matches_reference(dtype):
    rng = np.random.default_rng(400)
    a = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal((6, 8)).astype(np.float32)
    cot = rng.standard_normal((4, 8)).astype(np.float32)
    _vjp_case(lambda p, q: ref_ops.dense_transposed(p, q, interpret=True),
              lambda p, q: port_ops.dense_transposed(p, q, interpret=True),
              (a, b), cot, dtype, "dense_transposed")


@pytest.mark.parametrize("sizes", [(3, 0, 4, 1), (0, 5, 1, 0, 2), (6,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interpret", [True, False],
                         ids=["kernel", "plain"])
def test_grouped_vjp_matches_reference(sizes, dtype, interpret):
    rng = np.random.default_rng(17000 + sum(sizes))
    x = rng.standard_normal((sum(sizes), 8)).astype(np.float32)
    w = rng.standard_normal((len(sizes), 8, 16)).astype(np.float32)
    cot = rng.standard_normal((sum(sizes), 16)).astype(np.float32)
    _vjp_case(
        lambda a, b: ref_ops.grouped_dense(a, b, sizes, interpret=interpret),
        lambda a, b: port_ops.grouped_dense(a, b, sizes,
                                            interpret=interpret),
        (x, w), cot, dtype, f"grouped_dense {sizes} interpret={interpret}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_vjp_off_the_kernel_path_is_the_per_group_loop(dtype):
    """``grouped_vjp`` called with a CPU tensor and ``interpret=False``:
    the forward is the plain loop and the backward the per-group loop,
    as the reference's own non-kernel backward."""
    sizes = (3, 0, 4, 1)
    rng = np.random.default_rng(17100)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8, 16)).astype(np.float32)
    cot = rng.standard_normal((8, 16)).astype(np.float32)
    _vjp_case(ref_grad.grouped_vjp(sizes, dtype, False),
              port_grad.grouped_vjp(sizes, dtype, False),
              (x, w), cot, dtype, "grouped_vjp off the kernel path")


def test_grouped_kernel_path_backward_runs_dx_and_dw(monkeypatch):
    seen = []
    real = port_ops._tuned_kernel

    def spy(spec, dtype, **kw):
        seen.append(spec.name)
        return real(spec, dtype, **kw)

    monkeypatch.setattr(port_ops, "_tuned_kernel", spy)
    sizes = (2, 0, 3)
    x = torch.randn(5, 4, requires_grad=True)
    w = torch.randn(3, 4, 6, requires_grad=True)
    out = port_ops.grouped_dense(x, w, sizes, interpret=True)
    out.backward(torch.randn(5, 6))
    assert seen == ["grouped_matmul", "grouped_matmul.dX",
                    "grouped_matmul.dW"]
    assert bool((w.grad[1] == 0).all())  # empty group: exact zeros


# --------------------------------------------------------------------------
# the grouped dW mode (kernel B4's plain version)
# --------------------------------------------------------------------------


def _dw_spec(E, sizes, k1, k2, dout_first):
    ops_ = {"dout": ("n", "f"), "X": ("n", "k")}
    if not dout_first:
        ops_ = {"X": ("n", "k"), "dout": ("n", "f")}
    return E.GroupedSpec(
        name="grouped_matmul.dW", operands=ops_, output=("g", "k", "f"),
        extents={"n": sum(sizes), "k": k1, "f": k2, "g": len(sizes)},
        group_sizes=tuple(sizes),
    )


@pytest.mark.parametrize("sizes", [(3, 0, 4, 1), (1, 1, 0, 0, 6), (9,)])
@pytest.mark.parametrize("dout_first", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_dw_mode_matches_reference_kernel(sizes, dout_first, dtype):
    rng = np.random.default_rng(16000 + len(sizes))
    x = rng.standard_normal((sum(sizes), 8)).astype(np.float32)
    d = rng.standard_normal((sum(sizes), 16)).astype(np.float32)
    ref_spec = _dw_spec(RE, sizes, 8, 16, dout_first)
    port_spec = _dw_spec(PE, sizes, 8, 16, dout_first)
    assert port_spec == to_port_spec(ref_spec)
    ref_kern = ref_codegen.compile(ref_spec,
                                   ref_codegen.default_schedule(ref_spec),
                                   interpret=True)
    port_kern = port_codegen.compile(port_spec,
                                     port_codegen.default_schedule(port_spec))
    jx, tx = _both((x, d), dtype)
    order = (1, 0) if dout_first else (0, 1)
    want = ref_kern(*(jx[i] for i in order))
    got = port_kern(*(tx[i].detach() for i in order))
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, want, dtype, f"grouped dW {sizes}")
    direct = port_codegen.grouped_dw_ref(tx[0].detach(), tx[1].detach(),
                                         sizes, out_dtype=got.dtype)
    assert torch.equal(direct, got)
    for g, s in enumerate(sizes):
        if not s:
            assert bool((got[g] == 0).all()), g


def test_grouped_dw_ref_is_the_per_group_product():
    sizes = (2, 0, 3)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 4, generator=gen).bfloat16()
    d = torch.randn(5, 6, generator=gen).bfloat16()
    out = port_codegen.grouped_dw_ref(x, d, sizes, out_dtype=torch.float32)
    xd, dd = x.double(), d.double()
    torch.testing.assert_close(out[0].double(), xd[:2].T @ dd[:2])
    torch.testing.assert_close(out[2].double(), xd[2:].T @ dd[2:])
    assert bool((out[1] == 0).all())


def test_grouped_dw_launcher_refuses_cpu_tensors():
    table = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        port_codegen.GROUPED_DW(torch.zeros(2, 3), torch.zeros(2, 4), table,
                                torch.float32)


# --------------------------------------------------------------------------
# differentiable=False and the modes still to port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["dense", "batched", "transposed", "grouped"])
def test_differentiable_false_has_no_vjp(op):
    x = torch.randn(128, 128, requires_grad=True)
    if op == "dense":
        out = port_ops.dense(x, torch.randn(128, 128), interpret=True,
                             differentiable=False)
    elif op == "batched":
        out = port_ops.batched_dense(x[None], torch.randn(1, 128, 8),
                                     interpret=True, differentiable=False)
    elif op == "transposed":
        out = port_ops.dense_transposed(x, torch.randn(128, 8),
                                        interpret=True, differentiable=False)
    else:
        out = port_ops.grouped_dense(x, torch.randn(2, 128, 8), (100, 28),
                                     interpret=True, differentiable=False)
    assert not out.requires_grad
    with pytest.raises(RuntimeError):
        torch.sum(out).backward()


def test_plain_paths_stay_natively_differentiable():
    x = torch.randn(6, 4, requires_grad=True)
    out = port_ops.dense(x, torch.randn(4, 5), differentiable=False)
    assert out.requires_grad  # not a kernel path: a plain torch op


@pytest.mark.parametrize("factory,args,item", [
    (port_grad.chain_dense_vjp, ("float32", False), "item 2b"),
    (port_grad.chain_dense_vjp, ("bfloat16", True), "item 2b"),
    (lambda *a: port_ops.dense(*a, quant="int8"),
     (torch.ones(4, 4), torch.ones(4, 4)), "item 2b"),
    (port_grad.attention_vjp, (True, "float32", False), "item 5"),
])
def test_unported_vjps_name_their_roadmap_item(factory, args, item):
    """The VJPs (and the quant tier) still waiting for their forward modes
    raise, naming their ROADMAP.md queue-A item; ``weighted_dense_vjp`` and
    ``dense_act_vjp`` are ported (tests/test_torch_fused.py)."""
    with pytest.raises(NotImplementedError, match=item):
        factory(*args)
