"""The port's chain ``A @ B @ C`` (B1's chain mode) against the reference.

Inputs are made with numpy from a seed and handed to both packages; the
reference runs its Pallas kernels in interpret mode, the port its kernels'
plain versions (CPU tensors).  Tolerances are the reference's:
``tests/test_grad.py``'s TOL on values scaled by max|ref| for
``chain_dense`` and its cotangents (f32 (2e-4, 2e-4), bf16 (6e-2, 6e-2)),
``tests/test_differential.py``'s against the f64 einsum oracle.

* ``ops.chain_dense`` forward and its three cotangents against
  ``jax.vjp`` of the reference's, f32 and bf16, on the kernel path
  (``interpret=True``) and the plain fallback;
* the derived ``chain_matmul.dA/.dB/.dC`` specs, their tuned schedules,
  cache and plan keys, and ``chain_matmul_schedule``;
* the ``chain_matmul`` rows of ``tests/test_differential.py`` (forward,
  bf16, derived backward specs) through ``codegen.compile``;
* ``_classify``'s chain fold, and ``cuda_gen._launch_cuda``'s chain
  arguments (operand views, association, epilogue vectors) against an
  emulation of the chain kernel (the kernel needs the card).
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
from repro.search import einsum_reference, reference_arrays
from repro.search.plandb import plan_key as ref_plan_key
from repro_torch import codegen as port_codegen
from repro_torch import grad as port_grad
from repro_torch import ops as port_ops
from repro_torch.codegen import cuda_gen
from repro_torch.codegen.tune import TUNER_VERSION
from repro_torch.search.plandb import plan_key as port_plan_key

from test_torch_foundation import GOLDEN_HW, to_port_spec

TOL = {"float32": (2e-4, 2e-4), "bfloat16": (6e-2, 6e-2)}  # test_grad.py
DIFF_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 6e-2)}
EXTENT_POOL = (2, 3, 4, 6, 8)  # test_differential.py
CHAIN_OFFSET = 6000


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, np.float32).astype(np.float64)


def _close(got, want, tol, what, floor=0.0):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), floor) or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol[0],
                               atol=tol[1], err_msg=what)


# --------------------------------------------------------------------------
# ops.chain_dense and its VJP against jax.vjp
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interpret", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("shape", [(8, 6, 4, 3), (33, 17, 40, 5),
                                   (128, 64, 128, 32)], ids=str)
def test_chain_dense_vjp_matches_reference(shape, interpret, dtype):
    m, k1, k2, n = shape
    rng = np.random.default_rng(800 + sum(shape))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((m, k1), (k1, k2), (k2, n))]
    cot = rng.standard_normal((m, n)).astype(np.float32)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.tensor(a).to(getattr(torch, dtype)).requires_grad_(True)
          for a in arrays]
    rout, rvjp = jax.vjp(
        lambda a, b, c: ref_ops.chain_dense(a, b, c, interpret=interpret),
        *jx)
    rgrads = rvjp(jnp.asarray(cot).astype(rout.dtype))
    pout = port_ops.chain_dense(*tx, interpret=interpret)
    pgrads = torch.autograd.grad(pout, tx,
                                 torch.tensor(cot).to(getattr(torch, dtype)))
    assert pout.dtype == getattr(torch, dtype)
    _close(pout, rout, TOL[dtype], "chain_dense forward")
    for name, p, r in zip("ABC", pgrads, rgrads):
        assert p.dtype == getattr(torch, dtype)
        _close(p, r, TOL[dtype], f"chain_dense d{name}")


def test_chain_dense_kernel_path_runs_the_derived_specs(monkeypatch):
    """Forward and backward on the kernel path: ``chain_matmul`` and then
    ``.dA``, ``.dB``, ``.dC`` through ``_tuned_kernel``; the plain path
    and ``differentiable=False`` as in the other ops."""
    seen = []
    real = port_ops._tuned_kernel

    def spy(spec, dtype, **kw):
        seen.append(spec.name)
        return real(spec, dtype, **kw)

    monkeypatch.setattr(port_ops, "_tuned_kernel", spy)
    a, b, c = (torch.randn(s, requires_grad=True)
               for s in ((6, 4), (4, 5), (5, 3)))
    out = port_ops.chain_dense(a, b, c, interpret=True)
    assert seen == ["chain_matmul"]
    out.sum().backward()
    assert sorted(seen[1:]) == ["chain_matmul.dA", "chain_matmul.dB",
                                "chain_matmul.dC"]
    seen.clear()
    # only the cotangents autograd asks for
    a2 = a.detach().requires_grad_(True)
    port_ops.chain_dense(a2, b.detach(), c.detach(),
                         interpret=True).sum().backward()
    assert seen == ["chain_matmul", "chain_matmul.dA"]
    seen.clear()
    raw = port_ops.chain_dense(a, b, c, interpret=True, differentiable=False)
    assert raw.grad_fn is None and not raw.requires_grad
    plain = port_ops.chain_dense(a, b, c)  # CPU, no interpret: torch ops
    assert seen == ["chain_matmul"] and plain.grad_fn is not None


def test_chain_dense_fallback_rounds_the_intermediate_to_a_dtype():
    """The reference's fallback rounds a @ b to a's dtype before the
    second product."""
    rng = np.random.default_rng(810)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((16, 8), (8, 12), (12, 4))]
    want = ref_ops.chain_dense(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in arrays))
    got = port_ops.chain_dense(*(torch.tensor(a).bfloat16() for a in arrays))
    np.testing.assert_array_equal(_f64(got),
                                  np.asarray(want, np.float32)
                                  .astype(np.float64))


# --------------------------------------------------------------------------
# derived specs, schedules and keys
# --------------------------------------------------------------------------


@pytest.mark.parametrize("extents", [(4, 6, 8, 10), (4096, 128, 4096, 128)],
                         ids=str)
def test_derived_chain_specs_equal_reference(extents):
    ref, port = RE.chain_matmul_spec(*extents), PE.chain_matmul_spec(*extents)
    assert port == to_port_spec(ref)
    rd, pd = ref_grad.derived_specs(ref), port_grad.derived_specs(port)
    assert list(pd) == list(rd) == ["A", "B", "C"]
    for wrt in rd:
        assert pd[wrt] == to_port_spec(rd[wrt]), wrt
        assert pd[wrt].name == f"chain_matmul.d{wrt}"
        assert cuda_gen._classify(pd[wrt]).kind == "chain", wrt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chain_schedules_and_keys_equal_reference(dtype):
    from repro.codegen.tune import tune_schedule as ref_tune

    t_dt, np_dt = getattr(torch, dtype), np.dtype(getattr(jnp, dtype))
    extra = {"tuner": TUNER_VERSION, "keep": 3, "measured": False,
             "hw": sorted((n, v) for n, v in REF_TPU.items()
                          if isinstance(v, (int, float)))}
    ref = RE.chain_matmul_spec(256, 128, 512, 64)
    port = PE.chain_matmul_spec(256, 128, 512, 64)
    pairs = [(ref, port)] + [
        (r, p) for r, p in zip(ref_grad.derived_specs(ref).values(),
                               port_grad.derived_specs(port).values())]
    for r, p in pairs:
        rt = ref_tune(r, dtype=np_dt)
        pt = port_codegen.tune_schedule(p, dtype=t_dt)
        assert port_cache.schedule_to_dict(pt) == \
            ref_cache.schedule_to_dict(rt), p.name
        assert port_cache.cache_key(p, dtype=t_dt, hardware=GOLDEN_HW,
                                    extra=extra) == \
            ref_cache.cache_key(r, dtype=np_dt, hardware=GOLDEN_HW,
                                extra=extra), p.name
        for kw in ({}, {"phase": "prefill"}, {"phase": "decode"}):
            assert port_plan_key(p, t_dt, GOLDEN_HW, **kw) == \
                ref_plan_key(r, np_dt, GOLDEN_HW, **kw), p.name
    blocks = dict(block_m=64, block_n=32, block_k1=64, block_k2=128)
    rs = ref_codegen.chain_matmul_schedule(256, 128, 512, 64, **blocks)
    ps = port_codegen.chain_matmul_schedule(256, 128, 512, 64, **blocks)
    assert port_cache.schedule_to_dict(ps) == ref_cache.schedule_to_dict(rs)


# --------------------------------------------------------------------------
# the chain_matmul rows of tests/test_differential.py
# --------------------------------------------------------------------------


def _draw(seed):
    rng = np.random.default_rng(CHAIN_OFFSET + seed)
    extents = [int(rng.choice(EXTENT_POOL)) for _ in range(4)]
    return RE.chain_matmul_spec(*extents), PE.chain_matmul_spec(*extents)


@pytest.mark.parametrize("seed", range(10))
def test_generated_chain_matches_oracle(seed):
    ref, port = _draw(seed)
    arrays = reference_arrays(ref, dtype=np.float32, seed=seed)
    want = einsum_reference(ref, arrays)
    kern = port_codegen.compile(port, port_codegen.default_schedule(port))
    got = kern(*(torch.from_numpy(arrays[n]) for n in port.operands))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f64(got), want, rtol=1e-4, atol=1e-4)


def test_generated_chain_bfloat16():
    ref, port = _draw(7)
    arrays = reference_arrays(ref, dtype=np.float32, seed=7)
    q = {n: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float64)
         for n, a in arrays.items()}
    want = einsum_reference(ref, q)
    kern = port_codegen.compile(port, port_codegen.default_schedule(port))
    got = kern(*(torch.from_numpy(arrays[n]).bfloat16()
                 for n in port.operands))
    assert got.dtype == torch.bfloat16
    _close(got, want, DIFF_TOL["bfloat16"], "bf16 chain", floor=1.0)


@pytest.mark.parametrize("seed", range(4))
def test_derived_chain_specs_are_cotangents(seed):
    ref, port = _draw(seed)
    arrays = reference_arrays(ref, dtype=np.float32, seed=9000 + seed)
    rng = np.random.default_rng(9500 + seed)
    g = rng.standard_normal(tuple(ref.extents[i] for i in ref.output)
                            ).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jnp.einsum("ij,jk,kl->il", a, b, c),
                     *(jnp.asarray(arrays[n]) for n in "ABC"))
    cots = dict(zip("ABC", vjp(jnp.asarray(g))))
    for wrt, dspec in port_grad.derived_specs(port).items():
        darrays = {port_grad.COTANGENT: g}
        darrays.update({n: arrays[n] for n in "ABC" if n != wrt})
        kern = port_codegen.compile(dspec, port_codegen.default_schedule(
            dspec))
        got = kern(*(torch.from_numpy(darrays[n]) for n in dspec.operands))
        np.testing.assert_allclose(
            _f64(got), einsum_reference(to_ref(dspec), darrays), rtol=1e-4,
            atol=1e-4, err_msg=dspec.name)
        _close(got, cots[wrt], (1e-3, 1e-3), dspec.name, floor=1.0)


def to_ref(spec):
    return RE.ContractionSpec(name=spec.name, operands=dict(spec.operands),
                              output=tuple(spec.output),
                              extents=dict(spec.extents))


# --------------------------------------------------------------------------
# _classify and the chain kernel's arguments, against an emulation
# --------------------------------------------------------------------------


def test_classify_takes_chains_in_any_orientation_and_refuses_others():
    renamed = PE.ContractionSpec(
        name="any", operands={"Z": ("c", "q"), "X": ("p", "r"),
                              "Y": ("q", "p")},
        output=("r", "c"), extents={"r": 2, "p": 3, "q": 4, "c": 5})
    fold = cuda_gen._classify(renamed)
    assert (fold.kind, fold.a, fold.b, fold.extra) == ("chain", "X", "Y",
                                                       "Z")
    for bad, out in (
        # a 1-D third operand on an index of neither product side
        ({"A": ("i", "j"), "B": ("j", "k"), "v": ("q",)}, ("i", "k")),
        # an output index held by two of the three matrices
        ({"A": ("i", "j"), "B": ("i", "k"), "C": ("k", "l")}, ("i", "l")),
    ):
        ext = {i: 3 for ax in bad.values() for i in ax}
        spec = PE.ContractionSpec(name="bad", operands=bad, output=out,
                                  extents=ext)
        with pytest.raises(NotImplementedError, match="fit none"):
            cuda_gen._classify(spec)


def _emulated_chain(calls):
    """contract_chain.cu's arithmetic on CPU tensors: T = X.Y in the
    accumulator (rounded once to bf16 for bf16 operands), then T.Z, the
    epilogue on f32, written through ``out``'s strides."""

    def run(x, y, z, out_dtype, *, epilogue=None, vectors=None, out=None,
            plan=None):
        calls.append((tuple(x.shape), tuple(y.shape), tuple(z.shape),
                      out is not None and not out.is_contiguous()))
        ints = x.dtype in (torch.int8, torch.int32)
        wide = torch.int64 if ints else torch.float32
        t = x.to(wide) @ y.to(wide)
        if x.dtype == torch.bfloat16:
            t = t.bfloat16().float()
        acc = t @ z.to(wide)
        if ints:
            acc = acc.to(torch.int32)
        if epilogue is not None:
            r, n = acc.shape
            coords = {1: torch.arange(r)[:, None],
                      2: torch.arange(n)[None, :]}
            acc = epilogue.apply(acc.float(), {
                nm: v.tensor[(coords[v.axis] // v.div) % v.tensor.numel()]
                for nm, v in vectors.items()})
        out.copy_(acc.to(out_dtype))
        return out

    return run


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_launch_folding_of_the_chain_against_an_emulation(monkeypatch,
                                                          dtype):
    """Forward and derived specs, both associations and an epilogue:
    ``_launch_cuda`` hands the chain kernel views of the operands (no
    copies) and gets ``contract_ref``'s values."""
    calls = []
    monkeypatch.setattr(cuda_gen, "CONTRACT_CHAIN", _emulated_chain(calls))
    rng = np.random.default_rng(820)
    # (R, P, Q, C): with P small, Q and C wide the transposed chain
    # recomputes less (Y.Z once per row block); with Q small the chain
    # runs as written
    for extents, right in (((40, 30, 7, 8), False), ((8, 3, 200, 300), True)):
        base = PE.chain_matmul_spec(*extents)
        specs = [base] + list(port_grad.derived_specs(base).values())
        for spec in specs:
            if dtype == "int8":
                spec = PE.quantize_spec(spec, fmt="int8")
            arrays = []
            for axes in spec.operands.values():
                v = rng.standard_normal([spec.extents[i] for i in axes])
                arrays.append(
                    torch.from_numpy(np.clip(np.round(v * 4), -127, 127))
                    .to(torch.int8) if dtype == "int8"
                    else torch.from_numpy(v.astype(np.float32))
                    .to(getattr(torch, dtype)))
            out_dtype = cuda_gen._default_out_dtype(spec, None,
                                                    arrays[0].dtype)
            calls.clear()
            got = cuda_gen._launch_cuda(spec, *arrays, out_dtype=out_dtype)
            assert len(calls) == 1, spec.name
            want = cuda_gen.contract_ref(spec, *arrays, out_dtype=out_dtype)
            assert got.shape == want.shape and got.dtype == want.dtype
            if dtype == "int8":
                assert torch.equal(got, want), spec.name
            else:
                _close(got, want, DIFF_TOL[dtype], spec.name)
            if spec.name == "chain_matmul":
                assert calls[0][3] == right, (extents, calls)
    # an epilogue along the output's last axis, either association
    epi = port_codegen.Epilogue(act="gelu", scale=True, bias=True)
    for extents in ((40, 30, 7, 8), (8, 3, 200, 300)):
        spec = PE.chain_matmul_spec(*extents)
        arrays = [torch.randn([spec.extents[i] for i in ax])
                  for ax in spec.operands.values()]
        n = extents[-1]
        vecs = {"scale": torch.randn(n), "bias": torch.randn(n)}
        got = cuda_gen._launch_cuda(spec, *arrays, out_dtype=torch.float32,
                                    epilogue=epi, vectors=vecs)
        want = cuda_gen.contract_ref(spec, *arrays, out_dtype=torch.float32,
                                     epilogue=epi, vectors=vecs)
        _close(got, want, DIFF_TOL["float32"], f"chain epilogue {extents}")


def test_association_cost_counts_the_recomputed_intermediate():
    # one qwen3-8b head's (QK^T)V shape, (R, P, Q, C) = (4096, 128, 4096,
    # 128), one 128-column block: as written each CTA forms its rows of
    # the 4096 x 4096 T once (P = 128 is two p steps: no cluster split);
    # transposed, the 32 column blocks run in clusters of 8 that split the
    # 4096-long p and share T, so the 128 x 128 Y.Z is formed 4 times
    bf16 = torch.bfloat16
    left = cuda_gen._chain_cost(4096, 128, 4096, 128, bf16)
    right = cuda_gen._chain_cost(128, 4096, 128, 4096, bf16)
    assert left == 2 * 4096 * 128 * 4096
    assert right == 128 * 4096 * 128 * 4 + 128 * 128 * 4096 < left
    # the CUDA-core body: 64-column blocks, 64 of them, 8 clusters
    assert cuda_gen._chain_cost(128, 4096, 128, 4096, torch.float32) == (
        128 * 4096 * 128 * 8 + 128 * 128 * 4096)
    assert cuda_gen._chain_cost(300, 200, 3, 8, torch.float32) < (
        cuda_gen._chain_cost(8, 3, 200, 300, torch.float32))
