"""The generated contraction kernel (B1): the port against the reference.

* the port's ``CompiledKernel`` on CPU tensors (the kernel's plain
  version, ``contract_ref``) against the reference's
  ``codegen.compile(spec, sched, interpret=True)`` over two-operand specs x
  random legal schedules x float32/bfloat16, at the reference's ``TOL``;
* the spec -> (batch, m, k, n) folding the CUDA path performs, with the
  launcher replaced by a CPU batched product, against ``contract_ref``;
* ``ops.dense(interpret=True)`` on both sides at a 128-aligned shape, and
  an unaligned shape taking the ``torch.matmul`` route on both sides;
* ``NotImplementedError`` for a mesh request on a fused family (the
  reference's refusal; a product binds to a mesh, ``tests/
  test_torch_mesh_gen.py``) and an unported tuner option; the dequant
  epilogue, the chain and the quant specs, once
  refused, now compile (``tests/test_torch_quant.py`` and
  ``tests/test_torch_chain.py`` hold them to the reference; attention
  specs, ``tests/test_torch_attention.py``).

The CUDA kernel itself is tested on a card by ``tests/test_torch_gpu.py``.
"""

from __future__ import annotations

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.enumerate as RE
import repro_torch.core.enumerate as PE
from repro import codegen as ref_codegen
from repro import ops as ref_ops
from repro_torch import codegen as port_codegen
from repro_torch import obs
from repro_torch import ops as port_ops
from repro_torch.codegen import cuda_gen

TOL = {  # the reference's tests/test_differential.py tolerances
    "float32": (1e-4, 1e-4),
    "bfloat16": (6e-2, 6e-2),
}


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


def _reduce_one_side(mod, i, j, r, k):
    """A[i,j,r] B[j,k] -> C[i,k]: ``r`` is reduced on A alone."""
    return mod.ContractionSpec(
        name="one_side_reduce",
        operands={"A": ("i", "j", "r"), "B": ("j", "k")},
        output=("i", "k"),
        extents={"i": i, "j": j, "r": r, "k": k},
    )


def _two_reduce(mod, i, j, k, p):
    """A[i,j,k] B[j,k,p] -> C[i,p]: a tensor contraction over (j, k)."""
    return mod.ContractionSpec(
        name="two_reduce",
        operands={"A": ("i", "j", "k"), "B": ("j", "k", "p")},
        output=("i", "p"),
        extents={"i": i, "j": j, "k": k, "p": p},
    )


def _out_permuted(mod, b, i, j, k):
    """A[b,i,j] B[j,k] -> C[k,b,i]: output axes out of (batch, m, n) order."""
    return mod.ContractionSpec(
        name="out_permuted",
        operands={"A": ("b", "i", "j"), "B": ("j", "k")},
        output=("k", "b", "i"),
        extents={"b": b, "i": i, "j": j, "k": k},
    )


#: family -> (builder(module, *extents), arity, seed offset)
FAMILIES = {
    "matmul": (lambda m, *a: m.matmul_spec(*a), 3, 1000),
    "matvec": (lambda m, *a: m.matvec_spec(*a), 2, 2000),
    "batched_matmul": (lambda m, *a: m.batched_matmul_spec(*a), 4, 4000),
    "transposed_matmul": (lambda m, *a: m.transposed_matmul_spec(*a), 3,
                          5000),
    "one_side_reduce": (_reduce_one_side, 4, 7000),
    "two_reduce": (_two_reduce, 4, 8000),
    "out_permuted": (_out_permuted, 4, 9000),
}
EXTENT_POOL = (2, 3, 4, 6, 8, 16)
SEEDS = range(3)
CASES = [(fam, seed, dt) for fam in FAMILIES for seed in SEEDS
         for dt in ("float32", "bfloat16")]


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def _draw(family, seed):
    build, arity, offset = FAMILIES[family]
    rng = np.random.default_rng(offset + seed)
    extents = [int(rng.choice(EXTENT_POOL)) for _ in range(arity)]
    ref, port = build(RE, *extents), build(PE, *extents)
    blocks = {i: int(rng.choice(_divisors(ref.extents[i])))
              for i in ref.indices}
    arrays = {
        n: rng.standard_normal(
            [ref.extents[i] for i in axes]
        ).astype(np.float32)
        for n, axes in ref.operands.items()
    }
    return ref, port, blocks, arrays


@pytest.mark.parametrize("family,seed,dtype", CASES)
def test_plain_version_matches_reference_kernel(family, seed, dtype):
    ref, port, blocks, arrays = _draw(family, seed)
    rk = ref_codegen.compile(
        ref, ref_codegen.default_schedule(ref, blocks), interpret=True
    )
    want = np.asarray(
        rk(*(jnp.asarray(arrays[n], dtype) for n in ref.operands)),
        np.float64,
    )
    pk = port_codegen.compile(port, port_codegen.default_schedule(port,
                                                                  blocks))
    got = pk(*(torch.from_numpy(arrays[n]).to(getattr(torch, dtype))
               for n in port.operands))
    assert got.dtype == getattr(torch, dtype)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol,
                               atol=atol)


class _CpuLauncher:
    """Stands in for the CUDA launcher: the same (batch, M, K) x (batch,
    K, N) contract, computed with a CPU batched product."""

    def __init__(self):
        self.launches = 0
        self.shapes = []

    def __call__(self, a, b, out_dtype):
        assert a.dim() == b.dim() == 3 and a.dtype == b.dtype
        self.launches += 1
        self.shapes.append((tuple(a.shape), tuple(b.shape)))
        return torch.bmm(a.float(), b.float()).to(out_dtype)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cuda_folding_matches_plain_version(family, monkeypatch):
    """What ``_launch_cuda`` hands the kernel, and how it unfolds the
    result, reproduces ``contract_ref`` for every family."""
    fake = _CpuLauncher()
    monkeypatch.setattr(cuda_gen, "CONTRACT", fake)
    _, port, _, arrays = _draw(family, 0)
    ops = [torch.from_numpy(arrays[n]) for n in port.operands]
    got = cuda_gen._launch_cuda(port, *ops, out_dtype=torch.float32)
    want = cuda_gen.contract_ref(port, *ops, out_dtype=torch.float32)
    assert fake.launches == 1
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_matmul_folds_without_copies(monkeypatch):
    """The serving GEMM reaches the launcher as (1, M, K) x (1, K, N)
    views of the operands themselves."""
    seen = []

    def launcher(a, b, out_dtype):
        seen.append((a, b))
        return torch.bmm(a, b).to(out_dtype)

    monkeypatch.setattr(cuda_gen, "CONTRACT", launcher)
    x, w = torch.randn(128, 256), torch.randn(256, 384)
    cuda_gen._launch_cuda(PE.matmul_spec(128, 256, 384), x, w,
                          out_dtype=torch.float32)
    (a, b), = seen
    assert a.shape == (1, 128, 256) and b.shape == (1, 256, 384)
    assert a.data_ptr() == x.data_ptr() and b.data_ptr() == w.data_ptr()


def test_dense_interpret_matches_reference_at_aligned_shape():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    want = np.asarray(ref_ops.dense(jnp.asarray(x), jnp.asarray(w),
                                    interpret=True))
    obs.metrics_reset()
    got = port_ops.dense(torch.from_numpy(x), torch.from_numpy(w),
                         interpret=True)
    counters = obs.metrics_json()["counters"]
    # the call went through the generated-kernel pipeline: one lookup,
    # answered by ops' process memo or by cached_compile
    assert counters.get("codegen.memo.miss", 0) + counters.get(
        "codegen.memo.hit", 0) + counters.get("ops.lookup.memo_hit", 0) == 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_dense_unaligned_takes_matmul_route_on_both_sides():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    want = np.asarray(ref_ops.dense(jnp.asarray(x), jnp.asarray(w),
                                    interpret=True))
    obs.metrics_reset()
    got = port_ops.dense(torch.from_numpy(x), torch.from_numpy(w),
                         interpret=True)
    counters = obs.metrics_json()["counters"]
    assert "codegen.memo.miss" not in counters
    assert "codegen.memo.hit" not in counters
    assert "ops.lookup.memo_hit" not in counters
    assert "ops.lookup.memo_miss" not in counters
    assert not port_ops._dense_kernel_ok(torch.from_numpy(x),
                                         torch.from_numpy(w), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dense_on_cpu_without_interpret_is_plain_matmul():
    """The device decides: a CPU tensor is not kernel-eligible unless the
    caller asks for ``interpret``, as off-TPU in the reference."""
    x, w = torch.randn(128, 128), torch.randn(128, 128)
    assert not port_ops._dense_kernel_ok(x, w, False)
    assert port_ops._dense_kernel_ok(x, w, True)
    torch.testing.assert_close(port_ops.dense(x, w), x @ w)


def test_unsupported_requests_raise_not_implemented():
    spec = PE.matmul_spec(8, 8, 8)
    sched = port_codegen.default_schedule(spec)
    # a product binds to a mesh since the mesh tier (item 6c); the fused
    # families keep the reference's refusal
    fused = PE.attention_spec(2, 8, 8, 4)
    with pytest.raises(NotImplementedError, match="mesh"):
        port_codegen.compile(fused, port_codegen.default_schedule(fused),
                             mesh=object())
    # once refused, now ported (B1's chain and int8/fp8 modes): the dequant
    # epilogue, the chain, a quantized spec and dense(quant=) compute
    x = torch.randn(8, 8)
    kern = port_codegen.compile(spec, sched,
                                epilogue=port_codegen.Epilogue(dequant=True))
    torch.testing.assert_close(kern(x, x, qscale=torch.full((8,), 2.0)),
                               2 * (x @ x))
    chain = PE.chain_matmul_spec(8, 8, 8, 8)
    out = port_codegen.compile(chain, port_codegen.default_schedule(chain))(
        x, x, x)
    torch.testing.assert_close(out, x @ x @ x, rtol=1e-4, atol=1e-4)
    q = PE.quantize_spec(spec, fmt="int8")
    ones = torch.ones(8, 8, dtype=torch.int8)
    out = port_codegen.compile(q, port_codegen.default_schedule(q))(ones,
                                                                    ones)
    assert out.dtype == torch.int32 and bool((out == 8).all())
    assert port_ops.dense(x, x, quant="int8").shape == (8, 8)


@pytest.mark.parametrize("keep", (1, 3))
def test_measured_tuning_picks_among_the_reference_top(keep, tmp_path):
    """``tune_schedule(measure_with=)``, refused until the search slice:
    the winner is one of the reference tuner's analytic top-``keep``
    (exactly its winner at ``keep=1``, where nothing is timed), stored
    under a measured key that an analytic request never reads."""
    from repro.codegen import tune as ref_tune
    from repro.core.cost import TPU

    spec_r, spec_p = RE.matmul_spec(64, 32, 128), PE.matmul_spec(64, 32, 128)
    rng = np.random.default_rng(5)
    arrays = {"A": rng.standard_normal((64, 32)).astype(np.float32),
              "B": rng.standard_normal((32, 128)).astype(np.float32)}
    scored = sorted(
        (s, sum(spec_r.extents[i] // b[i] for i in spec_r.indices
                if i not in spec_r.output), tuple(sorted(b.items())))
        for b in ref_tune.candidate_blocks(spec_r, TPU)
        for s in [ref_tune._score(spec_r, b, 4, TPU)] if s is not None)
    top = [dict(b) for _, _, b in scored[:keep]]
    cache = port_codegen.AutotuneCache(str(tmp_path / "c.json"))
    sched = port_codegen.tune_schedule(spec_p, cache=cache, keep=keep,
                                       measure_with=arrays)
    want = [port_codegen.cache.schedule_to_dict(
        port_codegen.default_schedule(spec_p, b)) for b in top]
    assert port_codegen.cache.schedule_to_dict(sched) in want
    if keep == 1:
        ref = ref_codegen.tune_schedule(spec_r, keep=1,
                                        use_default_cache=False)
        assert port_codegen.cache.schedule_to_dict(sched) == \
            ref_codegen.cache.schedule_to_dict(ref)
    port_codegen.tune_schedule(spec_p, cache=cache, keep=keep)
    assert (cache.hits, cache.misses) == (0, 2)


def test_compiled_kernel_checks_shapes_and_devices():
    spec = PE.matmul_spec(4, 6, 8)
    kern = port_codegen.cached_compile(spec,
                                       port_codegen.default_schedule(spec))
    with pytest.raises(ValueError, match="local shape"):
        kern(torch.randn(4, 5), torch.randn(6, 8))
    with pytest.raises(TypeError, match="operands"):
        kern(torch.randn(4, 6))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_gen.CONTRACT(torch.randn(1, 4, 6), torch.randn(1, 6, 8),
                          torch.float32)
    # memo: the same (spec, schedule) compiles once
    again = port_codegen.cached_compile(spec,
                                        port_codegen.default_schedule(spec))
    assert again is kern
