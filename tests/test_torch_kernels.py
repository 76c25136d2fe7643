"""The port's hand-written kernels package against the reference's.

``repro_torch.kernels.{matmul,fused_dense_act,fused_rnz}`` -- the wrappers
of kernels B5, B6 and B7 (their plain versions on CPU tensors), the
``ops`` entries with their routing (generated B1 by default, hand-written
with ``use_generated=False``) and the ``ref`` oracles -- against the
reference's ``matmul_pallas``, ``fused_dense_act_pallas`` and
``weighted_matmul_pallas`` in interpret mode, at the shapes, blocks and
``TOL`` of the reference's ``tests/test_kernels.py``.  Also
``core.autotune.choose_matmul_blocks`` against the reference's, and the
block-divisibility refusals (``AssertionError``, the reference's kind).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.autotune import choose_matmul_blocks as ref_choose
from repro.kernels.fused_dense_act.fused_dense_act import (
    fused_dense_act_pallas,
)
from repro.kernels.fused_dense_act.ops import (
    fused_dense_act as ref_fused_dense_act,
)
from repro.kernels.fused_rnz.fused_rnz import weighted_matmul_pallas
from repro.kernels.fused_rnz.ops import weighted_matmul as ref_weighted
from repro.kernels.matmul.matmul import matmul_pallas
from repro.kernels.matmul.ops import matmul as ref_matmul
from repro_torch.core.autotune import choose_matmul_blocks
from repro_torch.kernels import _baselines
from repro_torch.kernels.fused_dense_act import ops as fda_ops
from repro_torch.kernels.fused_dense_act.fused_dense_act import (
    fused_dense_act_cuda,
)
from repro_torch.kernels.fused_dense_act.ref import fused_dense_act_ref
from repro_torch.kernels.fused_rnz import ops as rnz_ops
from repro_torch.kernels.fused_rnz.fused_rnz import weighted_matmul_cuda
from repro_torch.kernels.fused_rnz.ref import weighted_matmul_ref
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul.matmul import matmul_cuda
from repro_torch.kernels.matmul.ref import matmul_ref

#: tests/test_kernels.py's TOL
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-1)}
MATMUL_CASES = [  # tests/test_kernels.py: (m, n, k, bm, bn, bk)
    (32, 32, 32, 16, 16, 16),
    (64, 48, 80, 16, 16, 16),
    (128, 128, 64, 64, 32, 32),
    (16, 128, 256, 8, 128, 128),
]
WEIGHTED_CASES = [(32, 32, 32, 16, 16, 16), (64, 48, 96, 16, 16, 32)]


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


def rnd(*shape, dtype="float32", seed=0):
    """tests/test_kernels.py's inputs, as (jax, torch) in ``dtype``."""
    x = np.random.default_rng(seed + sum(shape)).standard_normal(shape)
    j = jnp.asarray(x, dtype=getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(
        getattr(torch, dtype))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.fixture
def no_launch():
    """The CPU paths run plain versions: no kernel is counted."""
    before = [k.launches for k in (_baselines.MATMUL,
                                   _baselines.FUSED_DENSE_ACT,
                                   _baselines.FUSED_RNZ)]
    yield
    assert [k.launches for k in (_baselines.MATMUL,
                                 _baselines.FUSED_DENSE_ACT,
                                 _baselines.FUSED_RNZ)] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", MATMUL_CASES)
def test_matmul_matches_reference_kernel(m, n, k, bm, bn, bk, dtype,
                                         no_launch):
    ja, ta = rnd(m, k, dtype=dtype)
    jb, tb = rnd(k, n, dtype=dtype, seed=1)
    want = matmul_pallas(ja, jb, block_m=bm, block_n=bn, block_k=bk,
                         interpret=True)
    outs = {
        "matmul_cuda": matmul_cuda(ta, tb, block_m=bm, block_n=bn,
                                   block_k=bk),
        "matmul_ref": matmul_ref(ta, tb),
        "ops generated": mm_ops.matmul(ta, tb, interpret=True),
        "ops generated, pinned": mm_ops.matmul(ta, tb, block_m=bm,
                                               block_n=bn, block_k=bk,
                                               interpret=True),
        "ops hand-written": mm_ops.matmul(ta, tb, block_m=bm, block_n=bn,
                                          block_k=bk, interpret=True,
                                          use_generated=False),
        "ops plain": mm_ops.matmul(ta, tb),
    }
    for name, got in outs.items():
        assert got.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name,
                                   **TOL[dtype])
    # the reference's ops agree with its own kernel, as ours with theirs
    np.testing.assert_allclose(
        _np(ref_matmul(ja, jb, interpret=True)), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", WEIGHTED_CASES)
def test_weighted_matmul_matches_reference_kernel(m, n, k, bm, bn, bk, dtype,
                                                  no_launch):
    ja, ta = rnd(m, k, dtype=dtype)
    jb, tb = rnd(k, n, dtype=dtype, seed=1)
    jg, tg = rnd(k, dtype=dtype, seed=2)
    want = weighted_matmul_pallas(ja, jb, jg, block_m=bm, block_n=bn,
                                  block_k=bk, interpret=True)
    outs = {
        "weighted_matmul_cuda": weighted_matmul_cuda(
            ta, tb, tg, block_m=bm, block_n=bn, block_k=bk),
        "weighted_matmul_ref": weighted_matmul_ref(ta, tb, tg),
        "ops": rnz_ops.weighted_matmul(ta, tb, tg, interpret=True),
        "ops pinned": rnz_ops.weighted_matmul(ta, tb, tg, block_m=bm,
                                              block_n=bn, block_k=bk,
                                              interpret=True),
        "ops plain": rnz_ops.weighted_matmul(ta, tb, tg),
    }
    for name, got in outs.items():
        assert got.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name,
                                   **TOL[dtype])
    np.testing.assert_allclose(
        _np(ref_weighted(ja, jb, jg, interpret=True)), _np(want),
        **TOL[dtype])
    if dtype == "float32":  # paper eq 2: einsum(ij,jk,j->ik)
        ein = np.einsum("ij,jk,j->ik", _np(ta), _np(tb), _np(tg))
        np.testing.assert_allclose(_np(outs["ops"]), ein, **TOL[dtype])


def test_weighted_matmul_bf16_rounds_the_zipper_in_the_input_dtype():
    """B7's a * g is rounded to bf16 before the product, bit for bit as
    the reference's zipper; the f32 zipper of B1's weighted spec gives a
    different product, which each kernel is held to separately."""
    ja, ta = rnd(64, 96, dtype="bfloat16")
    jb, tb = rnd(96, 48, dtype="bfloat16", seed=1)
    jg, tg = rnd(96, dtype="bfloat16", seed=2)
    scaled_ref = np.asarray((ja * jg[None, :]).astype(jnp.float32))
    scaled = (ta * tg[None, :])
    assert scaled.dtype == torch.bfloat16
    np.testing.assert_array_equal(scaled.float().numpy(), scaled_ref)
    f32_zipper = (ta.float() * tg.float()[None, :])
    assert not torch.equal(scaled.float(), f32_zipper)
    got = weighted_matmul_ref(ta, tb, tg, out_dtype=torch.float32)
    want = weighted_matmul_pallas(ja, jb, jg, block_m=32, block_n=16,
                                  block_k=32, out_dtype=jnp.float32,
                                  interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("act", ["relu", "gelu", "tanh", "id"])
def test_fused_dense_act_matches_reference_kernel(act, no_launch):
    b, i, k = 32, 64, 48
    jx, tx = rnd(b, i)
    jw, tw = rnd(i, k, seed=1)
    (jbeta, tbeta), (jmean, tmean) = rnd(k, seed=2), rnd(k, seed=3)
    jv, tv = rnd(k, seed=4)
    jv, tv = jnp.abs(jv) + 0.5, tv.abs() + 0.5
    want = fused_dense_act_pallas(jx, jw, jbeta, jmean, jv, act=act,
                                  block_b=16, block_k=16, block_i=16,
                                  interpret=True)
    args = (tx, tw, tbeta, tmean, tv)
    outs = {
        "fused_dense_act_cuda": fused_dense_act_cuda(
            *args, act=act, block_b=16, block_k=16, block_i=16),
        "fused_dense_act_ref": fused_dense_act_ref(*args, act=act),
        "ops generated": fda_ops.fused_dense_act(*args, act=act,
                                                 interpret=True),
        "ops generated, pinned": fda_ops.fused_dense_act(
            *args, act=act, block_b=16, block_k=16, block_i=16,
            interpret=True),
        "ops hand-written": fda_ops.fused_dense_act(
            *args, act=act, interpret=True, use_generated=False),
        "ops plain": fda_ops.fused_dense_act(*args, act=act),
    }
    for name, got in outs.items():
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
    np.testing.assert_allclose(
        _np(ref_fused_dense_act(jx, jw, jbeta, jmean, jv, act=act,
                                interpret=True)), _np(want), rtol=2e-5,
        atol=2e-5)


def test_fused_dense_act_matches_unfused_pipeline():
    """Fused kernel == the three-stage pipeline of paper eqs 3-5."""
    b, i, k = 16, 32, 32
    _, x = rnd(b, i)
    _, w = rnd(i, k, seed=5)
    (_, beta), (_, mean) = rnd(k, seed=6), rnd(k, seed=7)
    _, var = rnd(k, seed=8)
    var = var.abs() + 0.5
    y = x @ w + beta[None, :]
    z = (y - mean[None, :]) / torch.sqrt(var[None, :] + 1e-5)
    r = torch.nn.functional.gelu(z, approximate="tanh")
    out = fused_dense_act_cuda(x, w, beta, mean, var, act="gelu", block_b=8,
                               block_k=16, block_i=16)
    np.testing.assert_allclose(_np(out), _np(r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
def test_choose_matmul_blocks_equals_reference(elem_bytes):
    extents = (1, 8, 48, 96, 128, 384, 1000, 2048, 4096, 12288, 65536)
    for m in extents:
        for n in extents[::2]:
            for k in extents[1::2]:
                assert choose_matmul_blocks(
                    m, n, k, elem_bytes=elem_bytes
                ) == ref_choose(m, n, k, elem_bytes=elem_bytes), (m, n, k)
    assert choose_matmul_blocks(2048, 12288, 4096, double_buffer=False) == \
        ref_choose(2048, 12288, 4096, double_buffer=False)


def test_block_sizes_must_divide_the_extents():
    _, a = rnd(64, 48)
    _, b = rnd(48, 32, seed=1)
    _, g = rnd(48, seed=2)
    ja, jb, jg = (jnp.asarray(t.numpy()) for t in (a, b, g))
    vec = torch.ones(32)
    for port_call, ref_call in (
        (lambda: matmul_cuda(a, b, block_m=24, block_n=16, block_k=16),
         lambda: matmul_pallas(ja, jb, block_m=24, block_n=16, block_k=16,
                               interpret=True)),
        (lambda: weighted_matmul_cuda(a, b, g, block_m=16, block_n=16,
                                      block_k=20),
         lambda: weighted_matmul_pallas(ja, jb, jg, block_m=16, block_n=16,
                                        block_k=20, interpret=True)),
        (lambda: fused_dense_act_cuda(a, b, vec, vec, vec, block_b=16,
                                      block_k=24, block_i=16),
         lambda: fused_dense_act_pallas(
             ja, jb, *(jnp.ones(32),) * 3, block_b=16, block_k=24,
             block_i=16, interpret=True)),
        (lambda: matmul_cuda(a, a, block_m=16, block_n=16, block_k=16),
         lambda: matmul_pallas(ja, ja, block_m=16, block_n=16, block_k=16,
                               interpret=True)),
    ):
        with pytest.raises(AssertionError):
            ref_call()
        with pytest.raises(AssertionError):
            port_call()


def test_ops_routing(monkeypatch):
    """Generated (B1) by default, hand-written with ``use_generated=False``
    or, for fused_rnz, always; plain without ``interpret`` on the CPU."""
    calls = []
    monkeypatch.setattr(mm_ops, "matmul_cuda",
                        lambda *a, **k: calls.append("B5") or matmul_ref(
                            *a[:2]))
    monkeypatch.setattr(mm_ops, "_generated_matmul",
                        lambda *a: calls.append("B1") or matmul_ref(*a[:2]))
    monkeypatch.setattr(fda_ops, "fused_dense_act_cuda",
                        lambda *a, **k: calls.append("B6") or a[0])
    monkeypatch.setattr(fda_ops, "_generated",
                        lambda *a: calls.append("B1 epilogue") or a[0])
    monkeypatch.setattr(rnz_ops, "weighted_matmul_cuda",
                        lambda *a, **k: calls.append("B7") or a[0])
    _, a = rnd(32, 32)
    vec = torch.ones(32)
    mm_ops.matmul(a, a, interpret=True)
    mm_ops.matmul(a, a, block_m=16, interpret=True)
    mm_ops.matmul(a, a, interpret=True, use_generated=False)
    mm_ops.matmul(a, a)
    fda_ops.fused_dense_act(a, a, vec, vec, vec, interpret=True)
    fda_ops.fused_dense_act(a, a, vec, vec, vec, interpret=True,
                            use_generated=False)
    rnz_ops.weighted_matmul(a, a, vec, interpret=True)
    assert calls == ["B1", "B1", "B5", "B1 epilogue", "B6", "B7"]


def test_baseline_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only; a CPU call never reaches them
    through the wrappers (those run the plain versions)."""
    a = torch.ones(8, 8)
    for launcher in (_baselines.MATMUL, _baselines.FUSED_DENSE_ACT,
                     _baselines.FUSED_RNZ):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launcher(a, a, torch.float32)
    assert jax.default_backend() == "cpu"
