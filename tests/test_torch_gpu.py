"""The contraction kernel (``codegen/csrc/contract.cu``) on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card
(decided inside the ``cuda_device`` fixture).  The file imports torch and
the port only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

Each case holds the kernel against its plain version (``contract_ref``)
on the same CUDA tensors at the reference's tolerances (``TOL``), on
outputs scaled by their largest magnitude.
"""

from __future__ import annotations

import pytest
import torch

import repro_torch.core.enumerate as PE
from repro_torch import codegen, ops
from repro_torch.codegen import cuda_gen

TOL = {  # the reference's tests/test_differential.py tolerances
    torch.float32: (1e-4, 1e-4),
    torch.bfloat16: (6e-2, 6e-2),
}


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _assert_close_scaled(got, want, dtype):
    rtol, atol = TOL[dtype]
    scale = want.float().abs().max().clamp_min(1e-30)
    torch.testing.assert_close(got.float() / scale, want.float() / scale,
                               rtol=rtol, atol=atol)


def _spec(mod_name, *extents):
    """Two-operand specs of every shape the folding handles."""
    custom = {
        # A[i,j,r] B[j,k] -> C[i,k]: r is reduced on A alone
        "one_side_reduce": (("i", "j", "r"), ("j", "k"), ("i", "k"),
                            "ijrk"),
        # A[i,j,k] B[j,k,p] -> C[i,p]: a contraction over (j, k)
        "two_reduce": (("i", "j", "k"), ("j", "k", "p"), ("i", "p"), "ijkp"),
        # A[b,i,j] B[j,k] -> C[k,b,i]: output out of (batch, m, n) order
        "out_permuted": (("b", "i", "j"), ("j", "k"), ("k", "b", "i"),
                         "bijk"),
    }
    if mod_name in custom:
        a, b, out, names = custom[mod_name]
        return PE.ContractionSpec(name=mod_name, operands={"A": a, "B": b},
                                  output=out,
                                  extents=dict(zip(names, extents)))
    return getattr(PE, f"{mod_name}_spec")(*extents)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,dtype", [
    (128, 256, 384, torch.bfloat16),
    (77, 130, 45, torch.float32),
    (77, 130, 45, torch.bfloat16),
    (65, 136, 129, torch.bfloat16),
    (3, 5, 7, torch.bfloat16),
    (1, 8, 8, torch.float32),
    (200, 24, 300, torch.bfloat16),
    (512, 4096, 1024, torch.bfloat16),
])
def test_cuda_kernel_matches_plain_version(cuda_device, m, k, n, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(k, n, generator=g, device=cuda_device).to(dtype)
    spec = PE.matmul_spec(m, k, n)
    before = cuda_gen.CONTRACT.launches
    got = codegen.compile(spec, codegen.default_schedule(spec))(a, b)
    assert cuda_gen.CONTRACT.launches == before + 1
    assert got.dtype == dtype and got.is_cuda
    _assert_close_scaled(got, cuda_gen.contract_ref(spec, a, b,
                                                    out_dtype=dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family,extents", [
    ("matvec", (300, 70)),
    ("batched_matmul", (3, 40, 50, 60)),
    ("transposed_matmul", (96, 64, 80)),
    ("one_side_reduce", (33, 20, 5, 17)),
    ("two_reduce", (40, 6, 9, 24)),
    ("out_permuted", (3, 20, 48, 10)),
])
def test_cuda_kernel_every_family(cuda_device, family, extents, dtype):
    """Strided, batched and permuted operands, and the element-wise load
    path of the bf16 body, through ``CompiledKernel`` on the card."""
    spec = _spec(family, *extents)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    arrays = [
        torch.randn([spec.extents[i] for i in axes], generator=g,
                    device=cuda_device).to(dtype)
        for axes in spec.operands.values()
    ]
    before = cuda_gen.CONTRACT.launches
    got = codegen.compile(spec, codegen.default_schedule(spec))(*arrays)
    assert cuda_gen.CONTRACT.launches == before + 1
    want = cuda_gen.contract_ref(spec, *arrays, out_dtype=dtype)
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
def test_cuda_bf16_operands_f32_output(cuda_device):
    """bf16 products accumulate in f32 and are stored without rounding."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    a = torch.randn(1, 128, 512, generator=g, device=cuda_device)
    b = torch.randn(1, 512, 256, generator=g, device=cuda_device)
    a, b = a.bfloat16(), b.bfloat16()
    got = cuda_gen.CONTRACT(a, b, torch.float32)
    want = torch.bmm(a.float(), b.float())
    _assert_close_scaled(got, want, torch.float32)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    a = torch.randn(1, 8, 8, device=cuda_device)
    with pytest.raises(TypeError, match="two float32 or two bfloat16"):
        cuda_gen.CONTRACT(a, a.bfloat16(), torch.float32)
    with pytest.raises(TypeError, match="writes float32 or bfloat16"):
        cuda_gen.CONTRACT(a, a, torch.float16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_gen.CONTRACT(a, a.cpu(), torch.float32)
    with pytest.raises(ValueError, match=r"\(batch, M, K\)"):
        cuda_gen.CONTRACT(a, a[:, :4], torch.float32)


@pytest.mark.gpu
def test_dense_on_cuda_launches_only_when_aligned(cuda_device):
    """A 128-aligned ``ops.dense`` runs the kernel; an unaligned one is a
    plain ``torch.matmul`` and launches nothing."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    w = torch.randn(256, 384, generator=g, device=cuda_device).bfloat16()
    for rows, launched in ((128, 1), (100, 0)):
        x = torch.randn(rows, 256, generator=g,
                        device=cuda_device).bfloat16()
        before = cuda_gen.CONTRACT.launches
        got = ops.dense(x, w)
        assert cuda_gen.CONTRACT.launches - before == launched
        _assert_close_scaled(got, torch.matmul(x.float(), w.float()),
                             torch.bfloat16)
