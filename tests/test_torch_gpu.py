"""The hand-written kernels on the card: the contraction kernel
(``codegen/csrc/contract.cu``, B1), the grouped MoE kernel
(``codegen/csrc/grouped.cu``, B3) and the grouped dW kernel
(``codegen/csrc/grouped_dw.cu``, B4), and autograd through them.

Every test here carries the ``gpu`` marker and skips without a CUDA card
(decided inside the ``cuda_device`` fixture).  The file imports torch and
the port only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

Each case holds the kernel against its plain version (``contract_ref``,
``grouped_ref``, ``grouped_dw_ref``) on the same CUDA tensors at the
reference's tolerances (``TOL``), on outputs scaled by their largest
magnitude; the autograd cases hold gradients on the card to the same
computation on the CPU.
"""

from __future__ import annotations

import pytest
import torch

import repro_torch.core.enumerate as PE
from repro_torch import codegen, ops
from repro_torch.codegen import cuda_gen, fused_gen

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


# --------------------------------------------------------------------------
# the grouped (MoE) kernel, B3
# --------------------------------------------------------------------------

#: kimi-k2's expert products: (K, N) of gate/up and of down
KIMI_GATE, KIMI_DOWN = (7168, 2048), (2048, 7168)
RAGGED = (0, 1, 17, 0, 100, 3, 0, 45, 1, 16)


def _grouped_operands(device, sizes, k, n, dtype, contract_last, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(sum(sizes), k, generator=g, device=device).to(dtype)
    shape = (len(sizes), n, k) if contract_last else (len(sizes), k, n)
    w = torch.randn(shape, generator=g, device=device).to(dtype)
    return x, w


def _grouped_spec(sizes, k, n, contract_last):
    if not contract_last:
        return PE.grouped_matmul_spec(sizes, k, n)
    # grouped_matmul.dX: dout (n, f) against w (g, k, f) -> (n, k)
    return PE.GroupedSpec(
        name="grouped_matmul.dX",
        operands={"dout": ("n", "f"), "W": ("g", "k", "f")},
        output=("n", "k"),
        extents={"n": max(sum(sizes), 1), "k": n, "f": k, "g": len(sizes)},
        group_sizes=tuple(sizes),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,k,n,dtype,contract_last", [
    ((16,) * 384, *KIMI_GATE, torch.bfloat16, False),   # gate/up, C = 16
    ((4,) * 384, *KIMI_DOWN, torch.bfloat16, False),    # down, C = 4
    ((8,) * 384, *KIMI_GATE, torch.bfloat16, True),     # dX of gate/up
    (RAGGED, 200, 136, torch.bfloat16, False),          # ragged, K % 32 != 0
    (RAGGED, 200, 136, torch.bfloat16, True),
    (RAGGED, 77, 45, torch.bfloat16, False),            # element-wise loads
    (RAGGED, 200, 136, torch.float32, False),
    (RAGGED, 77, 45, torch.float32, True),
    ((0, 0, 5), 64, 128, torch.bfloat16, False),        # leading empties
    ((1, 1, 1, 1), 32, 8, torch.float32, False),        # all size 1
])
def test_grouped_kernel_matches_plain_version(cuda_device, sizes, k, n,
                                              dtype, contract_last):
    x, w = _grouped_operands(cuda_device, sizes, k, n, dtype, contract_last,
                             seed=len(sizes) + k)
    spec = _grouped_spec(sizes, k, n, contract_last)
    kern = codegen.compile(spec, codegen.default_schedule(spec))
    assert kern.contract_last == contract_last
    before = fused_gen.GROUPED.launches
    got = kern(x, w)
    assert fused_gen.GROUPED.launches == before + 1
    assert got.dtype == dtype and got.shape == (sum(sizes), n)
    want = fused_gen.grouped_ref(x, w, sizes, out_dtype=dtype,
                                 contract_last=contract_last)
    torch.cuda.synchronize()
    _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
def test_grouped_kernel_bf16_in_f32_out_and_store_then_cast(cuda_device):
    """bf16 operands, f32 output: stored without rounding.  Through
    ``ops.grouped_dense`` the kernel stores in x's dtype and then casts, as
    the reference does, so its f32 result is bf16-rounded."""
    sizes = (5, 0, 12, 3)
    x, w = _grouped_operands(cuda_device, sizes, 96, 64, torch.bfloat16,
                             False, seed=7)
    table = torch.tensor(fused_gen.group_table(sizes), dtype=torch.int32,
                         device=cuda_device)
    f32 = fused_gen.GROUPED(x, w, table, max(sizes), torch.float32)
    want = fused_gen.grouped_ref(x, w, sizes, out_dtype=torch.float32)
    _assert_close_scaled(f32, want, torch.float32)
    before = fused_gen.GROUPED.launches
    via_ops = ops.grouped_dense(x, w, sizes, out_dtype=torch.float32)
    assert fused_gen.GROUPED.launches == before + 1
    assert via_ops.dtype == torch.float32
    torch.testing.assert_close(via_ops, f32.bfloat16().float(), rtol=0,
                               atol=0)


@pytest.mark.gpu
def test_grouped_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.randn(4, 8, device=cuda_device)
    w = torch.randn(2, 8, 16, device=cuda_device)
    table = torch.tensor([[0, 0, 2], [1, 2, 2]], dtype=torch.int32,
                         device=cuda_device)
    with pytest.raises(TypeError, match="two float32 or two bfloat16"):
        fused_gen.GROUPED(x, w.bfloat16(), table, 2, torch.float32)
    with pytest.raises(TypeError, match="writes float32 or bfloat16"):
        fused_gen.GROUPED(x, w, table, 2, torch.float16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_gen.GROUPED(x, w.cpu(), table, 2, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        fused_gen.GROUPED(x, w, table.long(), 2, torch.float32)
    with pytest.raises(ValueError, match="K on axis 1"):
        fused_gen.GROUPED(x[:, :4], w, table, 2, torch.float32)


# --------------------------------------------------------------------------
# kernel B4 (grouped dW) and autograd through B1, B3 and B4
# --------------------------------------------------------------------------


def _dw_spec(sizes, k1, k2):
    return PE.GroupedSpec(
        name="grouped_matmul.dW",
        operands={"dout": ("n", "f"), "X": ("n", "k")},
        output=("g", "k", "f"),
        extents={"n": max(sum(sizes), 1), "k": k1, "f": k2, "g": len(sizes)},
        group_sizes=tuple(sizes),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,k1,k2,dtype", [
    ((28,) * 384, 512, 256, torch.bfloat16),     # kimi-k2's C at a 1024 step
    ((320,) * 4, 896, 256, torch.bfloat16),      # the training path's C
    (RAGGED, 200, 136, torch.bfloat16),          # ragged, unaligned
    (RAGGED, 77, 45, torch.bfloat16),            # element-wise loads
    (RAGGED, 77, 45, torch.float32),
    ((0, 0, 5), 64, 128, torch.float32),         # leading empties
    ((1, 1, 0, 1), 32, 8, torch.bfloat16),       # size 1 and empty
])
def test_grouped_dw_kernel_matches_plain_version(cuda_device, sizes, k1, k2,
                                                 dtype):
    g = torch.Generator(device=cuda_device).manual_seed(k1 + k2)
    x = torch.randn(sum(sizes), k1, generator=g, device=cuda_device).to(dtype)
    d = torch.randn(sum(sizes), k2, generator=g, device=cuda_device).to(dtype)
    spec = _dw_spec(sizes, k1, k2)
    kern = codegen.compile(spec, codegen.default_schedule(spec))
    assert kern.dw
    before = fused_gen.GROUPED_DW.launches
    got = kern(d, x)
    assert fused_gen.GROUPED_DW.launches == before + 1
    assert got.dtype == dtype and got.shape == (len(sizes), k1, k2)
    want = fused_gen.grouped_dw_ref(x, d, sizes, out_dtype=dtype)
    torch.cuda.synchronize()
    _assert_close_scaled(got, want, dtype)
    for gi, size in enumerate(sizes):
        if not size:
            assert bool((got[gi] == 0).all()), gi


@pytest.mark.gpu
def test_grouped_dw_kernel_takes_strided_operands_and_f32_output(cuda_device):
    sizes = (5, 0, 40, 1)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    xt = torch.randn(128, 46, generator=g, device=cuda_device).bfloat16()
    x = xt.T  # (46, 128) with unit stride along rows: element-wise loads
    d = torch.randn(46, 64, generator=g, device=cuda_device).bfloat16()
    table = torch.tensor(
        [(i, o, s) for i, (o, s) in
         enumerate(zip(fused_gen._group_offsets(sizes), sizes))],
        dtype=torch.int32, device=cuda_device)
    got = fused_gen.GROUPED_DW(x, d, table, torch.float32)
    want = fused_gen.grouped_dw_ref(x, d, sizes, out_dtype=torch.float32)
    _assert_close_scaled(got, want, torch.float32)
    with pytest.raises(TypeError, match="two float32 or two bfloat16"):
        fused_gen.GROUPED_DW(x, d.float(), table, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_gen.GROUPED_DW(x, d.cpu(), table, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        fused_gen.GROUPED_DW(x, d, table.long(), torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_backward_runs_b1_on_the_derived_specs(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(256, 384, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(384, 128, generator=g, device=cuda_device).to(dtype)
    cot = torch.randn(256, 128, generator=g, device=cuda_device).to(dtype)
    x.requires_grad_(True)
    w.requires_grad_(True)
    before = cuda_gen.CONTRACT.launches
    out = ops.dense(x, w)
    assert out.grad_fn is not None
    out.backward(cot)
    assert cuda_gen.CONTRACT.launches == before + 3  # forward, dA, dB
    xc, wc = (t.detach().cpu().requires_grad_(True) for t in (x, w))
    ops.dense(xc, wc, interpret=True).backward(cot.cpu())
    _assert_close_scaled(x.grad.cpu(), xc.grad, dtype)
    _assert_close_scaled(w.grad.cpu(), wc.grad, dtype)
    assert x.grad.dtype == w.grad.dtype == dtype


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_backward_runs_b3_dx_and_b4(cuda_device, dtype):
    sizes = (3, 0, 40, 1, 17)
    x, w = _grouped_operands(cuda_device, sizes, 256, 128, dtype, False,
                             seed=13)
    cot = torch.randn(sum(sizes), 128, device=cuda_device).to(dtype)
    x.requires_grad_(True)
    w.requires_grad_(True)
    b3, b4 = fused_gen.GROUPED.launches, fused_gen.GROUPED_DW.launches
    ops.grouped_dense(x, w, sizes).backward(cot)
    assert fused_gen.GROUPED.launches == b3 + 2  # forward and dX
    assert fused_gen.GROUPED_DW.launches == b4 + 1
    xc, wc = (t.detach().cpu().requires_grad_(True) for t in (x, w))
    ops.grouped_dense(xc, wc, sizes, interpret=True).backward(cot.cpu())
    _assert_close_scaled(x.grad.cpu(), xc.grad, dtype)
    _assert_close_scaled(w.grad.cpu(), wc.grad, dtype)
    assert bool((w.grad[1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_every_parameter_gets_a_finite_gradient_on_the_card(
        cuda_device, moe, monkeypatch):
    """A train step's autograd on the card: 128-aligned layers, so every
    projection runs B1 (and under REPRO_MOE_GROUPED=1 the experts B3 and
    B4); every parameter's gradient is finite and non-zero and agrees with
    the CPU's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api
    from repro_torch.optim.adamw import leaves, tree_map

    monkeypatch.setenv("REPRO_MOE_GROUPED", "1")
    base = get_config("kimi-k2-1t-a32b" if moe else "qwen3-8b")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
        d_ff=256, vocab=256, dtype="float32",
        moe=(dataclasses.replace(base.moe, n_experts=4, top_k=2,
                                 expert_ff=128, shared_expert_ff=128,
                                 dense_ff=256, first_dense=1)
             if moe else None),
    )
    api = get_api(cfg)
    cpu_params = T.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    gpu_params = tree_map(lambda t: t.to(cuda_device), cpu_params)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = (cuda_gen.CONTRACT.launches, fused_gen.GROUPED_DW.launches)
    _, grads = value_and_grad(
        lambda p, b: api.loss(p, cfg, b), gpu_params,
        {k: v.to(cuda_device) for k, v in batch.items()})
    assert cuda_gen.CONTRACT.launches - before[0] == 4 * 7 * cfg.n_layers
    assert fused_gen.GROUPED_DW.launches - before[1] == (3 if moe else 0)
    _, want = value_and_grad(lambda p, b: api.loss(p, cfg, b), cpu_params,
                             batch)
    for (path, gg), (_, gc) in zip(leaves(grads), leaves(want)):
        assert bool(torch.isfinite(gg).all()), path
        assert bool((gg != 0).any()), path
        _assert_close_scaled(gg.cpu(), gc, torch.float32)
