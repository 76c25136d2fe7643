"""The hand-written kernels on the card: the contraction kernel
(``codegen/csrc/contract.cu``, B1, with its epilogue and the weighted
family's vector and row-reduce modes; ``contract_q8.cu``, its int8/fp8
tensor-core mode and upcast body; ``contract_chain.cu``, its chain mode),
the grouped MoE kernel
(``codegen/csrc/grouped.cu``, B3), the grouped dW kernel
(``codegen/csrc/grouped_dw.cu``, B4) and the hand-written baselines B5, B6
and B7 (``codegen/csrc/baselines.cu``), and autograd through them
(``ops.chain_dense``'s 1 + 3 launches; ``ops.dense(quant=)``'s one launch
and its refused gradient; ``ops.dense`` at any shape), and the
flash-attention kernel (``codegen/csrc/attention.cu``, B2: each of its
bodies, the bf16 TMA/wgmma ring and the f32 3xTF32 body at ragged,
transposed, masked and unequal-width heads, two launches equal bit for
bit, a forced body refused where its rules fail) with
``ops.attention``'s 1 + 3 launches, with and without ``kv_lengths``, and
B1's ring bodies (TMA and wgmma: the bf16 ring in its four operand
layouts, batched and split, the 8-bit ring, two launches equal bit for
bit, a forced ring refused where it cannot read the layout; the fused
ring in every mode and layout, split, its row reduce bit for bit; the
narrow body at decode's token counts and GEMMs, one launch a GEMM and
nothing else; the 8-bit weighted family on the rings -- int8 bit for
bit, fp8 at the f32 TOL, its row reduce equal over five launches, the
ring's modes refused off it), B5, B6 and B7's ring body (TMA and wgmma:
the fused path's shape, ragged, M < 128, bf16 and f32 outputs, B6 with
every activation, B7 with g = 0 and of mixed sign, two streams at once,
forced and refused bodies), whole-model capture (a replayed launch
differentiating through its op, the demo configs card vs CPU), and a
failed launch of B1 or B2 dropping its
stream's counters.

Every test here carries the ``gpu`` marker and skips without a CUDA card
(decided inside the ``cuda_device`` fixture).  The file imports torch and
the port only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

Each case holds the kernel against its plain version (``contract_ref``
-- int8 by exact equality --,
``grouped_ref``, ``grouped_dw_ref``, ``matmul_ref``,
``fused_dense_act_ref``, ``weighted_matmul_ref``, ``attention_ref``) on the same CUDA tensors at the
reference's tolerances (``TOL``), on outputs scaled by their largest
magnitude (attention's per row); the autograd cases hold gradients on the card to the same
computation on the CPU.
"""

from __future__ import annotations

import types

import pytest
import torch

import repro_torch.core.enumerate as PE
from repro_torch import codegen, ops
from repro_torch.codegen import cuda_gen, fused_gen, modes

TOL = {  # the reference's tests/test_differential.py tolerances
    torch.float32: (1e-4, 1e-4),
    torch.bfloat16: (6e-2, 6e-2),
}
#: scaled limit for an f32 gradient of a bf16 call (see
#: ``test_weighted_dense_and_dense_act_run_b1_both_ways``)
F32_GRAD_OF_BF16_TOL = 5e-3


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


def _assert_rows_close(got, want, dtype):
    """Attention's check: each row (the last axis) scaled by its own
    largest magnitude (1 for an all-zero row), so that late causal rows,
    whose values are small, are held as tightly as row 0."""
    atol = TOL[dtype][1]
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    scale = want.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(scale == 0, 1.0, scale)
    err = ((got - want).abs() / scale).max().item()
    assert err <= atol, f"row-scaled error {err} above {atol}"


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
def test_dense_on_cuda_launches_at_any_shape(cuda_device):
    """Every non-empty ``ops.dense`` on a CUDA tensor runs the kernel, the
    128-aligned call and the 100-row one alike; a 3-D x folds its leading
    axes into M: one launch forward, two more (dA, dB) backward."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    w = torch.randn(256, 384, generator=g, device=cuda_device).bfloat16()
    for rows in (128, 100):
        x = torch.randn(rows, 256, generator=g,
                        device=cuda_device).bfloat16()
        before = cuda_gen.CONTRACT.launches
        got = ops.dense(x, w)
        assert cuda_gen.CONTRACT.launches - before == 1
        _assert_close_scaled(got, torch.matmul(x.float(), w.float()),
                             torch.bfloat16)
    x = torch.randn(4, 3, 256, generator=g, device=cuda_device)
    wf = w.float().requires_grad_(True)
    x.requires_grad_(True)
    dout = torch.randn(4, 3, 384, generator=g, device=cuda_device)
    before = cuda_gen.CONTRACT.launches
    got = ops.dense(x, wf)
    assert cuda_gen.CONTRACT.launches - before == 1
    assert got.shape == (4, 3, 384)
    got.backward(dout)
    assert cuda_gen.CONTRACT.launches - before == 3
    xc, wc = (t.detach().cpu().requires_grad_(True) for t in (x, wf))
    want = torch.matmul(xc, wc)
    want.backward(dout.cpu())
    for a, b in ((got, want), (x.grad, xc.grad), (wf.grad, wc.grad)):
        _assert_close_scaled(a.detach().cpu(), b.detach(), torch.float32)


# --------------------------------------------------------------------------
# the grouped (MoE) kernel, B3
# --------------------------------------------------------------------------

#: kimi-k2's expert products: (K, N) of gate/up and of down
KIMI_GATE, KIMI_DOWN = (7168, 2048), (2048, 7168)
RAGGED = (0, 1, 17, 0, 100, 3, 0, 45, 1, 16)
#: groups of 0, 1, 129 and 700 rows: several M tiles, ragged tails
LARGE = (0, 1, 129, 700, 64, 65)


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
    # groups larger than one M tile: 128-row blocks, ragged tails
    ((320,) * 4, *KIMI_GATE, torch.bfloat16, False),
    ((320,) * 4, *KIMI_GATE, torch.bfloat16, True),
    ((320,) * 4, *KIMI_DOWN, torch.bfloat16, True),     # dX at train widths
    (LARGE, 256, 384, torch.bfloat16, False),
    (LARGE, 256, 384, torch.bfloat16, True),
    (LARGE, 200, 136, torch.float32, False),
    (LARGE, 200, 136, torch.float32, True),
    (LARGE, 77, 45, torch.bfloat16, True),              # element-wise dX
    (LARGE, 77, 45, torch.bfloat16, False),
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
@pytest.mark.parametrize("tile,band", [(128, 1), (128, 2), (128, 4),
                                       (128, 16), (64, 3), (32, 5)])
@pytest.mark.parametrize("contract_last", [False, True])
def test_grouped_kernel_any_band_covers_every_tile(cuda_device, tile, band,
                                                   contract_last):
    """The band rasterization writes every (row block, column block) once,
    at bands that split a group and bands past the table's end.  Each case
    draws its own inputs, so a tile left unwritten cannot hold an earlier
    case's answer."""
    sizes, k, n = LARGE, 256, 384
    x, w = _grouped_operands(cuda_device, sizes, k, n, torch.bfloat16,
                             contract_last, seed=100 * tile + band)
    offs = [sum(sizes[:g]) for g in range(len(sizes))]
    rows = [(g, o + r, min(tile, s - r))
            for g, (o, s) in enumerate(zip(offs, sizes))
            for r in range(0, s, tile)]
    table = torch.tensor(rows, dtype=torch.int32, device=cuda_device)
    before = fused_gen.GROUPED.launches
    got = fused_gen.GROUPED(x, w, table, max(r[2] for r in rows),
                            torch.bfloat16, contract_last=contract_last,
                            band=band)
    assert fused_gen.GROUPED.launches == before + 1
    want = fused_gen.grouped_ref(x, w, sizes, out_dtype=torch.bfloat16,
                                 contract_last=contract_last)
    torch.cuda.synchronize()
    _assert_close_scaled(got, want, torch.bfloat16)


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


# --------------------------------------------------------------------------
# B1's epilogue and the weighted family
# --------------------------------------------------------------------------

ACTS = ("relu", "gelu", "tanh", "silu", "id")


def _vectors(device, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "scale": torch.randn(n, generator=g, device=device),
        "bias": torch.randn(n, generator=g, device=device),
        "mean": torch.randn(n, generator=g, device=device) * 0.1,
        "var": torch.rand(n, generator=g, device=device) + 0.5,
    }


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [False, True], ids=["nonorm", "norm"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n", [(77, 130, 45), (128, 256, 384)])
def test_cuda_epilogue_matches_plain_version(cuda_device, m, k, n, act, norm,
                                             dtype):
    spec = PE.matmul_spec(m, k, n)
    epi = codegen.Epilogue(act=act, bias=True, scale=not norm, norm=norm)
    g = torch.Generator(device=cuda_device).manual_seed(20)
    a = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(k, n, generator=g, device=cuda_device).to(dtype)
    vecs = {name: v for name, v in _vectors(cuda_device, n, 21).items()
            if name in epi.vector_names}
    kern = codegen.compile(spec, codegen.default_schedule(spec),
                           epilogue=epi)
    before = cuda_gen.CONTRACT.launches
    got = kern(a, b, **vecs)
    assert cuda_gen.CONTRACT.launches == before + 1
    want = cuda_gen.contract_ref(spec, a, b, out_dtype=dtype, epilogue=epi,
                                 vectors=vecs)
    assert got.dtype == dtype
    _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_epilogue_vector_on_m_and_batch_axes(cuda_device, dtype):
    """The epilogue's vectors follow ``spec.output[-1]`` into whichever
    folded group holds it: m (output (k, i)) and batch (output (k, i, b))."""
    specs = [
        PE.ContractionSpec(name="mt", operands={"A": ("i", "j"),
                                                "B": ("j", "k")},
                           output=("k", "i"),
                           extents={"i": 70, "j": 96, "k": 40}),
        PE.ContractionSpec(name="bt", operands={"A": ("b", "i", "j"),
                                                "B": ("b", "j", "k")},
                           output=("k", "i", "b"),
                           extents={"b": 3, "i": 33, "j": 64, "k": 24}),
    ]
    g = torch.Generator(device=cuda_device).manual_seed(22)
    for spec in specs:
        arrays = [torch.randn([spec.extents[i] for i in ax], generator=g,
                              device=cuda_device).to(dtype)
                  for ax in spec.operands.values()]
        last = spec.extents[spec.output[-1]]
        epi = codegen.Epilogue(act="gelu", scale=True, bias=True, norm=True)
        vecs = _vectors(cuda_device, last, 23)
        got = codegen.compile(spec, codegen.default_schedule(spec),
                              epilogue=epi)(*arrays, **vecs)
        want = cuda_gen.contract_ref(spec, *arrays, out_dtype=dtype,
                                     epilogue=epi, vectors=vecs)
        _assert_close_scaled(got, want, dtype)


def _weighted_operands(device, spec, dtype, seed, zero_g=False):
    g = torch.Generator(device=device).manual_seed(seed)
    arrays = []
    for name, axes in spec.operands.items():
        t = torch.randn([spec.extents[i] for i in axes], generator=g,
                        device=device)
        if name == "g" and zero_g:
            t = torch.zeros_like(t)
        arrays.append(t.to(dtype))
    return arrays


def _weighted_specs(m, d, f):
    from repro_torch.grad import derived_specs

    spec = PE.weighted_matmul_spec(m, d, f)
    return [spec] + list(derived_specs(spec).values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zero_g", [False, True], ids=["g", "zero_g"])
@pytest.mark.parametrize("m,d,f", [(77, 130, 45), (128, 256, 384),
                                   (300, 40, 200)])
def test_cuda_weighted_family_matches_plain_version(cuda_device, m, d, f,
                                                    zero_g, dtype):
    """``weighted_matmul`` and its derived ``.dA``, ``.dB`` (vector mode)
    and ``.dg`` (row-reduce mode), one launch each."""
    for spec in _weighted_specs(m, d, f):
        arrays = _weighted_operands(cuda_device, spec, dtype, 24,
                                    zero_g=zero_g)
        kern = codegen.compile(spec, codegen.default_schedule(spec))
        before = cuda_gen.CONTRACT.launches
        got = kern(*arrays)
        assert cuda_gen.CONTRACT.launches == before + 1, spec.name
        want = cuda_gen.contract_ref(spec, *arrays, out_dtype=dtype)
        assert got.shape == want.shape and got.dtype == dtype, spec.name
        if zero_g and spec.name != "weighted_matmul.dg":
            assert bool((got == 0).all()), spec.name
        else:
            _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_reduce_is_deterministic(cuda_device, dtype):
    spec = _weighted_specs(700, 300, 500)[3]
    assert spec.name == "weighted_matmul.dg"
    arrays = _weighted_operands(cuda_device, spec, dtype, 25)
    kern = codegen.compile(spec, codegen.default_schedule(spec))
    first = kern(*arrays)
    for _ in range(3):
        assert torch.equal(kern(*arrays), first)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_dense_and_dense_act_run_b1_both_ways(cuda_device, dtype):
    """``ops.weighted_dense`` and ``ops.dense_act`` on the card: one B1
    launch forward and three backward each; gradients agree with the CPU's
    plain path."""
    g = torch.Generator(device=cuda_device).manual_seed(26)
    m, d, f = 192, 256, 320
    x = torch.randn(m, d, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(d, f, generator=g, device=cuda_device).to(dtype)
    gv = torch.randn(d, generator=g, device=cuda_device).to(dtype)
    vec = _vectors(cuda_device, f, 27)
    cot = torch.randn(m, f, generator=g, device=cuda_device).to(dtype)
    cases = {
        "weighted": ((x, w, gv), lambda *t: ops.weighted_dense(*t),
                     lambda *t: ops.weighted_dense(*t, interpret=True)),
        "dense_act": ((x, w, vec["bias"], vec["mean"], vec["var"]),
                      lambda *t: ops.dense_act(*t, act="gelu"),
                      lambda *t: ops.dense_act(*t, act="gelu",
                                               interpret=True)),
    }
    for name, (inputs, card, cpu) in cases.items():
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        before = cuda_gen.CONTRACT.launches
        out = card(*leaves)
        assert cuda_gen.CONTRACT.launches == before + 1, name
        out.backward(cot)
        assert cuda_gen.CONTRACT.launches == before + 4, name
        ref = [t.detach().cpu().requires_grad_(True) for t in inputs]
        want = cpu(*ref)
        _assert_close_scaled(out.detach().cpu(), want.detach(), dtype)
        want.backward(cot.cpu())
        for got_leaf, ref_leaf in zip(leaves, ref):
            assert got_leaf.grad.dtype == ref_leaf.grad.dtype
            if ref_leaf.grad.dtype == torch.float32 != dtype:
                # the f32 (beta, mean, var) gradients of a bf16 call: the
                # backward recomputes the accumulator and rounds it to the
                # operand dtype, as the reference's does, so one element
                # that rounds to the neighbouring bf16 value moves them.
                # Their largest scaled gap on an H100 was 7.1e-4; the limit
                # leaves room on both sides of that reading
                rtol = atol = F32_GRAD_OF_BF16_TOL
                scale = ref_leaf.grad.abs().max().clamp_min(1e-30)
                torch.testing.assert_close(got_leaf.grad.cpu() / scale,
                                           ref_leaf.grad / scale,
                                           rtol=rtol, atol=atol)
            else:
                _assert_close_scaled(got_leaf.grad.cpu(), ref_leaf.grad,
                                     dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_dense_and_dense_act_fold_leading_axes_onto_b1(cuda_device,
                                                                 dtype):
    """A 3-D x on the card runs B1 too, its leading axes folded into M:
    one launch forward and three backward, never a library product; the
    output and every gradient are those of the 2-D call on the folded x,
    bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    b, s, d, f = 2, 96, 256, 320
    x = torch.randn(b, s, d, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(d, f, generator=g, device=cuda_device).to(dtype)
    gv = torch.randn(d, generator=g, device=cuda_device).to(dtype)
    vec = _vectors(cuda_device, f, 32)
    cot = torch.randn(b, s, f, generator=g, device=cuda_device).to(dtype)
    cases = {
        "weighted": ((w, gv), ops.weighted_dense),
        "dense_act": ((w, vec["bias"], vec["mean"], vec["var"]),
                      lambda *t: ops.dense_act(*t, act="gelu")),
    }
    for name, (rest, call) in cases.items():
        leaves = [t.detach().clone().requires_grad_(True) for t in (x,) + rest]
        before = cuda_gen.CONTRACT.launches
        out = call(*leaves)
        assert cuda_gen.CONTRACT.launches == before + 1, name
        assert out.shape == (b, s, f), name
        out.backward(cot)
        assert cuda_gen.CONTRACT.launches == before + 4, name
        flat = [t.detach().clone().requires_grad_(True)
                for t in (x.reshape(b * s, d),) + rest]
        want = call(*flat)
        want.backward(cot.reshape(b * s, f))
        # the same launches on the same data: the same bits
        torch.testing.assert_close(out.detach().reshape(b * s, f),
                                   want.detach(), rtol=0, atol=0)
        for got_leaf, ref_leaf in zip(leaves, flat):
            torch.testing.assert_close(got_leaf.grad.reshape(ref_leaf.shape),
                                       ref_leaf.grad, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the hand-written baselines B5, B6, B7
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(128, 256, 384), (77, 130, 45),
                                   (64, 40, 200), (1, 8, 8)])
def test_baselines_match_plain_versions(cuda_device, m, k, n, dtype):
    from repro_torch.kernels import _baselines
    from repro_torch.kernels.fused_dense_act.fused_dense_act import (
        fused_dense_act_cuda,
    )
    from repro_torch.kernels.fused_dense_act.ref import fused_dense_act_ref
    from repro_torch.kernels.fused_rnz.fused_rnz import weighted_matmul_cuda
    from repro_torch.kernels.fused_rnz.ref import weighted_matmul_ref
    from repro_torch.kernels.matmul.matmul import matmul_cuda
    from repro_torch.kernels.matmul.ref import matmul_ref

    g = torch.Generator(device=cuda_device).manual_seed(28)
    a = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(k, n, generator=g, device=cuda_device).to(dtype)
    gv = torch.randn(k, generator=g, device=cuda_device).to(dtype)
    vec = _vectors(cuda_device, n, 29)
    blocks = dict(block_m=m, block_n=n, block_k=k)
    counts = lambda: (_baselines.MATMUL.launches,  # noqa: E731
                      _baselines.FUSED_DENSE_ACT.launches,
                      _baselines.FUSED_RNZ.launches)
    before = counts()
    _assert_close_scaled(matmul_cuda(a, b, **blocks), matmul_ref(a, b),
                         dtype)
    for act in ("relu", "gelu", "tanh", "id"):
        got = fused_dense_act_cuda(a, b, vec["bias"], vec["mean"],
                                   vec["var"], act=act, block_b=m,
                                   block_k=n, block_i=k)
        _assert_close_scaled(got, fused_dense_act_ref(
            a, b, vec["bias"], vec["mean"], vec["var"], act=act), dtype)
    got = weighted_matmul_cuda(a, b, gv, **blocks)
    _assert_close_scaled(got, weighted_matmul_ref(a, b, gv), dtype)
    zero = weighted_matmul_cuda(a, b, torch.zeros_like(gv), **blocks)
    assert bool((zero == 0).all())
    after = counts()
    assert (after[0] - before[0], after[1] - before[1],
            after[2] - before[2]) == (1, 4, 2)


@pytest.mark.gpu
def test_baseline_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from repro_torch.kernels import _baselines

    a = torch.randn(8, 8, device=cuda_device)
    with pytest.raises(TypeError, match="one dtype"):
        _baselines.MATMUL(a, a.bfloat16(), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _baselines.MATMUL(a, a.cpu(), torch.float32)
    with pytest.raises(TypeError, match="vector operands"):
        _baselines.FUSED_RNZ(a, a, torch.float32)
    with pytest.raises(TypeError, match="one dtype"):
        _baselines.FUSED_RNZ(a, a, torch.float32,
                             g=torch.ones(8, device=cuda_device).bfloat16())


def _baseline_case(device, m, k, n, seed, g_kind="randn"):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = (torch.randn(m, k, generator=gen, device=device) / 8).bfloat16()
    b = (torch.randn(k, n, generator=gen, device=device) / 8).bfloat16()
    if g_kind == "zero":
        g = torch.zeros(k, device=device).bfloat16()
    elif g_kind == "signs":  # mixed sign, every magnitude of randn
        g = torch.randn(k, generator=gen, device=device).abs() * (
            1 - 2 * (torch.arange(k, device=device) % 3 == 0).float())
        g = g.bfloat16()
    else:
        g = torch.randn(k, generator=gen, device=device).bfloat16()
    return a, b, g


@pytest.mark.gpu
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32],
                         ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("m,k,n", [
    (2048, 4096, 12288),  # the fused path's shape: 768 tiles
    (1000, 1000, 1000),   # ragged on every side: TMA zero-fill, masked store
    (77, 256, 512),       # M < 128: half a row tile
    (1, 8, 8),            # one row, one K step
    (300, 4096, 264),     # ragged N past a 256-wide tile
])
def test_baseline_ring_matches_plain_versions(cuda_device, m, k, n, out):
    from repro_torch.kernels import _baselines
    from repro_torch.kernels.fused_rnz.ref import weighted_matmul_ref
    from repro_torch.kernels.matmul.ref import matmul_ref

    a, b, g = _baseline_case(cuda_device, m, k, n, 40)
    got = _baselines.MATMUL(a, b, out)
    assert _baselines.MATMUL.last_body == "ring"
    _assert_close_scaled(got, matmul_ref(a, b, out), torch.bfloat16)
    for g_kind in ("randn", "signs"):
        _, _, g = _baseline_case(cuda_device, m, k, n, 41, g_kind)
        got = _baselines.FUSED_RNZ(a, b, out, g=g)
        assert _baselines.FUSED_RNZ.last_body == "ring"
        _assert_close_scaled(got, weighted_matmul_ref(a, b, g, out),
                             torch.bfloat16)
    zero = _baselines.FUSED_RNZ(a, b, out, g=torch.zeros_like(g))
    assert _baselines.FUSED_RNZ.last_body == "ring"
    assert bool((zero == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32],
                         ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("m,k,n", [
    (2048, 4096, 12288),  # the fused path's shape
    (1000, 1000, 1000),   # ragged on every side
    (300, 4096, 264),     # ragged N past a 256-wide tile
])
def test_b6_ring_matches_its_plain_version(cuda_device, m, k, n, out):
    """B6 (fused_dense_act) on the ring, every activation: the epilogue
    from the tile's staged column factors against
    ``fused_dense_act_ref``; against the mma.sync body's output (the same
    epilogue per element) within a few f32 roundings of the sum order."""
    from repro_torch.kernels import _baselines
    from repro_torch.kernels.fused_dense_act.ref import fused_dense_act_ref

    a, b, _ = _baseline_case(cuda_device, m, k, n, 48)
    vec = _vectors(cuda_device, n, 49)
    kw = dict(beta=vec["bias"], mean=vec["mean"], var=vec["var"], eps=1e-5)
    for act in _baselines.B6_ACTS:
        got = _baselines.FUSED_DENSE_ACT(a, b, out, act=act, **kw)
        assert _baselines.FUSED_DENSE_ACT.last_body == "ring"
        want = fused_dense_act_ref(a, b, vec["bias"], vec["mean"],
                                   vec["var"], act=act, eps=1e-5,
                                   out_dtype=out)
        _assert_close_scaled(got, want, torch.bfloat16)
        if out == torch.float32:
            mma = _baselines.FUSED_DENSE_ACT(a, b, out, act=act, body="mma",
                                             **kw)
            assert _baselines.FUSED_DENSE_ACT.last_body == "mma"
            torch.testing.assert_close(got, mma, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_baseline_ring_on_two_streams_at_once(cuda_device):
    """B5 and B7 launched on two streams at once give the bits each gives
    alone (the ring keeps no state between launches)."""
    from repro_torch.kernels import _baselines

    a, b, g = _baseline_case(cuda_device, 1024, 2048, 2048, 42)
    want = (_baselines.MATMUL(a, b, torch.bfloat16),
            _baselines.FUSED_RNZ(a, b, torch.bfloat16, g=g))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    got = []
    for _ in range(3):
        with torch.cuda.stream(streams[0]):
            x = _baselines.MATMUL(a, b, torch.bfloat16)
        with torch.cuda.stream(streams[1]):
            y = _baselines.FUSED_RNZ(a, b, torch.bfloat16, g=g)
        got.append((x, y))
    torch.cuda.synchronize()
    for x, y in got:
        assert torch.equal(x, want[0]) and torch.equal(y, want[1])


@pytest.mark.gpu
def test_baseline_bodies_forced_and_refused(cuda_device):
    """A forced body runs where the operands allow it and raises where
    they do not; the ring and the mma.sync body agree."""
    from repro_torch.kernels import _baselines
    from repro_torch.kernels.matmul.ref import matmul_ref

    a, b, g = _baseline_case(cuda_device, 256, 512, 384, 43)
    ring = _baselines.MATMUL(a, b, torch.float32, body="ring")
    mma = _baselines.MATMUL(a, b, torch.float32, body="mma")
    assert _baselines.MATMUL.last_body == "mma"
    _assert_close_scaled(ring, matmul_ref(a, b, torch.float32),
                         torch.bfloat16)
    torch.testing.assert_close(ring, mma, rtol=1e-4, atol=1e-4)
    before = _baselines.MATMUL.launches
    flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=cuda_device)
    offset = flat[1:].view(a.shape)
    with pytest.raises(ValueError, match="ring body cannot take"):
        _baselines.MATMUL(offset, b, torch.float32, body="ring")
    with pytest.raises(ValueError, match="ring body cannot take"):
        _baselines.FUSED_RNZ(a.float(), b.float(), torch.float32,
                             g=g.float(), body="ring")
    b6 = dict(beta=torch.randn(384, device=cuda_device),
              mean=torch.zeros(384, device=cuda_device),
              var=torch.ones(384, device=cuda_device), act="gelu")
    b6_before = _baselines.FUSED_DENSE_ACT.launches
    with pytest.raises(ValueError, match="ring body cannot take"):
        _baselines.FUSED_DENSE_ACT(offset, b, torch.float32, body="ring",
                                   **b6)
    with pytest.raises(ValueError, match="fma body does not take"):
        _baselines.MATMUL(a, b, torch.float32, body="fma")
    assert _baselines.MATMUL.launches == before
    assert _baselines.FUSED_DENSE_ACT.launches == b6_before
    # B6 takes the ring like B5 and B7, and agrees with its mma.sync body
    ring = _baselines.FUSED_DENSE_ACT(a, b, torch.float32, body="ring", **b6)
    mma = _baselines.FUSED_DENSE_ACT(a, b, torch.float32, body="mma", **b6)
    torch.testing.assert_close(ring, mma, rtol=1e-4, atol=1e-4)
    # the offset view runs the mma.sync body by default
    _baselines.MATMUL(offset, b, torch.float32)
    assert _baselines.MATMUL.last_body == "mma"


# --------------------------------------------------------------------------
# a failed launch drops its stream's scratch (B1's and B2's counters)
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_failed_contract_launch_drops_its_streams_counters(cuda_device):
    """Counters left set (a launch cut off), then a launch that fails on
    the same stream: the launcher drops the stream's scratch, so the next
    split GEMM there starts from zeroed counters and is right."""
    from repro_torch.codegen import CONTRACT, contract_ref

    gen = torch.Generator(device=cuda_device).manual_seed(44)
    a = torch.randn(1, 128, 4096, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(1, 4096, 1024, generator=gen,
                    device=cuda_device).bfloat16()
    spec = PE.matmul_spec(128, 4096, 1024)
    want = contract_ref(spec, a[0], b[0], out_dtype=torch.bfloat16)
    _assert_close_scaled(CONTRACT(a, b, torch.bfloat16)[0], want,
                         torch.bfloat16)
    assert CONTRACT.last_body == "ring" and CONTRACT.last_plan.splits > 1
    # the pool's key is the operands' device (with its index)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _, counter = CONTRACT._scratch.get(a.device, stream, 0, 1)
    counter.fill_(1)
    with pytest.raises(RuntimeError, match="launch failed"):
        CONTRACT(a.float(), b.float(), torch.float32, body="ring")
    assert (a.device, stream) not in CONTRACT._scratch._bufs
    got = CONTRACT(a, b, torch.bfloat16)[0]
    assert CONTRACT.last_plan.splits > 1
    _assert_close_scaled(got, want, torch.bfloat16)


@pytest.mark.gpu
def test_failed_attention_launch_drops_its_streams_counter(cuda_device,
                                                           monkeypatch):
    from repro_torch.codegen import fused_gen

    launcher = fused_gen.AttentionLauncher()
    q, k, v = (torch.randn(2, 64, 64, device=cuda_device).bfloat16()
               for _ in range(3))
    out = launcher(q, k, v, True, None, torch.bfloat16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _, sched = launcher._scratch.get(q.device, stream, 0, 2)
    real = launcher._fn()
    monkeypatch.setattr(launcher, "_fn", lambda: types.SimpleNamespace(
        attention_launch_plan=lambda *args: 9))
    with pytest.raises(RuntimeError, match="launch failed"):
        launcher(q, k, v, True, None, torch.bfloat16)
    assert (q.device, stream) not in launcher._scratch._bufs
    monkeypatch.setattr(launcher, "_fn", lambda: real)
    again = launcher(q, k, v, True, None, torch.bfloat16)
    assert launcher._scratch.get(q.device, stream, 0, 2)[1] is not sched
    assert torch.equal(again, out)


# --------------------------------------------------------------------------
# B1's int8 / fp8 modes, the upcast body and the chain
# --------------------------------------------------------------------------

QFMT_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _q_operand(shape, fmt, gen, device):
    """Seeded 8-bit values: ints in [-127, 127], or normals rounded to e4m3."""
    if fmt == "int8":
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int32).to(torch.int8)
    return (torch.randn(shape, generator=gen, device=device) * 4).to(
        torch.float8_e4m3fn)


def _launcher_of(fmt):
    return cuda_gen.CONTRACT_INT8 if fmt == "int8" else cuda_gen.CONTRACT_FP8


def _assert_quant_close(got, want, fmt):
    """int8 exactly; fp8 at the f32 TOL scaled."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if fmt == "int8":
        assert torch.equal(got, want)
    else:
        _assert_close_scaled(got, want, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("kmajor", [False, True], ids=["w_nmajor", "w_kmajor"])
@pytest.mark.parametrize("m,k,n", [(128, 256, 384), (77, 130, 45),
                                   (3, 5, 7), (1000, 999, 1001),
                                   (256, 4096, 512), (64, 48, 32)])
def test_cuda_8bit_mode_matches_plain_version(cuda_device, m, k, n, kmajor,
                                              fmt):
    """The raw quantized spec (no epilogue): int32 out for int8, exact;
    f32 out for fp8; W either n-major or k-major (a transposed view)."""
    gen = torch.Generator(device=cuda_device).manual_seed(40)
    a = _q_operand((m, k), fmt, gen, cuda_device)
    b = _q_operand((n, k) if kmajor else (k, n), fmt, gen, cuda_device)
    if kmajor:
        b = b.t()
    spec = PE.quantize_spec(PE.matmul_spec(m, k, n), fmt=fmt)
    kern = codegen.compile(spec, codegen.default_schedule(spec))
    before = _launcher_of(fmt).launches
    got = kern(a, b)
    assert _launcher_of(fmt).launches == before + 1
    want = cuda_gen.contract_ref(spec, a, b,
                                 out_dtype=cuda_gen._default_out_dtype(
                                     spec, None, a.dtype))
    assert got.dtype == (torch.int32 if fmt == "int8" else torch.float32)
    _assert_quant_close(got, want, fmt)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("family,extents", [
    ("matvec", (300, 70)),
    ("batched_matmul", (3, 40, 50, 60)),
    ("transposed_matmul", (96, 64, 80)),
    ("weighted_matmul", (77, 130, 45)),
    ("chain_matmul", (70, 30, 50, 20)),
])
def test_cuda_quantized_families(cuda_device, family, extents, fmt):
    """Every family of tests/test_differential.py at the 8-bit tier, and
    the derived backward specs of the three-operand ones: two-operand
    products on the tensor cores, the weighted family on the upcast body,
    the chain on the chain kernel's CUDA-core body."""
    from repro_torch.grad import derived_specs

    base = getattr(PE, f"{family}_spec")(*extents)
    specs = [base] + (list(derived_specs(base).values())
                      if len(base.operands) == 3 else [])
    gen = torch.Generator(device=cuda_device).manual_seed(41)
    for root in specs:
        spec = PE.quantize_spec(root, fmt=fmt)
        arrays = [_q_operand([spec.extents[i] for i in ax], fmt, gen,
                             cuda_device) for ax in spec.operands.values()]
        launchers = (cuda_gen.CONTRACT_INT8, cuda_gen.CONTRACT_FP8,
                     cuda_gen.CONTRACT_UPCAST, cuda_gen.CONTRACT_CHAIN)
        before = sum(x.launches for x in launchers)
        got = codegen.compile(spec, codegen.default_schedule(spec))(*arrays)
        assert sum(x.launches for x in launchers) == before + 1, spec.name
        want = cuda_gen.contract_ref(
            spec, *arrays,
            out_dtype=cuda_gen._default_out_dtype(spec, None, arrays[0].dtype))
        _assert_quant_close(got, want, fmt)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("act", ["id", "gelu"])
def test_cuda_dequant_epilogue(cuda_device, fmt, act):
    """dequant -> scale -> bias -> act on the int32/f32 accumulator, f32
    out, against the plain version."""
    m, k, n = 192, 256, 320
    gen = torch.Generator(device=cuda_device).manual_seed(42)
    a = _q_operand((m, k), fmt, gen, cuda_device)
    b = _q_operand((k, n), fmt, gen, cuda_device)
    epi = codegen.Epilogue(dequant=True, scale=True, bias=True, act=act)
    vecs = {"qscale": torch.rand(n, generator=gen, device=cuda_device) / 100,
            "scale": torch.randn(n, generator=gen, device=cuda_device),
            "bias": torch.randn(n, generator=gen, device=cuda_device)}
    spec = PE.quantize_spec(PE.matmul_spec(m, k, n), fmt=fmt)
    got = codegen.compile(spec, codegen.default_schedule(spec),
                          epilogue=epi)(a, b, **vecs)
    want = cuda_gen.contract_ref(spec, a, b, out_dtype=torch.float32,
                                 epilogue=epi, vectors=vecs)
    assert got.dtype == torch.float32
    _assert_close_scaled(got, want, torch.float32)


#: the launcher and body each spec of the 8-bit weighted family takes
#: where every operand is 8-bit and the rings take the shapes
#: (``cuda_gen.eight_bit_route``): (launcher, body) by spec name
WEIGHTED_RING_ROUTES = {
    "int8": {"weighted_matmul": ("CONTRACT_INT8", "ring"),
             "weighted_matmul.dA": ("CONTRACT_INT8", "ring"),
             "weighted_matmul.dB": ("CONTRACT_INT8", "ring"),
             "weighted_matmul.dg": ("CONTRACT_INT8", "ring")},
    "fp8": {"weighted_matmul": ("CONTRACT", "ring"),
            "weighted_matmul.dA": ("CONTRACT_FP8", "ring"),
            "weighted_matmul.dB": ("CONTRACT_FP8", "ring"),
            "weighted_matmul.dg": ("CONTRACT_FP8", "ring")},
}


def _weighted_8bit_cases(fmt, m, d, f, seed, device):
    from repro_torch.grad import derived_specs

    base = PE.weighted_matmul_spec(m, d, f)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for root in [base, *derived_specs(base).values()]:
        spec = PE.quantize_spec(root, fmt=fmt)
        arrays = [_q_operand([spec.extents[i] for i in ax], fmt, gen, device)
                  for ax in spec.operands.values()]
        out.append((spec, arrays))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("m,d,f", [
    (2048, 4096, 12288),  # the fused path's shape
    (1040, 400, 1008),    # M and N past whole 128-wide tiles
    (384, 80, 400),       # the CPU emulation's shape
])
def test_8bit_weighted_family_runs_its_rings(cuda_device, m, d, f, fmt):
    """The int8 weighted family on the 8-bit ring (byte planes, the
    multiplier, the row reduce), bit for bit against ``contract_ref``;
    the fp8 family on the 8-bit ring and its forward on the bf16 k-scale
    ring, at the f32 TOL; one launch a spec, none on the upcast body."""
    launchers = {"CONTRACT": cuda_gen.CONTRACT,
                 "CONTRACT_INT8": cuda_gen.CONTRACT_INT8,
                 "CONTRACT_FP8": cuda_gen.CONTRACT_FP8,
                 "CONTRACT_UPCAST": cuda_gen.CONTRACT_UPCAST}
    for spec, arrays in _weighted_8bit_cases(fmt, m, d, f, 45, cuda_device):
        name, body = WEIGHTED_RING_ROUTES[fmt][spec.name]
        before = {k: v.launches for k, v in launchers.items()}
        got = codegen.compile(spec, codegen.default_schedule(spec))(*arrays)
        torch.cuda.synchronize()
        after = {k: v.launches for k, v in launchers.items()}
        assert {k: after[k] - before[k] for k in launchers} == {
            k: int(k == name) for k in launchers}, spec.name
        assert launchers[name].last_body == body, spec.name
        want = cuda_gen.contract_ref(
            spec, *arrays,
            out_dtype=cuda_gen._default_out_dtype(spec, None,
                                                  arrays[0].dtype))
        _assert_quant_close(got, want, fmt)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_8bit_ring_row_reduce_is_deterministic(cuda_device, fmt):
    """``weighted_matmul.dg`` on the 8-bit ring: five launches give the
    same bits (per-CTA column sums in a fixed order, then the last CTA of
    each column block sums the rows in order; its counter is set back to
    0)."""
    spec, arrays = _weighted_8bit_cases(fmt, 1040, 400, 1008, 46,
                                        cuda_device)[3]
    assert spec.name == "weighted_matmul.dg"
    kern = codegen.compile(spec, codegen.default_schedule(spec))
    runs = [kern(*arrays) for _ in range(5)]
    assert _launcher_of(fmt).last_body == "ring"
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


@pytest.mark.gpu
def test_8bit_ring_modes_refused_off_the_ring(cuda_device):
    """The 8-bit launchers take a multiplier, a row reduce or a k-scale
    on the ring only: forced onto mma.sync, or on operands the ring
    cannot read, they raise before launching; a k-scale must be int8."""
    gen = torch.Generator(device=cuda_device).manual_seed(47)
    a = _q_operand((1, 128, 256), "int8", gen, cuda_device)
    b = _q_operand((1, 384, 256), "int8", gen, cuda_device).transpose(1, 2)
    g = _q_operand((256,), "int8", gen, cuda_device)
    mul = modes.VecArg(torch.ones(384, dtype=torch.int32,
                                  device=cuda_device), 2)
    launcher = cuda_gen.CONTRACT_INT8
    before = launcher.launches
    with pytest.raises(ValueError, match="on the ring only"):
        launcher(a, b, torch.int32, int_acc=True, mul=mul, body="mma")
    with pytest.raises(ValueError, match="on the ring only"):
        launcher(a, b.contiguous(), torch.int32, int_acc=True, mul=mul)
    with pytest.raises(ValueError, match="int8 planes"):
        launcher(a, b, torch.int32, int_acc=True,
                 kscale=modes.VecArg(g.int(), 3))
    assert launcher.launches == before
    got = launcher(a, b, torch.int32, int_acc=True,
                   kscale=modes.VecArg(g, 3))
    assert launcher.last_body == "ring"
    # float64 holds these sums exactly (below 2**53); the card has no
    # integer matmul
    want = ((a[0].double() * g.double()) @ b[0].double()).to(
        torch.int64).to(torch.int32)
    assert torch.equal(got[0], want)


#: one qwen3-8b head's (QK^T)V without softmax over a 4096-token context
CHAIN_SHAPE = (4096, 128, 4096, 128)


def _chain_arrays(spec, dtype, gen, device):
    return [(torch.randn([spec.extents[i] for i in ax], generator=gen,
                         device=device) / 4).to(dtype)
            for ax in spec.operands.values()]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extents", [
    CHAIN_SHAPE, (4096 // 16, 128, 4096 // 16, 128),
    (77, 33, 130, 45), (3, 5, 7, 2), (40, 300, 20, 500), (200, 16, 8, 300),
    # run as written: R under one tile, P = 900 not a multiple of the
    # cluster's split, N = 100 narrower than a cluster's columns
    (20, 900, 24, 100),
    (200, 1000, 130, 1000),
])
def test_cuda_chain_matches_plain_version(cuda_device, extents, dtype):
    """``chain_matmul`` and its derived ``.dA``, ``.dB``, ``.dC``, one
    chain launch each, whichever association the cost picks."""
    from repro_torch.grad import derived_specs

    base = PE.chain_matmul_spec(*extents)
    gen = torch.Generator(device=cuda_device).manual_seed(43)
    for spec in [base] + list(derived_specs(base).values()):
        arrays = _chain_arrays(spec, dtype, gen, cuda_device)
        kern = codegen.compile(spec, codegen.default_schedule(spec))
        before = cuda_gen.CONTRACT_CHAIN.launches
        got = kern(*arrays)
        assert cuda_gen.CONTRACT_CHAIN.launches == before + 1, spec.name
        want = cuda_gen.contract_ref(spec, *arrays, out_dtype=dtype)
        assert got.shape == want.shape and got.dtype == dtype
        _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8",
                                   "fp8"])
@pytest.mark.parametrize("extents", [CHAIN_SHAPE, (20, 900, 24, 100)])
def test_cuda_chain_two_launches_give_equal_bits(cuda_device, extents,
                                                 dtype):
    """The cluster sums T's partials in rank order, with no atomics: two
    launches on the same inputs give the same bits, for every spec."""
    from repro_torch.grad import derived_specs

    base = PE.chain_matmul_spec(*extents)
    gen = torch.Generator(device=cuda_device).manual_seed(47)
    for spec in [base] + list(derived_specs(base).values()):
        if isinstance(dtype, str):
            spec = PE.quantize_spec(spec, fmt=dtype)
            arrays = [_q_operand([spec.extents[i] for i in ax], dtype, gen,
                                 cuda_device)
                      for ax in spec.operands.values()]
        else:
            arrays = _chain_arrays(spec, dtype, gen, cuda_device)
        kern = codegen.compile(spec, codegen.default_schedule(spec))
        before = cuda_gen.CONTRACT_CHAIN.launches
        first, second = kern(*arrays), kern(*arrays)
        assert cuda_gen.CONTRACT_CHAIN.launches == before + 2, spec.name
        torch.cuda.synchronize()
        assert torch.equal(first, second), spec.name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_chain_epilogue(cuda_device, dtype):
    spec = PE.chain_matmul_spec(70, 40, 90, 50)
    gen = torch.Generator(device=cuda_device).manual_seed(44)
    arrays = _chain_arrays(spec, dtype, gen, cuda_device)
    epi = codegen.Epilogue(act="silu", scale=True, bias=True, norm=True)
    vecs = _vectors(cuda_device, 50, 45)
    got = codegen.compile(spec, codegen.default_schedule(spec),
                          epilogue=epi)(*arrays, **vecs)
    want = cuda_gen.contract_ref(spec, *arrays, out_dtype=dtype,
                                 epilogue=epi, vectors=vecs)
    _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_dense_autograd_on_the_card(cuda_device, dtype):
    """``ops.chain_dense`` forward and backward: 1 + 3 chain launches, and
    the output and the three gradients of the CPU's plain path."""
    gen = torch.Generator(device=cuda_device).manual_seed(46)
    shapes = ((96, 40), (40, 130), (130, 24))
    leaves = [(torch.randn(s, generator=gen, device=cuda_device) / 4).to(
        dtype).requires_grad_(True) for s in shapes]
    cpu = [t.detach().cpu().requires_grad_(True) for t in leaves]
    dout = torch.randn(96, 24, generator=gen, device=cuda_device).to(dtype)
    before = cuda_gen.CONTRACT_CHAIN.launches
    out = ops.chain_dense(*leaves)
    assert cuda_gen.CONTRACT_CHAIN.launches == before + 1
    out.backward(dout)
    assert cuda_gen.CONTRACT_CHAIN.launches == before + 4
    ref = ops.chain_dense(*cpu, interpret=True)
    ref.backward(dout.cpu())
    _assert_close_scaled(out.cpu(), ref.detach(), dtype)
    for got, want in zip(leaves, cpu):
        _assert_close_scaled(got.grad.cpu(), want.grad, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantization_on_the_card_is_bit_for_bit(cuda_device, fmt, dtype):
    """``optim.quant`` on a CUDA tensor gives the CPU's bits (true f32
    divisions, not PyTorch's reciprocal for a host-scalar divisor)."""
    from repro_torch.optim import quant as Q

    gen = torch.Generator(device=cuda_device).manual_seed(48)
    x = (torch.randn(300, 257, generator=gen, device=cuda_device) * 3).to(
        dtype)
    raw = lambda t: t.cpu().view(torch.uint8) if t.element_size() == 1 \
        else t.cpu()  # noqa: E731
    for fn in (Q.quantize_tensor, Q.quantize_channels):
        for a, b in zip(fn(x, fmt), fn(x.cpu(), fmt)):
            assert torch.equal(raw(a), raw(b)), fn.__name__
    qt, st = Q.quantize_channels_kmajor(x, fmt)
    q, s = Q.quantize_channels(x.cpu(), fmt)
    assert torch.equal(raw(qt.t().contiguous()), raw(q))
    assert torch.equal(st.cpu(), s)
    for a, b in ((Q.quantize(x), Q.quantize(x.cpu())),):
        assert torch.equal(a.q.cpu(), b.q) and torch.equal(a.scale.cpu(),
                                                             b.scale)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_dense_quant_on_the_card(cuda_device, fmt):
    """``ops.dense(quant=)``: one 8-bit launch, the CPU kernel path's
    output at the f32 TOL (scaled), and no silent gradient."""
    gen = torch.Generator(device=cuda_device).manual_seed(47)
    x = torch.randn(256, 384, generator=gen, device=cuda_device).bfloat16()
    w = (torch.randn(384, 512, generator=gen, device=cuda_device) / 8
         ).bfloat16()
    before = _launcher_of(fmt).launches
    got = ops.dense(x, w, quant=fmt, out_dtype=torch.float32)
    assert _launcher_of(fmt).launches == before + 1
    want = ops.dense(x.cpu(), w.cpu(), quant=fmt, interpret=True,
                     out_dtype=torch.float32)
    _assert_close_scaled(got.cpu(), want, torch.float32)
    assert ops.dense(x, w, quant=fmt).dtype == torch.bfloat16
    xg = x.clone().requires_grad_(True)
    out = ops.dense(xg, w, quant=fmt)
    with pytest.raises(RuntimeError, match="not differentiable"):
        out.float().sum().backward()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("m,d,f", [(77, 130, 45), (3, 5, 7),
                                   (1000, 999, 1001)])
def test_dense_quant_ragged_on_the_card(cuda_device, monkeypatch, m, d, f,
                                        fmt):
    """A ragged ``ops.dense(quant=)`` on the card runs the 8-bit kernel
    too: one launch and no library GEMM (``torch.matmul`` is barred for
    the call), the CPU's dequantize-then-dot of the same call at the f32
    TOL (scaled)."""
    gen = torch.Generator(device=cuda_device).manual_seed(48)
    x = torch.randn(m, d, generator=gen, device=cuda_device).bfloat16()
    w = (torch.randn(d, f, generator=gen, device=cuda_device) / 8
         ).bfloat16()

    def barred(*args, **kwargs):
        raise AssertionError("a library GEMM on the 8-bit kernel path")

    before = _launcher_of(fmt).launches
    with monkeypatch.context() as patch:
        patch.setattr(torch, "matmul", barred)
        got = ops.dense(x, w, quant=fmt, out_dtype=torch.float32)
        torch.cuda.synchronize()
    assert _launcher_of(fmt).launches == before + 1
    want = ops.dense(x.cpu(), w.cpu(), quant=fmt, out_dtype=torch.float32)
    _assert_close_scaled(got.cpu(), want, torch.float32)


# --------------------------------------------------------------------------
# flash attention, B2
# --------------------------------------------------------------------------

ATTN_MASKS = ("full", "causal", "lengths", "causal+lengths")


@pytest.mark.gpu
@pytest.mark.parametrize("mask", ATTN_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 8, 112, 128])
def test_attention_kernel_matches_plain_version(cuda_device, d, dtype, mask):
    """B2 against ``attention_ref`` on the same CUDA tensors at ragged S and
    T; ``kv_lengths`` has a 0 entry (exact zeros) and one past T."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    h, s, t = 3, 100, 77
    q = torch.randn(h, s, d, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(h, t, d, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(h, t, d, generator=g, device=cuda_device).to(dtype)
    causal = "causal" in mask
    lengths = (torch.tensor([50, 0, 200], dtype=torch.int32,
                            device=cuda_device)
               if "lengths" in mask else None)
    before = fused_gen.ATTENTION.launches
    got = fused_gen.ATTENTION(q, k, v, causal, lengths, dtype)
    torch.cuda.synchronize()
    assert fused_gen.ATTENTION.launches == before + 1
    want = fused_gen.attention_ref(q, k, v, causal=causal,
                                   kv_lengths=lengths, out_dtype=dtype)
    assert got.shape == (h, s, d) and got.dtype == dtype
    _assert_rows_close(got, want, dtype)
    if lengths is not None:
        assert bool((got[1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,e", [(256, 256), (196, 72), (64, 256)])
def test_attention_kernel_wide_and_unequal_heads(cuda_device, d, e, dtype):
    """The widest heads (d, e up to 256, the most shared memory), d not a
    multiple of 8 (element-wise loads) and e wider than d; strided q."""
    g = torch.Generator(device=cuda_device).manual_seed(e)
    h, s, t = 2, 130, 190
    q = torch.randn(s, h, d, generator=g, device=cuda_device).to(dtype)
    q = q.transpose(0, 1)  # heads not outermost in memory
    k = torch.randn(h, t, d, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(h, t, e, generator=g, device=cuda_device).to(dtype)
    for causal in (False, True):
        got = fused_gen.ATTENTION(q, k, v, causal, None, dtype)
        want = fused_gen.attention_ref(q, k, v, causal=causal,
                                       kv_lengths=None, out_dtype=dtype)
        _assert_rows_close(got, want, dtype)
    with pytest.raises(ValueError, match="up to 256"):
        fused_gen.ATTENTION(q, k, torch.zeros(h, t, 257, device=cuda_device,
                                              dtype=dtype),
                            False, None, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_forward_and_backward_launches(cuda_device, causal, dtype):
    """``ops.attention`` on the card: one B2 launch forward, three B1
    launches backward (``attention.dQ/.dK/.dV``), nothing else; output
    and cotangents held to the same call on the CPU."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    h, s, t, d = 4, 96, 80, 64
    base = [torch.randn(h, n, d, generator=g, device=cuda_device).to(dtype)
            for n in (s, t, t)]
    dout = torch.randn(h, s, d, generator=g, device=cuda_device).to(dtype)
    leaves = [x.clone().requires_grad_(True) for x in base]
    b2, b1 = fused_gen.ATTENTION.launches, cuda_gen.CONTRACT.launches
    out = ops.attention(*leaves, causal=causal)
    assert (fused_gen.ATTENTION.launches - b2,
            cuda_gen.CONTRACT.launches - b1) == (1, 0)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fused_gen.ATTENTION.launches - b2,
            cuda_gen.CONTRACT.launches - b1) == (1, 3)
    cpu = [x.detach().cpu().requires_grad_(True) for x in base]
    want = ops.attention(*cpu, causal=causal, interpret=True)
    want.backward(dout.cpu())
    for a, b in zip([out] + [x.grad for x in leaves],
                    [want] + [x.grad for x in cpu]):
        _assert_rows_close(a.detach().cpu(), b.detach(), dtype)
    # kv_lengths without a gradient reaches the kernel too
    lengths = torch.tensor([80, 0, 5, 33], dtype=torch.int32)
    before = fused_gen.ATTENTION.launches
    got = ops.attention(*base, causal=causal, kv_lengths=lengths.cuda(),
                        differentiable=False)
    assert fused_gen.ATTENTION.launches == before + 1
    want = ops.attention(*(x.cpu() for x in base), causal=causal,
                         kv_lengths=lengths, differentiable=False,
                         interpret=True)
    _assert_rows_close(got.cpu(), want, dtype)
    assert bool((got[1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_with_lengths_backward_launches(cuda_device, causal,
                                                  dtype):
    """The default (differentiable) call with ``kv_lengths`` runs on the
    kernels too: one B2 launch forward, three B1 backward; the head of
    length 0 gets zeros and zero cotangents; output and cotangents held to
    the same call on the CPU."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    h, s, t, d = 4, 96, 80, 64
    base = [torch.randn(h, n, d, generator=g, device=cuda_device).to(dtype)
            for n in (s, t, t)]
    dout = torch.randn(h, s, d, generator=g, device=cuda_device).to(dtype)
    lengths = torch.tensor([80, 0, 5, 33], dtype=torch.int32)
    leaves = [x.clone().requires_grad_(True) for x in base]
    b2, b1 = fused_gen.ATTENTION.launches, cuda_gen.CONTRACT.launches
    out = ops.attention(*leaves, causal=causal, kv_lengths=lengths.cuda())
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fused_gen.ATTENTION.launches - b2,
            cuda_gen.CONTRACT.launches - b1) == (1, 3)
    cpu = [x.detach().cpu().requires_grad_(True) for x in base]
    want = ops.attention(*cpu, causal=causal, kv_lengths=lengths,
                         interpret=True)
    want.backward(dout.cpu())
    assert bool((out[1] == 0).all())
    for a, b in zip([out] + [x.grad for x in leaves],
                    [want] + [x.grad for x in cpu]):
        assert bool(torch.isfinite(a).all())
        _assert_rows_close(a.detach().cpu(), b.detach(), dtype)
    for x in leaves:
        assert bool((x.grad[1] == 0).all())


#: the body each dtype's main-path shapes take (d and e up to 128, aligned)
ATTN_NEW_BODY = {torch.bfloat16: "ring", torch.float32: "tc32"}


def _attn_operands(device, h, s, t, d, e, dtype, seed):
    """q as a transposed view (stored (s, h, d): heads not outermost), k
    and v contiguous."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(s, h, d, generator=g, device=device).to(dtype)
    k = torch.randn(h, t, d, generator=g, device=device).to(dtype)
    v = torch.randn(h, t, e, generator=g, device=device).to(dtype)
    return q.transpose(0, 1), k, v


@pytest.mark.gpu
@pytest.mark.parametrize("mask", ATTN_MASKS)
@pytest.mark.parametrize("s,t", [(100, 77), (130, 190)])
@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_ring_and_tc32_bodies_match_plain_version(
        cuda_device, dtype, d, s, t, mask):
    """B2's bf16 ring and f32 3xTF32 bodies against ``attention_ref`` at
    ragged S and T (S < T and S > T, so causal rows see fewer or more
    columns than there are rows), a transposed q view, d in {64, 112, 128}
    (112: the second TMA box zero-filled past d); ``kv_lengths`` with a 0
    entry (exact zeros) and one past T."""
    h = 3
    q, k, v = _attn_operands(cuda_device, h, s, t, d, d, dtype, d + s)
    causal = "causal" in mask
    lengths = (torch.tensor([50, 0, t + 20], dtype=torch.int32,
                            device=cuda_device)
               if "lengths" in mask else None)
    before = fused_gen.ATTENTION.launches
    got = fused_gen.ATTENTION(q, k, v, causal, lengths, dtype)
    torch.cuda.synchronize()
    assert fused_gen.ATTENTION.launches == before + 1
    assert fused_gen.ATTENTION.last_body == ATTN_NEW_BODY[dtype]
    want = fused_gen.attention_ref(q, k, v, causal=causal,
                                   kv_lengths=lengths, out_dtype=dtype)
    assert got.shape == (h, s, d) and got.dtype == dtype
    _assert_rows_close(got, want, dtype)
    if lengths is not None:
        assert bool((got[1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,e", [(64, 128), (128, 64), (8, 24), (128, 128),
                                 (40, 96)])
def test_attention_new_bodies_unequal_heads_and_other_output(cuda_device, d,
                                                             e, dtype):
    """Every (d, e) width pair of the ring (one or two TMA boxes each; e <=
    64 on the n64 register-A wgmma) and of the 3xTF32 body (e <= 64 and
    above), causal with S != T, the output in the other dtype (f32 from
    bf16 inputs, bf16 from f32)."""
    h, s, t = 2, 200, 130
    q, k, v = _attn_operands(cuda_device, h, s, t, d, e, dtype, d * e)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    for out_dtype in (dtype, other):
        got = fused_gen.ATTENTION(q, k, v, True, None, out_dtype)
        assert fused_gen.ATTENTION.last_body == ATTN_NEW_BODY[dtype]
        assert got.dtype == out_dtype
        want = fused_gen.attention_ref(q, k, v, causal=True,
                                       kv_lengths=None, out_dtype=torch.float32)
        _assert_rows_close(got, want, torch.bfloat16 if torch.bfloat16 in (
            dtype, out_dtype) else dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_new_bodies_two_launches_give_equal_bits(cuda_device,
                                                           dtype):
    """Two launches of the ring (bf16) or the 3xTF32 body (f32) on the same
    inputs give the same bits: no atomics, no order that changes."""
    h, s, t, d = 4, 300, 260, 128
    q, k, v = _attn_operands(cuda_device, h, s, t, d, d, dtype, 5)
    lengths = torch.tensor([260, 0, 7, 300], dtype=torch.int32,
                           device=cuda_device)
    first = fused_gen.ATTENTION(q, k, v, True, lengths, dtype)
    again = fused_gen.ATTENTION(q, k, v, True, lengths, dtype)
    assert fused_gen.ATTENTION.last_body == ATTN_NEW_BODY[dtype]
    assert torch.equal(first, again)


def _attention_with_body(q, k, v, causal, out_dtype, body):
    """(rc, out): one ``attention_launch`` of the named body, called through
    the C entry (the launcher always takes ``attention_body``'s choice),
    on a tile counter of its own; ``out`` is meaningful only where rc is
    0."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    h, s, _ = q.shape
    t, e = k.shape[1], v.shape[2]
    out = torch.empty((h, s, e), dtype=out_dtype, device=q.device)
    sched = torch.zeros(2, dtype=torch.int32, device=q.device)
    rc = fused_gen.ATTENTION._fn().attention_launch(
        codes[q.dtype], codes[out_dtype], int(causal),
        fused_gen.ATTENTION_BODIES.index(body),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
        sched.data_ptr(), h, s, t, q.shape[2], e,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        torch.cuda.current_stream(q.device).cuda_stream)
    torch.cuda.synchronize()
    return rc, out


@pytest.mark.gpu
def test_attention_bodies_agree_and_refuse_what_they_cannot_take(
        cuda_device):
    """Each body through the C entry: the ring and the mma.sync body agree
    on a shape both take (as do the 3xTF32 and FMA bodies); the kernel
    refuses a body whose rules the call fails (the ring at d = 4 or on
    f32, the 3xTF32 body on bf16 or at d = 196, an element-strided ring
    operand) with cudaErrorInvalidValue, launching nothing."""
    h, s, t, d = 2, 150, 170, 64
    for dtype, bodies in ((torch.bfloat16, ("ring", "mma")),
                          (torch.float32, ("tc32", "fma"))):
        q, k, v = _attn_operands(cuda_device, h, s, t, d, d, dtype, 11)
        want = fused_gen.attention_ref(q, k, v, causal=True,
                                       kv_lengths=None, out_dtype=dtype)
        assert fused_gen.attention_body(q, k, v) == bodies[0]
        for body in bodies:
            rc, got = _attention_with_body(q, k, v, True, dtype, body)
            assert rc == 0
            _assert_rows_close(got, want, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(12)

    def qkv(d, dtype):
        return [torch.randn(h, n, d, generator=g, device=cuda_device)
                .to(dtype) for n in (s, t, t)]

    strided = qkv(64, torch.bfloat16)
    strided[1] = torch.randn(h, t, 68, generator=g, device=cuda_device
                             ).bfloat16()[:, :, :64]  # row stride 68
    refused = [(qkv(4, torch.bfloat16), "ring"),
               (qkv(64, torch.float32), "ring"),
               (qkv(64, torch.bfloat16), "tc32"),
               (qkv(196, torch.float32), "tc32"),
               (qkv(64, torch.float32), "mma"),
               (qkv(64, torch.bfloat16), "fma"),
               (strided, "ring")]
    invalid = 1  # cudaErrorInvalidValue
    for (q, k, v), body in refused:
        rc, _ = _attention_with_body(q, k, v, False, q.dtype, body)
        assert rc == invalid, body
    assert fused_gen.attention_body(*strided) == "mma"


@pytest.mark.gpu
def test_attention_ring_on_two_streams_gives_equal_bits(cuda_device):
    """Ring launches on two streams at once give the bits of a launch on
    the default stream: each stream takes its tiles from a counter of its
    own, which every launch leaves at zero.  16 tiles of 64 KV blocks each,
    so the two grids run side by side; each output's memory is filled with
    NaN just before its launch, so a tile that no CTA wrote shows."""
    h, s, t, d = 8, 256, 8192, 128
    q, k, v = _attn_operands(cuda_device, h, s, t, d, d, torch.bfloat16, 13)
    want = fused_gen.ATTENTION(q, k, v, False, None, torch.bfloat16)
    assert fused_gen.ATTENTION.last_body == "ring"
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    for _ in range(3):
        outs = []
        for st in streams:
            with torch.cuda.stream(st):
                # the block the launcher's output takes next on this stream
                torch.full_like(want, float("nan"))
                outs.append(fused_gen.ATTENTION(q, k, v, False, None,
                                                torch.bfloat16))
        torch.cuda.synchronize()
        for got in outs:
            assert torch.equal(got, want)
    counters = [fused_gen.ATTENTION._scratch.get(
        q.device, st.cuda_stream, 0, 2)[1] for st in streams]
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert not any(bool(c[:2].any()) for c in counters)


# --------------------------------------------------------------------------
# B1's ring bodies (TMA and wgmma): contract.cu's bf16 ring and
# contract_q8.cu's 8-bit ring
# --------------------------------------------------------------------------


def _bf16_view(rows, cols, gen, device, transposed):
    """A (rows, cols) bf16 operand whose rows are padded to a multiple of 8
    plus 8 elements; ``transposed``: stored (cols, rows), the view its
    transpose (unit stride along rows)."""
    pad = lambda v: (v + 7) // 8 * 8 + 8  # noqa: E731
    if transposed:
        return torch.randn(cols, pad(rows), generator=gen, device=device
                           ).bfloat16()[:, :rows].t()
    return torch.randn(rows, pad(cols), generator=gen, device=device
                       ).bfloat16()[:, :cols]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b_kmajor", [False, True], ids=["B_nmajor",
                                                         "B_kmajor"])
@pytest.mark.parametrize("a_mmajor", [False, True], ids=["A_kmajor",
                                                         "A_mmajor"])
@pytest.mark.parametrize("m,k,n", [(200, 1000, 264), (130, 776, 520),
                                   (2048, 256, 1000)])
def test_ring_body_every_layout(cuda_device, m, k, n, a_mmajor, b_kmajor,
                                out_dtype):
    """The bf16 ring in each of its four operand layouts, M, N and K off
    every tile multiple (K long enough to wrap the 6- or 4-stage ring
    several times, the last shape on 256-column tiles), bf16 and f32
    output, against the f32 product of the same operands."""
    gen = torch.Generator(device=cuda_device).manual_seed(60)
    a = _bf16_view(m, k, gen, cuda_device, a_mmajor)
    b = _bf16_view(k, n, gen, cuda_device, b_kmajor)
    got = cuda_gen.CONTRACT(a[None], b[None], out_dtype)[0]
    assert cuda_gen.CONTRACT.last_body == "ring"
    want = a.float() @ b.float()
    _assert_close_scaled(got, want, out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_ring_body_batched_strides_and_split(cuda_device, out_dtype):
    """A batch of 3 taken from a larger tensor (batch stride of its own),
    B k-major; and the split K of a few-tile shape (M = 128, N = 1024, 16
    CTAs a tile summed by the last to arrive), twice with equal bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(61)
    big = torch.randn(5, 256, 392, generator=gen, device=cuda_device
                      ).bfloat16()
    a = big[1:4, :, :384]
    bt = torch.randn(3, 320, 384, generator=gen, device=cuda_device
                     ).bfloat16()
    got = cuda_gen.CONTRACT(a, bt.transpose(1, 2), out_dtype)
    assert cuda_gen.CONTRACT.last_body == "ring"
    _assert_close_scaled(got, torch.bmm(a.float(), bt.float().transpose(1, 2)),
                         out_dtype)
    a = torch.randn(1, 128, 4096, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(1, 4096, 1024, generator=gen, device=cuda_device
                    ).bfloat16()
    first = cuda_gen.CONTRACT(a, b, out_dtype)
    assert cuda_gen.CONTRACT.last_plan.splits == 16
    again = cuda_gen.CONTRACT(a, b, out_dtype)
    assert torch.equal(first, again)
    _assert_close_scaled(first, torch.bmm(a.float(), b.float()), out_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(256, 512, 384), (200, 12288, 136),
                                   (2048, 1024, 4096)])
def test_8bit_ring_matches_plain_version(cuda_device, m, k, n, fmt):
    """The 8-bit ring, W k-major as ``ops.dense(quant=)`` writes it: int8
    exactly, fp8 within the f32 TOL (scaled), K = 12288 included."""
    gen = torch.Generator(device=cuda_device).manual_seed(62)
    a = _q_operand((m, k), fmt, gen, cuda_device)
    wt = _q_operand((n, k), fmt, gen, cuda_device)
    spec = PE.quantize_spec(PE.matmul_spec(m, k, n), fmt=fmt)
    out_dtype = torch.int32 if fmt == "int8" else torch.float32
    got = _launcher_of(fmt)(a[None], wt.t()[None], out_dtype,
                            int_acc=fmt == "int8")[0]
    assert _launcher_of(fmt).last_body == "ring"
    want = cuda_gen.contract_ref(spec, a, wt.t(), out_dtype=out_dtype)
    _assert_quant_close(got, want, fmt)


@pytest.mark.gpu
def test_rings_give_equal_bits_twice(cuda_device):
    """Two launches of each ring on the same inputs give the same bits: a
    train shape (M = 2048, K = N = 4096, bf16) and an 8-bit MLP product
    (M = 2048, K = 4096, N = 12288) in int8 and fp8."""
    gen = torch.Generator(device=cuda_device).manual_seed(63)
    a = torch.randn(1, 2048, 4096, generator=gen, device=cuda_device
                    ).bfloat16()
    b = torch.randn(1, 4096, 4096, generator=gen, device=cuda_device
                    ).bfloat16()
    first = cuda_gen.CONTRACT(a, b, torch.bfloat16)
    assert cuda_gen.CONTRACT.last_body == "ring"
    assert torch.equal(first, cuda_gen.CONTRACT(a, b, torch.bfloat16))
    for fmt in ("int8", "fp8"):
        a = _q_operand((2048, 4096), fmt, gen, cuda_device)
        wt = _q_operand((12288, 4096), fmt, gen, cuda_device)
        out_dtype = torch.int32 if fmt == "int8" else torch.float32
        run = lambda: _launcher_of(fmt)(  # noqa: E731
            a[None], wt.t()[None], out_dtype, int_acc=fmt == "int8")
        first = run()
        assert _launcher_of(fmt).last_body == "ring"
        assert torch.equal(first, run())


@pytest.mark.gpu
def test_forced_ring_refuses_what_it_cannot_take(cuda_device):
    """A ring forced on a layout TMA cannot read (rows of 130 bf16 or 999
    bytes, an n-major 8-bit B, M < 64) or on the k-scale mode with an
    m-major A is refused by the kernel's launch and the wrapper raises;
    nothing switches body."""
    gen = torch.Generator(device=cuda_device).manual_seed(64)
    a = torch.randn(1, 128, 130, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(1, 130, 64, generator=gen, device=cuda_device).bfloat16()
    before = cuda_gen.CONTRACT.launches
    with pytest.raises(RuntimeError, match="ring body"):
        cuda_gen.CONTRACT(a, b, torch.bfloat16, body="ring")
    a = torch.randn(1, 32, 64, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(1, 64, 64, generator=gen, device=cuda_device).bfloat16()
    with pytest.raises(RuntimeError, match="ring body"):
        cuda_gen.CONTRACT(a, b, torch.bfloat16, body="ring")
    # the fused ring's k-scale pass rewrites K-major A tiles only
    a = torch.randn(1, 64, 128, generator=gen, device=cuda_device
                    ).bfloat16().transpose(1, 2)
    with pytest.raises(RuntimeError, match="ring body"):
        cuda_gen.CONTRACT(a, b, torch.bfloat16, body="ring",
                          kscale=modes.VecArg(torch.ones(64,
                                                         device=cuda_device),
                                              3))
    assert cuda_gen.CONTRACT.launches == before
    for fmt in ("int8", "fp8"):
        launcher = _launcher_of(fmt)
        out_dtype = torch.int32 if fmt == "int8" else torch.float32
        before = launcher.launches
        a = _q_operand((128, 256), fmt, gen, cuda_device)
        with pytest.raises(RuntimeError, match="q8_launch"):
            launcher(a[None], _q_operand((256, 128), fmt, gen,
                                         cuda_device)[None],
                     out_dtype, int_acc=fmt == "int8", body="ring")
        a = _q_operand((128, 999), fmt, gen, cuda_device)
        with pytest.raises(RuntimeError, match="q8_launch"):
            launcher(a[None], _q_operand((128, 999), fmt, gen,
                                         cuda_device).t()[None],
                     out_dtype, int_acc=fmt == "int8", body="ring")
        assert launcher.launches == before


# --------------------------------------------------------------------------
# contract.cu's fused ring and narrow body
# --------------------------------------------------------------------------


def _fused_case(mode, m, n, k, gen, device):
    """(launcher keywords, the f32 reference's tail) of one fused mode on a
    (m, k) @ (k, n) product: the epilogue (gelu with norm; relu with scale
    and bias), the k-scale prologue, a multiplier along n or m, and the
    row reduce with its T."""
    VA = modes.VecArg
    vec = lambda length: torch.randn(length, generator=gen,  # noqa: E731
                                     device=device)
    if mode.startswith("epilogue"):
        norm = mode.endswith("norm")
        epi = codegen.Epilogue(act="gelu" if norm else "relu", bias=True,
                               scale=not norm, norm=norm)
        vs = {"scale": vec(n), "bias": vec(n), "mean": vec(n) * 0.1,
              "var": torch.rand(n, generator=gen, device=device) + 0.5}
        vs = {name: vs[name] for name in epi.vector_names}
        return ({"epilogue": epi,
                 "vectors": {k_: VA(v, 2) for k_, v in vs.items()}},
                lambda acc: epi.apply(acc, {k_: v[None] for k_, v in
                                            vs.items()}))
    if mode == "kscale":
        g = vec(k).bfloat16()
        return {"kscale": VA(g, 3)}, g
    if mode in ("mul_n", "mul_m"):
        g = vec(n if mode == "mul_n" else m).bfloat16()
        shape = (1, n) if mode == "mul_n" else (m, 1)
        return ({"mul": VA(g, 2 if mode == "mul_n" else 1)},
                lambda acc: acc * g.float().reshape(shape))
    t = torch.randn(m, n, generator=gen, device=device).bfloat16()
    return {"t": t}, lambda acc: (acc * t.float()).sum(0)


def _fused_reference(mode, a, b, tail):
    if mode == "kscale":  # A scaled in f32, rounded once to bf16
        a = (a.float() * tail.float()[None]).bfloat16()
        return a.float() @ b.float()
    return tail(a.float() @ b.float())


FUSED_MODES = ("epilogue_norm", "epilogue_scale", "kscale", "mul_n", "mul_m",
               "row_reduce")


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b_kmajor", [False, True], ids=["B_nmajor",
                                                         "B_kmajor"])
@pytest.mark.parametrize("a_mmajor", [False, True], ids=["A_kmajor",
                                                         "A_mmajor"])
@pytest.mark.parametrize("mode", FUSED_MODES)
def test_fused_ring_every_mode_and_layout(cuda_device, mode, a_mmajor,
                                          b_kmajor, out_dtype):
    """Every fused mode on the ring in the four operand layouts (M, N and K
    off the tile multiples), bf16 and f32 output, against the f32
    product with the same tail; the k-scale mode with an m-major A keeps
    the mma.sync body (its pass rewrites K-major tiles only)."""
    gen = torch.Generator(device=cuda_device).manual_seed(70)
    m, k, n = 200, 1000, 264
    a = _bf16_view(m, k, gen, cuda_device, a_mmajor)
    b = _bf16_view(k, n, gen, cuda_device, b_kmajor)
    kw, tail = _fused_case(mode, m, n, k, gen, cuda_device)
    got = cuda_gen.CONTRACT(a[None], b[None], out_dtype, **kw)
    want = _fused_reference(mode, a, b, tail)
    assert cuda_gen.CONTRACT.last_body == (
        "mma" if mode == "kscale" and a_mmajor else "ring")
    _assert_close_scaled(got.reshape(want.shape), want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["epilogue_norm", "mul_m", "kscale"])
def test_fused_ring_split_k(cuda_device, mode):
    """A few-tile shape (M = 128, N = 1024) splits K over 16 CTAs; the last
    to arrive sums the partials, then applies the epilogue (a non-linear
    activation needs the whole sum): within the TOL, and equal bits on
    two launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(71)
    m, k, n = 128, 4096, 1024
    a = torch.randn(m, k, generator=gen, device=cuda_device).bfloat16()
    b = torch.randn(k, n, generator=gen, device=cuda_device).bfloat16()
    kw, tail = _fused_case(mode, m, n, k, gen, cuda_device)
    first = cuda_gen.CONTRACT(a[None], b[None], torch.bfloat16, **kw)
    assert cuda_gen.CONTRACT.last_body == "ring"
    assert cuda_gen.CONTRACT.last_plan.splits > 1
    assert torch.equal(first, cuda_gen.CONTRACT(a[None], b[None],
                                                torch.bfloat16, **kw))
    _assert_close_scaled(first[0], _fused_reference(mode, a, b, tail),
                         torch.bfloat16)


@pytest.mark.gpu
def test_fused_ring_row_reduce_gives_equal_bits(cuda_device):
    """``weighted_matmul.dg`` on the ring, compiled and called as the
    backward does at a mid size: two launches equal bit for bit (no float
    atomics), within the TOL of ``contract_ref``."""
    from repro_torch.grad import derived_specs

    gen = torch.Generator(device=cuda_device).manual_seed(72)
    spec = derived_specs(PE.weighted_matmul_spec(512, 1024, 1536))["g"]
    args = [torch.randn([spec.extents[i] for i in ax], generator=gen,
                        device=cuda_device).bfloat16()
            for ax in spec.operands.values()]
    kern = codegen.compile(spec, codegen.default_schedule(spec))
    first = kern(*args)
    assert cuda_gen.CONTRACT.last_body == "ring"
    assert torch.equal(first, kern(*args))
    want = cuda_gen.contract_ref(spec, *args, out_dtype=torch.bfloat16)
    _assert_close_scaled(first, want, torch.bfloat16)


#: qwen3-8b's decode GEMMs (K, N): q/o, k/v, gate/up, down
DECODE_GEMMS = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 8, 16, 33, 63])
def test_narrow_body_at_the_decode_gemms(cuda_device, m):
    """The narrow body (C^T = W^T x^T) at M tokens over a qwen3-8b layer's
    GEMMs, W n-major as the model holds it and k-major (W^T's storage):
    within the bf16 TOL of the f32 product, equal bits on two launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(73)
    for k, n in DECODE_GEMMS:
        x = torch.randn(1, m, k, generator=gen, device=cuda_device).bfloat16()
        w = torch.randn(1, k, n, generator=gen, device=cuda_device).bfloat16()
        for wv in (w, w.transpose(1, 2).contiguous().transpose(1, 2)):
            got = cuda_gen.CONTRACT(x, wv, torch.bfloat16)
            assert cuda_gen.CONTRACT.last_body == "narrow"
            assert torch.equal(got, cuda_gen.CONTRACT(x, wv, torch.bfloat16))
            _assert_close_scaled(got, x.float() @ w.float(), torch.bfloat16)


@pytest.mark.gpu
def test_narrow_body_batched_f32_out_and_forced_refusals(cuda_device):
    """A batch of 3 decode products (f32 output); a forced narrow body it
    cannot take -- M = 100 tokens, an m-contiguous x, a fused mode -- is
    refused by the kernel's launch and the wrapper raises."""
    gen = torch.Generator(device=cuda_device).manual_seed(74)
    x = torch.randn(3, 5, 512, generator=gen, device=cuda_device).bfloat16()
    w = torch.randn(3, 512, 640, generator=gen, device=cuda_device).bfloat16()
    got = cuda_gen.CONTRACT(x, w, torch.float32)
    assert cuda_gen.CONTRACT.last_body == "narrow"
    _assert_close_scaled(got, torch.bmm(x.float(), w.float()),
                         torch.bfloat16)
    before = cuda_gen.CONTRACT.launches
    big = torch.randn(1, 100, 512, generator=gen, device=cuda_device
                      ).bfloat16()
    with pytest.raises(RuntimeError, match="narrow body"):
        cuda_gen.CONTRACT(big, w[:1], torch.bfloat16, body="narrow")
    xt = torch.randn(1, 512, 8, generator=gen, device=cuda_device
                     ).bfloat16().transpose(1, 2)
    with pytest.raises(RuntimeError, match="narrow body"):
        cuda_gen.CONTRACT(xt, w[:1], torch.bfloat16, body="narrow")
    with pytest.raises(RuntimeError, match="narrow body"):
        cuda_gen.CONTRACT(x[:1], w[:1], torch.bfloat16, body="narrow",
                          mul=modes.VecArg(torch.ones(640,
                                                      device=cuda_device), 2))
    assert cuda_gen.CONTRACT.launches == before


@pytest.mark.gpu
def test_decode_layer_launches_only_the_contract_kernel(cuda_device,
                                                        tmp_path):
    """A decode step's GEMMs of one qwen3-8b layer through ``ops.dense``
    (4 tokens; q, k, v, o, gate, up, down) under ``torch.profiler``: one
    contract launch each, and no other device work -- no counter fill, no
    operand copy."""
    import json

    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda_device).manual_seed(75)
    xs = {k: torch.randn(4, k, generator=gen, device=cuda_device).bfloat16()
          for k in (4096, 12288)}
    ws = [torch.randn(k, n, generator=gen, device=cuda_device).bfloat16()
          for k, n in ((4096, 4096), (4096, 1024), (4096, 1024),
                       (4096, 4096), (4096, 12288), (4096, 12288),
                       (12288, 4096))]

    def layer():
        for w in ws:
            ops.dense(xs[w.shape[0]], w)

    layer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        layer()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in (
                  "kernel", "gpu_memcpy", "gpu_memset")]
    ours = [e for e in events if "contract_bf16_narrow_kernel" in e]
    assert len(ours) == len(ws) and len(events) == len(ws), events


# --------------------------------------------------------------------------
# B1's tc32 body (f32 in 3xTF32 on wgmma) and B4's ring body
# --------------------------------------------------------------------------


def _f32_operands(device, batch, m, k, n, w_layout, seed):
    """(a (batch, m, k) k-contiguous or, where ``w_layout`` starts with
    ``xm-``, an m-contiguous view (``matmul.dB``'s x^T); b (batch, k, n)
    n-contiguous or, for ``w_layout`` ``"k"`` / ``"xm-k"``, a k-contiguous
    view), f32, scaled by 1/8."""
    g = torch.Generator(device=device).manual_seed(seed)
    if w_layout.startswith("xm-"):
        w_layout = w_layout[3:]
        a = (torch.randn(batch, k, m, generator=g, device=device)
             / 8).transpose(1, 2)
    else:
        a = torch.randn(batch, m, k, generator=g, device=device) / 8
    if w_layout == "n":
        b = torch.randn(batch, k, n, generator=g, device=device) / 8
    else:
        b = (torch.randn(batch, n, k, generator=g, device=device) /
             8).transpose(1, 2)
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["f32_out", "bf16_out"])
@pytest.mark.parametrize("batch,m,k,n,w_layout", [
    (1, 256, 4096, 384, "n"),   # a long K: the stage sums hold the TOL
    (1, 100, 100, 136, "n"),    # ragged M, N, K (K a multiple of 4)
    (3, 70, 64, 200, "n"),      # batched
    (2, 129, 96, 72, "k"),      # W k-contiguous (matmul.dA's W^T)
    (1, 4, 512, 1024, "k"),     # decode's M
    (1, 1, 8, 1, "n"),          # one output
    (1, 128, 4096, 512, "n"),   # 4 tiles: K split 16 ways
    (2, 64, 1024, 256, "k"),    # batched, K split 4 ways
    # x m-contiguous (matmul.dB's x^T), transposed as it is split
    (1, 100, 100, 136, "xm-n"),  # ragged M, N, K
    (3, 68, 64, 200, "xm-n"),    # batched
    (2, 132, 96, 72, "xm-k"),    # W k-contiguous
    (1, 128, 4096, 512, "xm-n"),  # K split 16 ways
    (2, 64, 1024, 256, "xm-k"),  # batched, K split 4 ways
    (1, 256, 4, 384, "xm-n"),    # K = 4: decode's matmul.dB
    # the narrow x tile (M < 64, x k-contiguous): widths 8, 16, 32, 64
    (1, 1, 512, 1024, "n"),
    (1, 4, 4096, 4096, "k"),
    (1, 8, 1024, 1000, "n"),
    (2, 17, 768, 640, "k"),
    (1, 63, 2048, 384, "n"),
    # more tiles than SMs: one CTA an SM walks its tiles in turn
    (1, 2048, 64, 2048, "n"),
    (2, 2048, 4, 1536, "xm-n"),
    (1, 4, 256, 32768, "n"),
])
def test_tc32_body_matches_plain_version(cuda_device, batch, m, k, n,
                                         w_layout, out):
    """Aligned f32 operands take the tc32 body, one launch, at ragged
    shapes, batched, with x k- or m-contiguous and W n- or k-contiguous,
    K split where the grid is short, the narrow x tile at M < 64, more
    tiles than SMs (each CTA walking several), and f32 or bf16 output,
    within the f32 TOL of the f64 product (bf16 output: its own TOL); a
    second launch gives the same bits."""
    a, b = _f32_operands(cuda_device, batch, m, k, n, w_layout, m + k + n)
    assert cuda_gen.contract_body(a, b) == "tc32"
    before = cuda_gen.CONTRACT.launches
    got = cuda_gen.CONTRACT(a, b, out)
    assert cuda_gen.CONTRACT.launches == before + 1
    assert cuda_gen.CONTRACT.last_body == "tc32"
    want = (a.double() @ b.double()).to(out)
    torch.cuda.synchronize()
    _assert_close_scaled(got, want, out)
    assert cuda_gen.CONTRACT.last_plan == cuda_gen.tc32_tiles(
        batch, m, n, k, torch.cuda.get_device_properties(
            cuda_device).multi_processor_count,
        narrow_x=not w_layout.startswith("xm-"))
    assert torch.equal(cuda_gen.CONTRACT(a, b, out), got)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 256])
def test_tc32_weighted_db_matches_plain_version(cuda_device, m):
    """The f32 weighted ``.dB`` (x^T m-contiguous, the multiplier g on the
    product's m) runs the tc32 body, one launch, within the f32 TOL of its
    plain version, at decode's 4 tokens (K = 4) and at 256."""
    from repro_torch.grad import derived_specs

    spec = derived_specs(PE.weighted_matmul_spec(m, 256, 384))["B"]
    g = torch.Generator(device=cuda_device).manual_seed(37)
    dout = torch.randn(m, 384, generator=g, device=cuda_device)
    x = torch.randn(m, 256, generator=g, device=cuda_device)
    gv = torch.randn(256, generator=g, device=cuda_device)
    before = cuda_gen.CONTRACT.launches
    got = cuda_gen._launch_cuda(spec, dout, x, gv, out_dtype=torch.float32)
    assert cuda_gen.CONTRACT.launches == before + 1
    assert cuda_gen.CONTRACT.last_body == "tc32"
    want = cuda_gen.contract_ref(spec, dout, x, gv, out_dtype=torch.float32)
    torch.cuda.synchronize()
    _assert_close_scaled(got, want, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [1, 2], ids=["mul_m", "mul_n"])
def test_tc32_body_epilogue_and_multiplier(cuda_device, axis):
    """The tc32 body's fused modes through the launcher: a multiplier on
    m or n with the whole epilogue (scale, bias, norm, gelu), against
    ``Epilogue.apply`` on the f64 product."""
    from repro_torch.codegen.modes import VecArg

    a, b = _f32_operands(cuda_device, 1, 192, 256, 320, "n", 31)
    g = torch.Generator(device=cuda_device).manual_seed(32)
    mul = torch.randn(a.shape[1] if axis == 1 else b.shape[2], generator=g,
                      device=cuda_device)
    epi = codegen.Epilogue(act="gelu", scale=True, bias=True, norm=True)
    vecs = _vectors(cuda_device, 320, 33)
    got = cuda_gen.CONTRACT(
        a, b, torch.float32, mul=VecArg(mul, axis),
        epilogue=epi, vectors={k: VecArg(v, 2) for k, v in vecs.items()})
    assert cuda_gen.CONTRACT.last_body == "tc32"
    acc = a.double() @ b.double()
    acc = acc * (mul[None, :, None] if axis == 1 else mul[None, None, :])
    want = epi.apply(acc.float(), vecs)
    torch.cuda.synchronize()
    _assert_close_scaled(got, want, torch.float32)


@pytest.mark.gpu
def test_tc32_body_forced_and_refused(cuda_device):
    """A forced mma.sync body on f32 raises before any launch; a forced
    tc32 body the kernel cannot take (bf16 operands, an unaligned row, the
    k-scale prologue) is refused by the kernel and raises; the tc32 and
    FMA bodies agree; unaligned and element-strided f32 runs the FMA
    body."""
    from repro_torch.codegen.modes import VecArg

    a, b = _f32_operands(cuda_device, 1, 128, 256, 192, "n", 34)
    tc = cuda_gen.CONTRACT(a, b, torch.float32)
    fma = cuda_gen.CONTRACT(a, b, torch.float32, body="fma")
    assert cuda_gen.CONTRACT.last_body == "fma"
    torch.testing.assert_close(tc, fma, rtol=1e-4, atol=1e-4)
    before = cuda_gen.CONTRACT.launches
    with pytest.raises(ValueError, match="does not take torch.float32"):
        cuda_gen.CONTRACT(a, b, torch.float32, body="mma")
    with pytest.raises(RuntimeError, match="tc32 body"):
        cuda_gen.CONTRACT(a.bfloat16(), b.bfloat16(), torch.float32,
                          body="tc32")
    odd = torch.randn(1, 64, 37, device=cuda_device)
    with pytest.raises(RuntimeError, match="tc32 body"):
        cuda_gen.CONTRACT(odd, torch.randn(1, 37, 64, device=cuda_device),
                          torch.float32, body="tc32")
    ks = VecArg(torch.randn(256, device=cuda_device), 3)
    with pytest.raises(RuntimeError, match="tc32 body"):
        cuda_gen.CONTRACT(a, b, torch.float32, kscale=ks, body="tc32")
    assert cuda_gen.CONTRACT.launches == before
    strided = torch.randn(1, 128, 512, device=cuda_device)[:, :, ::2]
    got = cuda_gen.CONTRACT(strided, b, torch.float32)
    assert cuda_gen.CONTRACT.last_body == "fma"
    _assert_close_scaled(got, strided.double() @ b.double(), torch.float32)


@pytest.mark.gpu
def test_tc32_body_equal_bits_on_two_streams(cuda_device):
    """Two launches give equal bits, also on two streams at once (the body
    keeps no state between launches)."""
    a, b = _f32_operands(cuda_device, 1, 512, 1024, 768, "n", 35)
    c, d = _f32_operands(cuda_device, 2, 130, 256, 256, "k", 36)
    want = (cuda_gen.CONTRACT(a, b, torch.float32),
            cuda_gen.CONTRACT(c, d, torch.bfloat16))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    got = []
    for _ in range(3):
        with torch.cuda.stream(streams[0]):
            x = cuda_gen.CONTRACT(a, b, torch.float32)
        with torch.cuda.stream(streams[1]):
            y = cuda_gen.CONTRACT(c, d, torch.bfloat16)
        got.append((x, y))
    torch.cuda.synchronize()
    for x, y in got:
        assert torch.equal(x, want[0]) and torch.equal(y, want[1])


def _dw_table(sizes, device):
    return torch.tensor(
        [(i, o, s) for i, (o, s) in
         enumerate(zip(fused_gen._group_offsets(sizes), sizes))],
        dtype=torch.int32, device=device).reshape(-1, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32],
                         ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("sizes,k1,k2", [
    ((0, 1, 63, 64, 65, 320), 256, 512),   # the step's edges; the last
    ((320,) * 4, 7168 // 8, 2048 // 8),    # group ends at the tensor's end
    ((0, 1, 63, 64, 65, 320, 0), 136, 264),  # ragged K1, K2; empty last
    ((28,) * 48, 128, 256),                # kimi-k2's C, one step a group
    ((700,), 8, 8),                        # one group of 11 steps
])
def test_grouped_dw_ring_matches_plain_version(cuda_device, sizes, k1, k2,
                                               out):
    """bf16 operands TMA reads take B4's ring, one launch: groups of 0, 1,
    63, 64, 65 and 320 rows (the last K step's next-group rows zeroed),
    ragged K1 and K2, bf16 and f32 output; empty groups exact zeros."""
    g = torch.Generator(device=cuda_device).manual_seed(k1 + 7 * k2)
    n = sum(sizes)
    x = torch.randn(n, k1, generator=g, device=cuda_device).bfloat16()
    d = torch.randn(n, k2, generator=g, device=cuda_device).bfloat16()
    assert fused_gen.grouped_dw_body(x, d) == "ring"
    before = fused_gen.GROUPED_DW.launches
    got = fused_gen.GROUPED_DW(x, d, _dw_table(sizes, cuda_device), out)
    assert fused_gen.GROUPED_DW.launches == before + 1
    assert fused_gen.GROUPED_DW.last_body == "ring"
    want = fused_gen.grouped_dw_ref(x, d, sizes, out_dtype=out)
    torch.cuda.synchronize()
    _assert_close_scaled(got, want, out)
    for gi, size in enumerate(sizes):
        if not size:
            assert bool((got[gi] == 0).all()), gi


@pytest.mark.gpu
def test_grouped_dw_ring_forced_and_refused(cuda_device):
    """A forced ring on operands it cannot read, or a body of the other
    dtype, raises before any launch; the ring and the mma.sync body
    agree; a row stride TMA cannot read runs mma.sync by default."""
    sizes = (5, 0, 130, 64)
    table = _dw_table(sizes, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(37)
    x = torch.randn(199, 128, generator=g, device=cuda_device).bfloat16()
    d = torch.randn(199, 264, generator=g, device=cuda_device).bfloat16()
    ring = fused_gen.GROUPED_DW(x, d, table, torch.float32)
    mma = fused_gen.GROUPED_DW(x, d, table, torch.float32, body="mma")
    assert fused_gen.GROUPED_DW.last_body == "mma"
    torch.testing.assert_close(ring, mma, rtol=1e-5, atol=1e-5)
    before = fused_gen.GROUPED_DW.launches
    wide = torch.randn(199, 132, generator=g, device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match="ring body cannot take"):
        fused_gen.GROUPED_DW(wide[:, :130], d, table, torch.float32,
                             body="ring")
    with pytest.raises(ValueError, match="ring body cannot take"):
        fused_gen.GROUPED_DW(x.float(), d.float(), table, torch.float32,
                             body="ring")
    with pytest.raises(ValueError, match="fma body does not take"):
        fused_gen.GROUPED_DW(x, d, table, torch.float32, body="fma")
    assert fused_gen.GROUPED_DW.launches == before
    # rows of 132 elements (264 bytes): not 16-byte multiples
    got = fused_gen.GROUPED_DW(wide[:, :128], d, table, torch.float32)
    assert fused_gen.GROUPED_DW.last_body == "mma"
    _assert_close_scaled(got, fused_gen.grouped_dw_ref(
        wide[:, :128], d, sizes, out_dtype=torch.float32), torch.float32)


@pytest.mark.gpu
def test_grouped_dw_ring_equal_bits_on_two_streams(cuda_device):
    """B4's ring on two streams at once gives the bits each call gives
    alone (no tile counter: the walk is static)."""
    sizes = (320,) * 8
    table = _dw_table(sizes, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(38)
    x = torch.randn(2560, 1024, generator=g, device=cuda_device).bfloat16()
    d = torch.randn(2560, 512, generator=g, device=cuda_device).bfloat16()
    want = fused_gen.GROUPED_DW(x, d, table, torch.bfloat16)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    got = []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                got.append(fused_gen.GROUPED_DW(x, d, table, torch.bfloat16))
    torch.cuda.synchronize()
    for y in got:
        assert torch.equal(y, want)


@pytest.mark.gpu
def test_ring_bodies_launch_from_a_fresh_thread(cuda_device):
    """A host thread whose first CUDA work is a ring launch (the autograd
    engine's thread, when a backward begins with one) has no current
    context, and encoding a TMA map needs one: each ring body -- B1's
    bf16 ring and tc32, B4's ring, B5's ring -- binds the operands'
    device first and launches."""
    import threading

    from repro_torch.kernels import _baselines

    g = torch.Generator(device=cuda_device).manual_seed(39)
    a = torch.randn(1, 128, 384, generator=g, device=cuda_device)
    b = torch.randn(1, 384, 256, generator=g, device=cuda_device)
    sizes = (100, 0, 28)
    x = torch.randn(128, 256, generator=g, device=cuda_device).bfloat16()
    d = torch.randn(128, 512, generator=g, device=cuda_device).bfloat16()
    table = _dw_table(sizes, cuda_device)
    calls = {
        "tc32": lambda: cuda_gen.CONTRACT(a, b, torch.float32),
        "ring": lambda: cuda_gen.CONTRACT(a.bfloat16(), b.bfloat16(),
                                          torch.float32),
        "dw ring": lambda: fused_gen.GROUPED_DW(x, d, table, torch.float32),
        "matmul ring": lambda: _baselines.MATMUL(a[0].bfloat16(),
                                                 b[0].bfloat16(),
                                                 torch.float32),
    }
    want = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    got, errors = {}, {}

    def run(name, fn):
        try:
            got[name] = fn()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors[name] = e

    for name, fn in calls.items():
        t = threading.Thread(target=run, args=(name, fn))
        t.start()
        t.join()
    assert not errors, errors
    for name in calls:
        assert torch.equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# the HoF formalism on the card: the lowered and executed variants and the
# variant tuner, each against the same computation on the CPU
# ---------------------------------------------------------------------------


def _f64_operands(spec, seed):
    g = torch.Generator().manual_seed(seed)
    root = spec.root()
    return {n: torch.randn(tuple(root.extents[i] for i in ax), generator=g,
                           dtype=torch.float64)
            for n, ax in root.operands.items()}


HOF_SPECS = {
    "table1": lambda: PE.matmul_spec(48, 32, 40),
    "table2": lambda: PE.matmul_spec(48, 32, 40).subdivide("j", 8),
    "weighted": lambda: PE.weighted_matmul_spec(24, 16, 32),
    "chain": lambda: PE.chain_matmul_spec(8, 12, 6, 10),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(HOF_SPECS))
def test_hof_variants_on_the_card_match_the_cpu(cuda_device, case):
    from repro_torch.core.execute import execute_variant
    from repro_torch.core.lower import contraction_to_torch

    spec = HOF_SPECS[case]()
    cpu = _f64_operands(spec, 3)
    card = {n: t.to(cuda_device) for n, t in cpu.items()}
    names = list(spec.root().operands)
    for order in PE.variant_orders(spec)[:8]:
        for run in (
            lambda a: execute_variant(spec, order, a),
            lambda a: contraction_to_torch(spec, order)(*(a[n] for n in names)),
        ):
            want = run(cpu)
            got = run(card)
            assert got.device.type == "cuda"
            torch.testing.assert_close(got.cpu(), want, rtol=1e-10,
                                       atol=1e-10)


@pytest.mark.gpu
def test_tune_measures_on_the_card(cuda_device, tmp_path):
    from repro_torch.core.autotune import tune
    from repro_torch.core.execute import execute_variant

    spec = PE.matmul_spec(64, 64, 64)
    cpu = _f64_operands(spec, 5)
    card = {n: t.to(cuda_device) for n, t in cpu.items()}
    cache = codegen.AutotuneCache(str(tmp_path / "tune.json"))
    kw = dict(subdiv_candidates={"j": [16]}, keep=3, repeats=1, cache=cache)
    tuned = tune(spec, measure_with=card, **kw)
    on_cpu = tune(spec, measure_with=cpu, **{**kw, "cache": None})
    assert all(tv.measured_s is not None for tv in tuned)
    # the same survivors, measured on each device
    assert sorted((tv.order, tv.spec.split_chain()) for tv in tuned) == sorted(
        (tv.order, tv.spec.split_chain()) for tv in on_cpu)
    win = tuned[0]
    torch.testing.assert_close(
        execute_variant(win.spec, win.order, card).cpu(),
        cpu["A"] @ cpu["B"], rtol=1e-10, atol=1e-10)
    again = tune(spec, measure_with=card, **kw)
    assert cache.hits == 1
    assert [(tv.order, tv.measured_s) for tv in again] == [
        (tv.order, tv.measured_s) for tv in tuned]


#: (M, K, N, dtype): a ring shape, decode's narrow body, a narrow M of 40,
#: a ragged ring shape, and tc32 (and its narrow x tile at M = 4)
CARD_SHAPES = [(256, 1024, 512, torch.bfloat16),
               (4, 2048, 1024, torch.bfloat16),
               (40, 512, 640, torch.bfloat16),
               (200, 1000, 136, torch.bfloat16),
               (128, 1024, 384, torch.float32),
               (4, 2048, 1024, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,dtype", CARD_SHAPES,
                         ids=[f"{m}x{k}x{n}-{str(d)[6:]}"
                              for m, k, n, d in CARD_SHAPES])
def test_every_card_candidate_matches_the_plain_version(cuda_device, m, k,
                                                        n, dtype):
    """Every tile plan the search may measure, on the body it names: one
    launch each, ``CONTRACT.last_card`` the requested plan, the output
    the plain version's -- the forward and ``matmul.dB``'s transposed
    views (the ring reads an m-major x^T)."""
    from repro_torch.grad import derived_specs
    from repro_torch.search import card_candidates

    spec = PE.matmul_spec(m, k, n)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(k, n, generator=gen, device=cuda_device).to(dtype)
    g = torch.randn(m, n, generator=gen, device=cuda_device).to(dtype)
    cases = [(spec, (x, w))]
    if m >= 64:
        cases.append((derived_specs(spec)["B"], (g, x)))
    for s, args in cases:
        a3, b3 = cuda_gen.card_views(s, *args)
        plans = card_candidates(s, a3, b3)
        body = cuda_gen.contract_body(a3, b3)
        # f32's matmul.dB reads an m-major x^T: tc32, transposed as split
        assert bool(plans) == (body in cuda_gen.PLAN_BODIES), (s.name, body)
        want = cuda_gen.contract_ref(s, *args, out_dtype=dtype)
        sched = codegen.default_schedule(s)
        for plan in plans or [None]:
            kern = codegen.cached_compile(s, sched, card=plan)
            n0 = cuda_gen.CONTRACT.launches
            got = kern(*args)
            torch.cuda.synchronize()
            assert cuda_gen.CONTRACT.launches == n0 + 1
            assert cuda_gen.CONTRACT.last_card == (
                plan or cuda_gen.CardPlan(body, 0, 1)), (s.name, plan)
            _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
def test_refused_card_plan_raises(cuda_device):
    spec = PE.matmul_spec(256, 512, 512)
    x = torch.randn(256, 512, device=cuda_device, dtype=torch.bfloat16)
    w = torch.randn(512, 512, device=cuda_device, dtype=torch.bfloat16)
    sched = codegen.default_schedule(spec)
    for plan in (cuda_gen.CardPlan("ring", 64, 1),    # no such tile
                 cuda_gen.CardPlan("ring", 128, 9)):  # 8 K steps, 9 splits
        with pytest.raises(RuntimeError, match="launch failed"):
            codegen.cached_compile(spec, sched, card=plan)(x, w)
    # the launch after a refused one runs
    out = codegen.cached_compile(spec, sched)(x, w)
    _assert_close_scaled(out, x.float() @ w.float(), torch.bfloat16)


@pytest.mark.gpu
def test_card_search_serves_its_winner(cuda_device, tmp_path):
    """A card ladder: distinct plans, the heuristic's among them, the
    winner no slower than it; ``ops.dense`` then launches the winner's
    plan (``ops.card_plan.applied``)."""
    from repro_torch import obs, search

    db = search.default_plan_db()
    spec = PE.matmul_spec(512, 1024, 768)
    res = search.search_schedule(spec, dtype=torch.bfloat16, topk=3,
                                 plan_db=db, device="cuda")
    cards = [p.card for p in res.ranked]
    assert None not in cards and len(set(cards)) == len(cards)
    base = res.baseline()
    assert base is not None and base.card == cuda_gen.heuristic_plan(
        "ring", 1, 512, 768, 1024, cuda_gen._sm_count(cuda_device))
    assert res.best.measured_s <= base.measured_s
    assert all(p.max_err <= 5e-2 for p in res.ranked)
    obs.metrics_reset()
    x = torch.randn(512, 1024, device=cuda_device, dtype=torch.bfloat16)
    w = torch.randn(1024, 768, device=cuda_device, dtype=torch.bfloat16)
    out = ops.dense(x, w)
    assert cuda_gen.CONTRACT.last_card == res.best.card
    assert obs.metrics_json()["counters"]["ops.card_plan.applied"] == 1
    _assert_close_scaled(out, x.float() @ w.float(), torch.bfloat16)


@pytest.mark.gpu
def test_measured_tuning_on_the_card(cuda_device, tmp_path):
    from repro_torch import search

    spec = PE.matmul_spec(256, 1024, 512)
    arrays = {"A": torch.randn(256, 1024, device=cuda_device,
                               dtype=torch.bfloat16),
              "B": torch.randn(1024, 512, device=cuda_device,
                               dtype=torch.bfloat16)}
    cache = codegen.AutotuneCache(str(tmp_path / "tune.json"))
    a = codegen.tune_schedule(spec, dtype=torch.bfloat16, cache=cache,
                              measure_with=arrays)
    b = codegen.tune_schedule(spec, dtype=torch.bfloat16, cache=cache,
                              measure_with=arrays)
    assert (cache.hits, cache.misses) == (1, 1)
    assert codegen.schedule_to_dict(a) == codegen.schedule_to_dict(b)
    import json

    (entry,) = json.load(open(cache.path)).values()
    assert entry["measured"] is True and entry["card"]["body"] == "ring"
    # the tuner deferred to the card search, whose ladder ops reads
    _, rung = search.default_plan_db().best_entry(spec, torch.bfloat16)
    assert rung["card"] == entry["card"]
    assert rung["measured_s"] == entry["measured_s"] > 0


@pytest.mark.gpu
def test_measured_tuning_on_the_card_without_a_plan(cuda_device, tmp_path):
    """A product on the mma.sync body (K = 999: x's rows are not 16-byte
    aligned for TMA) has no tile plan to search: the card search times its
    default once, and the tuner stores that time and no ``card``."""
    m, k, n = 64, 999, 136
    spec = PE.matmul_spec(m, k, n)
    arrays = {"A": torch.randn(m, k, device=cuda_device,
                               dtype=torch.bfloat16),
              "B": torch.randn(k, n, device=cuda_device,
                               dtype=torch.bfloat16)}
    assert cuda_gen.contract_body(*cuda_gen.card_views(
        spec, arrays["A"], arrays["B"])) == "mma"
    cache = codegen.AutotuneCache(str(tmp_path / "tune.json"))
    codegen.tune_schedule(spec, dtype=torch.bfloat16, cache=cache,
                          measure_with=arrays)
    import json

    (entry,) = json.load(open(cache.path)).values()
    assert entry["measured"] is True and "card" not in entry
    assert entry["measured_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("policy,want", [
    ("nothing", 28), ("dots", 21), ("dots_no_batch", 21),
])
def test_fake_cuda_train_step_product_ops(cuda_device, policy, want,
                                          monkeypatch):
    """A train step on fake CUDA tensors (``launch.steps.train_bundle``):
    every projection is one ``repro_torch::contract`` op, 7 forward, 7
    recomputed under ``nothing`` (an autograd Function saves its inputs
    after its forward, so the recompute reaches the layer's last product
    too), 14 backward; nothing is built or launched."""
    import collections
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import train_bundle

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    before = cuda_gen.CONTRACT.launches
    counts = []
    for n_layers in (2, 3):
        cfg = dataclasses.replace(get_config("qwen3-8b").smoke(),
                                  n_layers=n_layers)
        with FakeTensorMode():
            b = train_bundle(cfg, ShapeConfig("t", 16, 2, "train"))
            with Count() as c:
                b.fn(*b.in_shapes)
        counts.append(c.n["repro_torch.contract"])
    assert counts[1] - counts[0] == want
    assert cuda_gen.CONTRACT.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("policy,want", [
    ("nothing", 8), ("dots", 6), ("dots_no_batch", 6),
])
def test_remat_policy_saves_b1_launches(cuda_device, policy, want,
                                        monkeypatch):
    """A checkpointed block of two ``ops.dense`` on the card: B1 launches
    2 forward, 4 backward and, under ``nothing``, 2 recomputed; the
    gradients equal ``nothing``'s bit for bit."""
    from repro_torch.models import layers as L

    def block(x, w1, w2):
        return ops.dense(torch.tanh(ops.dense(x, w1)), w2)

    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w1, w2 = (torch.randn(256, 256, device=cuda_device, generator=gen,
                             dtype=torch.bfloat16).requires_grad_(True)
                 for _ in range(3))
    monkeypatch.setenv("REPRO_REMAT_POLICY", policy)
    before = cuda_gen.CONTRACT.launches
    out = L.remat(block)(x, w1, w2)
    grads = torch.autograd.grad(out.float().square().sum(), (x, w1, w2))
    assert cuda_gen.CONTRACT.launches - before == want
    monkeypatch.setenv("REPRO_REMAT_POLICY", "nothing")
    out0 = L.remat(block)(x, w1, w2)
    for g, g0 in zip(grads, torch.autograd.grad(out0.float().square().sum(),
                                                (x, w1, w2))):
        assert torch.equal(g, g0)


# --------------------------------------------------------------------------
# whole-model capture on the card (repro_torch.capture)
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_capture_replayed_launch_differentiates_on_the_card(cuda_device):
    """``ops.dense`` on CUDA traces to a ``repro_torch::contract`` node;
    the replay launches it through the op, whose autograd formula runs
    ``matmul.dA`` / ``.dB`` on B1: 1 + 2 launches, the gradients the
    uncaptured call's bit for bit."""
    from repro_torch import capture

    gen = torch.Generator(device="cuda").manual_seed(3)
    x, w = (torch.randn(256, 256, device=cuda_device, generator=gen)
            for _ in range(2))

    def loss(x_, w_):
        return ops.dense(x_, w_).sum()

    cf = capture.optimize(loss)
    report = cf.report_for(x, w)
    assert [(s.op, s.status) for s in report.sites] == [
        ("dense", "dispatched")]
    grads = []
    for fn in (loss, cf):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(
            True)
        before = cuda_gen.CONTRACT.launches
        fn(xr, wr).backward()
        assert cuda_gen.CONTRACT.launches - before == 3
        grads.append((xr.grad, wr.grad))
    for g, g0 in zip(grads[1], grads[0]):
        assert torch.equal(g, g0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_captured_demo_model_on_the_card(cuda_device, name):
    """The conformance trio's dense and MoE configs on CUDA: the report
    names the CPU's sites, ops and specs with ``interpret`` (a status may
    differ: the card launches unaligned products the CPU's gate refuses),
    the motif launches B2 once a layer forward and once in its remat
    recompute, and the loss and every gradient equal the CPU's at the f32
    TOL (B1's 3xTF32)."""
    from repro_torch import capture
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.api import get_api
    from repro_torch.optim.adamw import leaves, tree_map

    cfg = capture.demo_configs()[name]
    api = get_api(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (capture.DEMO_BATCH,
                                        capture.DEMO_SEQ),
                         generator=torch.Generator().manual_seed(7),
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}

    def loss(p, b):
        return api.loss(p, cfg, b)

    cpu = capture.optimize(loss, interpret=True)
    card = capture.optimize(loss)
    gparams = tree_map(lambda t: t.to(cuda_device), params)
    gbatch = {k: v.to(cuda_device) for k, v in batch.items()}
    want = [(s.op, s.spec and s.spec.name, s.spec and s.spec.extents)
            for s in cpu.report_for(params, batch).sites]
    got = [(s.op, s.spec and s.spec.name, s.spec and s.spec.extents)
           for s in card.report_for(gparams, gbatch).sites]
    assert got == want
    before = fused_gen.ATTENTION.launches
    l_card, g_card = value_and_grad(card, gparams, gbatch)
    assert fused_gen.ATTENTION.launches - before == 2 * cfg.n_layers
    l_cpu, g_cpu = value_and_grad(cpu, params, batch)
    _assert_close_scaled(l_card.cpu(), l_cpu, torch.float32)
    for (path, a), (_, b) in zip(leaves(g_card), leaves(g_cpu)):
        _assert_close_scaled(a.cpu(), b, torch.float32)


# --------------------------------------------------------------------------
# the fused kernels' card plans (B2, B3, B4): every candidate plan of
# ``search.space.fused_card_candidates`` against the plain version, the
# kernels' refusals of a plan they cannot take, and a card ladder whose
# winner the ops launch
# --------------------------------------------------------------------------


def _fused_candidates(spec, *tensors):
    from repro_torch.search.space import fused_card_candidates

    return fused_card_candidates(
        spec, *tensors, sms=cuda_gen._sm_count(tensors[0].device))


@pytest.mark.gpu
@pytest.mark.parametrize("h,s,t,d,e,causal,dtype", [
    (4, 512, 512, 128, 128, True, torch.bfloat16),   # the attn-path's (a)
    (40, 512, 512, 128, 128, True, torch.bfloat16),  # 160 tiles: every CTA
                                                     # count walks several
    (3, 300, 190, 64, 64, False, torch.bfloat16),    # ragged S and T
    (2, 130, 250, 64, 128, True, torch.bfloat16),    # e > d, S < T
    (2, 200, 130, 128, 64, True, torch.float32),     # tc32 at 32 and 64
    (2, 150, 170, 64, 128, False, torch.float32),
    (2, 140, 100, 128, 128, True, torch.float32),    # tc32 at 32 only
])
def test_attention_plans_match_plain_version(cuda_device, h, s, t, d, e,
                                             causal, dtype):
    """Each candidate plan of B2 (the ring's KV blocks of 128 and 64 at
    each CTA count, fewer CTAs than tiles at 160 tiles; the 3xTF32 body's
    KV blocks of 32, and 64 where its tiles fit) runs as asked
    (``last_plan``) and matches ``attention_ref`` at the reference's TOL,
    row by row."""
    q, k, v = _attn_operands(cuda_device, h, s, t, d, e, dtype, 31)
    spec = PE.attention_spec(h, s, t, d, e=e, causal=causal)
    plans = _fused_candidates(spec, q, k, v)
    assert len(plans) >= 2 or (dtype == torch.float32 and d == e == 128)
    if h * -(-s // 128) > cuda_gen._sm_count(cuda_device):
        assert len({p.ctas for p in plans}) == 3
    want = fused_gen.attention_ref(q, k, v, causal=causal, kv_lengths=None,
                                   out_dtype=dtype)
    for plan in plans:
        got = fused_gen.ATTENTION(q, k, v, causal, None, dtype, plan=plan)
        assert fused_gen.ATTENTION.last_plan == plan
        _assert_rows_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,k,n,contract_last", [
    ((320,) * 4, 512, 256, False),      # the training path's C
    ((320,) * 4, 512, 256, True),       # its dX orientation
    ((16,) * 24, 256, 384, False),      # the serving C
    (RAGGED, 128, 136, False),          # ragged, empty groups
    (RAGGED, 128, 136, True),
])
def test_grouped_plans_match_plain_version(cuda_device, sizes, k, n,
                                           contract_last):
    """Each M tile of B3 (16, 32, 64, 128) as a plan, through the compiled
    kernel (``compile(card=)``: the table cut at the plan's tile), against
    ``grouped_ref`` at the bf16 TOL."""
    x, w = _grouped_operands(cuda_device, sizes, k, n, torch.bfloat16,
                             contract_last, 32)
    spec = _grouped_spec(sizes, k, n, contract_last)
    want = fused_gen.grouped_ref(x, w, sizes, out_dtype=torch.bfloat16,
                                 contract_last=contract_last)
    plans = _fused_candidates(spec, x, w)
    assert sorted(p.block for p in plans) == list(fused_gen.GROUPED_TILES)
    for plan in plans:
        kern = codegen.compile(spec, codegen.default_schedule(spec),
                               card=plan)
        got = kern(x, w)
        assert fused_gen.GROUPED.last_plan == plan
        _assert_close_scaled(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,k1,k2,out", [
    ((320,) * 4, 896, 512, torch.bfloat16),
    ((0, 1, 63, 64, 65, 320), 256, 384, torch.bfloat16),
    ((28,) * 96, 512, 256, torch.float32),
])
def test_grouped_dw_plans_match_plain_version(cuda_device, sizes, k1, k2,
                                              out):
    """Each candidate plan of B4's ring (256- and 128-column tiles at each
    CTA count) against ``grouped_dw_ref``, empty groups' slabs exact
    zeros."""
    g = torch.Generator(device=cuda_device).manual_seed(33)
    x = torch.randn(sum(sizes), k1, generator=g, device=cuda_device).bfloat16()
    d = torch.randn(sum(sizes), k2, generator=g, device=cuda_device).bfloat16()
    spec = _dw_spec(sizes, k1, k2)
    want = fused_gen.grouped_dw_ref(x, d, sizes, out_dtype=out)
    plans = _fused_candidates(spec, d, x)
    assert {p.block for p in plans} == set(fused_gen.DW_RING_WIDTHS)
    table = _dw_table(sizes, cuda_device)
    for plan in plans:
        got = fused_gen.GROUPED_DW(x, d, table, out, plan=plan)
        assert fused_gen.GROUPED_DW.last_plan == plan
        _assert_close_scaled(got, want, out)
        for i, size in enumerate(sizes):
            if not size:
                assert not got[i].any()


@pytest.mark.gpu
def test_fused_kernels_refuse_a_plan_they_cannot_take(cuda_device):
    """A plan the body cannot take is refused by the kernel
    (cudaErrorInvalidValue, raised by the launcher), never swapped: the
    ring's KV block of 96 or no CTA, the 3xTF32 body's 64-column block at
    d = e = 128 or a CTA count, B3's 48-row tile, B4's 192-column tile or
    no CTA; the plan entries refuse a plan for the bodies that take none,
    and no plan for the ring, the 3xTF32 body and B3's tiles.  A plan of
    another body is skipped (the heuristic's runs), and a B3 plan whose
    tile is smaller than the table's blocks raises."""
    FP = fused_gen.FusedPlan
    q, k, v = _attn_operands(cuda_device, 2, 128, 128, 64, 64,
                             torch.bfloat16, 34)
    for plan in (FP("attention", "ring", 96, 132),
                 FP("attention", "ring", 128, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_gen.ATTENTION(q, k, v, True, None, torch.bfloat16,
                                plan=plan)
    qf, kf, vf = _attn_operands(cuda_device, 2, 128, 128, 128, 128,
                                torch.float32, 35)
    for plan in (FP("attention", "tc32", 64, 0),
                 FP("attention", "tc32", 32, 8)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_gen.ATTENTION(qf, kf, vf, True, None, torch.float32,
                                plan=plan)
    # the plan entry refuses the mma.sync and FMA bodies
    lib = fused_gen.ATTENTION._fn()
    h, s, d = q.shape
    o = torch.empty_like(q)
    sched = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    for body in ("mma", "fma"):
        rc = lib.attention_launch_plan(
            128, 132, 1, 1, 0, fused_gen.ATTENTION_BODIES.index(body),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
            sched.data_ptr(), h, s, k.shape[1], d, d, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            o.stride(0), o.stride(1),
            torch.cuda.current_stream(cuda_device).cuda_stream)
        assert rc == 1, body
    # and the ring and the 3xTF32 body refuse a launch with no plan
    for (a, b, c), dt, body in (((q, k, v), 1, "ring"),
                                ((qf, kf, vf), 0, "tc32")):
        oo = torch.empty_like(a)
        rc = lib.attention_launch_plan(
            0, 0, dt, dt, 0, fused_gen.ATTENTION_BODIES.index(body),
            a.data_ptr(), b.data_ptr(), c.data_ptr(), oo.data_ptr(), None,
            sched.data_ptr(), a.shape[0], a.shape[1], b.shape[1], a.shape[2],
            c.shape[2], a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            c.stride(0), c.stride(1), oo.stride(0), oo.stride(1),
            torch.cuda.current_stream(cuda_device).cuda_stream)
        assert rc == 1, body
    # another body's plan is skipped: the ring's heuristic runs
    want = fused_gen.ATTENTION(q, k, v, True, None, torch.bfloat16)
    heur = fused_gen.ATTENTION.last_plan
    got = fused_gen.ATTENTION(q, k, v, True, None, torch.bfloat16,
                              plan=FP("attention", "tc32", 32, 0))
    assert fused_gen.ATTENTION.last_plan == heur and torch.equal(got, want)

    sizes = (40, 0, 70)
    x, w = _grouped_operands(cuda_device, sizes, 64, 128, torch.bfloat16,
                             False, 36)
    table = torch.tensor(fused_gen.group_table(sizes, 32), dtype=torch.int32,
                         device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_gen.GROUPED(x, w, table, 32, torch.bfloat16,
                          plan=FP("grouped", "ring", 48, 0))
    with pytest.raises(ValueError, match="holds 32"):
        fused_gen.GROUPED(x, w, table, 32, torch.bfloat16,
                          plan=FP("grouped", "ring", 16, 0))
    xf, wf = x.float(), w.float()
    rc = fused_gen.GROUPED._fn().grouped_launch_plan(
        32, 0, 0, xf.data_ptr(), wf.data_ptr(),
        torch.empty(110, 128, device=cuda_device).data_ptr(),
        table.data_ptr(), table.shape[0], 3, 128, 64, *xf.stride(),
        *wf.stride(), 128, 1, torch.cuda.current_stream(
            cuda_device).cuda_stream)
    assert rc == 1  # f32 operands: the FMA body takes no plan
    rc = fused_gen.GROUPED._fn().grouped_launch_plan(
        0, 1, 1, x.data_ptr(), w.data_ptr(),
        torch.empty(110, 128, device=cuda_device,
                    dtype=torch.bfloat16).data_ptr(),
        table.data_ptr(), table.shape[0], 3, 128, 64, *x.stride(),
        *w.stride(), 128, 1, torch.cuda.current_stream(
            cuda_device).cuda_stream)
    assert rc == 1  # aligned bf16 operands: the tiles' bodies take a plan

    xd = torch.randn(110, 256, device=cuda_device).bfloat16()
    dd = torch.randn(110, 128, device=cuda_device).bfloat16()
    dtab = _dw_table(sizes, cuda_device)
    for plan in (FP("grouped_dw", "ring", 192, 132),
                 FP("grouped_dw", "ring", 256, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_gen.GROUPED_DW(xd, dd, dtab, torch.bfloat16, plan=plan)


@pytest.mark.gpu
def test_fused_card_ladders_and_the_ops_launch_their_winners(cuda_device):
    """``search_schedule`` on the card for attention and for the grouped
    matmul with its dX and dW: every ladder measures at least two distinct
    plans, the heuristic's among them, each checked against the oracle;
    the plan DB keeps them; ``ops.attention`` and ``ops.grouped_dense``
    (and its backward) then launch each ladder's winner, within the TOL of
    their plain versions."""
    from repro_torch import search

    db = search.default_plan_db()
    attn = PE.attention_spec(8, 256, 256, 64, causal=True)
    res = search.search_schedule(attn, dtype=torch.bfloat16, device="cuda",
                                 plan_db=db)
    assert len(res.ranked) >= 2 and res.baseline() is not None
    assert all(p.max_err <= 5e-2 and p.card is not None for p in res.ranked)
    q, k, v = (torch.randn(8, 256, 64, device=cuda_device).bfloat16()
               for _ in range(3))
    got = ops.attention(q, k, v, causal=True, differentiable=False)
    assert fused_gen.ATTENTION.last_plan == res.best.card
    _assert_rows_close(got, fused_gen.attention_ref(
        q, k, v, causal=True, kv_lengths=None, out_dtype=torch.bfloat16),
        torch.bfloat16)

    sizes = (64,) * 6
    fwd = PE.grouped_matmul_spec(sizes, 256, 128)
    results = search.search_schedule_with_grads(
        fwd, dtype=torch.bfloat16, device="cuda", plan_db=db)
    assert sorted(results) == ["dW", "dX", "fwd"]
    for res in results.values():
        assert len(res.ranked) >= 2 and res.baseline() is not None
    x = torch.randn(sum(sizes), 256, device=cuda_device).bfloat16()
    w = torch.randn(6, 256, 128, device=cuda_device).bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = ops.grouped_dense(x, w, sizes)
    assert fused_gen.GROUPED.last_plan == results["fwd"].best.card
    dy = torch.randn_like(y)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert fused_gen.GROUPED.last_plan == results["dX"].best.card
    assert fused_gen.GROUPED_DW.last_plan == results["dW"].best.card
    xd, wd = x.detach(), w.detach()
    _assert_close_scaled(y, fused_gen.grouped_ref(
        xd, wd, sizes, out_dtype=torch.bfloat16), torch.bfloat16)
    _assert_close_scaled(dx, fused_gen.grouped_ref(
        dy, wd, sizes, out_dtype=torch.bfloat16, contract_last=True),
        torch.bfloat16)
    _assert_close_scaled(dw, fused_gen.grouped_dw_ref(
        xd, dy, sizes, out_dtype=torch.bfloat16), torch.bfloat16)


@pytest.mark.gpu
def test_ops_dense_launches_a_stored_tc32_plan_the_smoke_expects(cuda_device):
    """A ladder stored for the f32 decode unembedding (M = 4, qwen3-8b's D
    and vocab) whose winner is not the heuristic's x tile: ``ops.dense``
    launches the stored plan, ``chip_smoke._searched_card`` (what phase
    ``capture``'s unembedding rows expect) names it, and the product
    stays within the f32 TOL of its plain version."""
    import os
    import sys

    from repro_torch import search
    from repro_torch.codegen.schedules import default_schedule
    from repro_torch.search.plandb import entry_from

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    m, d, vocab = 4, 4096, 151936
    spec = PE.matmul_spec(m, d, vocab)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(m, d, device=cuda_device, generator=g)
    w = torch.randn(d, vocab, device=cuda_device, generator=g)
    want = cuda_gen.contract_ref(spec, x, w, out_dtype=torch.float32)
    ops.dense(x, w, differentiable=False)
    heur = codegen.CONTRACT.last_card
    assert chip_smoke._searched_card(spec, torch.float32) is None
    assert heur == cuda_gen.CardPlan("tc32", 8, 1)
    for won in (cuda_gen.CardPlan("tc32", 16, 1),
                cuda_gen.CardPlan("tc32", 8, 2)):
        search.default_plan_db().put(spec, torch.float32, [
            entry_from(default_schedule(spec), score=float("inf"),
                       lower_bound=0.0, fits_vmem=True, measured_s=1e-4,
                       card=won.as_dict()),
            entry_from(default_schedule(spec), score=float("inf"),
                       lower_bound=0.0, fits_vmem=True, measured_s=2e-4,
                       source="default", card=heur.as_dict())])
        got = ops.dense(x, w, differentiable=False)
        assert codegen.CONTRACT.last_card == won
        assert chip_smoke._searched_card(spec, torch.float32) == won
        _assert_close_scaled(got, want, torch.float32)


# -- B1's weighted, epilogue, 8-bit and chain modes on their searched plans --

MODE_SHAPE = (512, 1024, 384)  # (M, K, N): 12 ring tiles, so splits matter
Q8_SHAPE = (2048, 512, 2048)  # 256 8-bit ring tiles: more than the SMs


def _mode_args(spec, dtype, gen, kmajor=False):
    """Seeded operands of ``spec`` on the card: normals, or ints in [-4, 4]
    for int8; ``kmajor`` lays an 8-bit product's W k-major."""
    out = []
    for axes in spec.operands.values():
        shape = tuple(spec.extents[i] for i in axes)
        if dtype == torch.int8:
            x = torch.randint(-4, 5, shape, generator=gen, device="cuda",
                              dtype=torch.int32).to(dtype)
        else:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if kmajor and len(axes) == 2 and axes[0] not in spec.output:
            x = x.t().contiguous().t()
        out.append(x)
    return out


def _launched(launcher, kern, args, plan, **vectors):
    """One call of ``kern``: one launch of ``launcher``, on ``plan``."""
    n0 = launcher.launches
    out = kern(*args, **vectors)
    torch.cuda.synchronize()
    assert launcher.launches == n0 + 1
    ran = (launcher.last_card if hasattr(launcher, "last_card")
           else launcher.last_plan)
    assert ran == plan, (ran, plan)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_weighted_mode_plans_match_the_plain_version(cuda_device, dtype):
    """Every tile plan ``card_candidates`` offers the weighted family's
    k-scale, multiplier and row reduce (its splits each a row block of
    partial rows), launched on its body: one ``CONTRACT`` launch on the
    plan, the plain version's output."""
    from repro_torch.grad import derived_specs
    from repro_torch.search import card_candidates

    gen = torch.Generator(device=cuda_device).manual_seed(31)
    fwd = PE.weighted_matmul_spec(*MODE_SHAPE)
    seen = set()
    for spec in (fwd, *derived_specs(fwd).values()):
        args = _mode_args(spec, dtype, gen)
        views = cuda_gen.card_views(spec, *args, out_dtype=dtype)
        plans = card_candidates(spec, *views[:2])
        want = cuda_gen.contract_ref(spec, *args, out_dtype=dtype)
        sched = codegen.default_schedule(spec)
        for plan in plans:
            kern = codegen.cached_compile(spec, sched, card=plan)
            got = _launched(cuda_gen.CONTRACT, kern, args, plan)
            _assert_close_scaled(got, want, dtype)
            seen.add((spec.name, plan.body))
    if dtype == torch.bfloat16:
        assert {n for n, b in seen if b == "ring"} == {
            "weighted_matmul", "weighted_matmul.dA", "weighted_matmul.dB",
            "weighted_matmul.dg"}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_epilogue_plans_match_the_plain_version(cuda_device, dtype):
    """Every plan of an epilogue ladder (``card_candidates(epilogue=True)``:
    the fused ring's, tc32's epilogue mode), launched under
    ``dense_act``'s epilogue."""
    from repro_torch.search import card_candidates
    from repro_torch.search.measure import epilogue_vectors

    gen = torch.Generator(device=cuda_device).manual_seed(32)
    spec = PE.matmul_spec(*MODE_SHAPE)
    epi = codegen.Epilogue(act="gelu", bias=True, norm=True)
    args = _mode_args(spec, dtype, gen)
    vecs = epilogue_vectors(spec, epi, cuda_device)
    plans = card_candidates(
        spec, *cuda_gen.card_views(spec, *args, epilogue=epi), epilogue=True)
    assert len(plans) >= 2
    want = cuda_gen.contract_ref(spec, *args, out_dtype=dtype, epilogue=epi,
                                 vectors=vecs)
    sched = codegen.default_schedule(spec)
    for plan in plans:
        kern = codegen.cached_compile(spec, sched, card=plan, epilogue=epi)
        got = _launched(cuda_gen.CONTRACT, kern, args, plan, **vecs)
        _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_q8_plans_match_the_plain_version(cuda_device, fmt):
    """Every plan of the 8-bit ring (``q8_card_candidates``: one CTA a
    tile here, 12 tiles) and persistent grids of 1 and 5 CTAs, each CTA
    walking several tiles, and of one CTA an SM, on the product (under
    the dequant epilogue too) and the weighted family's modes: int8
    equal element for element, fp8 at the f32 TOL."""
    from repro_torch.grad import derived_specs
    from repro_torch.search import q8_card_candidates

    gen = torch.Generator(device=cuda_device).manual_seed(33)
    dt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    gemm = PE.quantize_spec(PE.matmul_spec(*MODE_SHAPE), fmt=fmt)
    fwd = PE.weighted_matmul_spec(*MODE_SHAPE)
    specs = [gemm] + [PE.quantize_spec(s, fmt=fmt)
                      for s in (fwd, *derived_specs(fwd).values())]
    launcher = modes.CONTRACT_INT8 if fmt == "int8" else modes.CONTRACT_FP8
    ringed = 0
    for spec in specs:
        args = _mode_args(spec, dt, gen, kmajor=spec is gemm)
        plans = q8_card_candidates(spec, *args)
        if fmt == "fp8" and spec.name == "weighted_matmul":
            assert plans == []  # fp8's k-scale runs contract.cu's bf16 ring
            continue
        assert plans == [modes.Q8_HEURISTIC]  # 12 tiles: no SM's grid
        plans += [modes.Q8Plan(1), modes.Q8Plan(5),
                  modes.Q8Plan(cuda_gen._sm_count(args[0].device))]
        ringed += 1
        want = cuda_gen.contract_ref(spec, *args, out_dtype=torch.float32)
        sched = codegen.default_schedule(spec)
        for plan in plans:
            kern = codegen.cached_compile(spec, sched, card=plan,
                                          out_dtype=torch.float32)
            got = _launched(launcher, kern, args, plan)
            if fmt == "int8":
                assert torch.equal(got, want), (spec.name, plan)
            else:
                _assert_close_scaled(got, want, torch.float32)
        if spec is gemm:  # the dequant epilogue on each grid
            qscale = torch.rand(spec.extents["k"], generator=gen,
                                device=cuda_device) * 0.01
            epi = codegen.Epilogue(dequant=True)
            want = cuda_gen.contract_ref(spec, *args, out_dtype=torch.float32,
                                         epilogue=epi,
                                         vectors={"qscale": qscale})
            for plan in plans:
                kern = codegen.cached_compile(spec, sched, card=plan,
                                              epilogue=epi,
                                              out_dtype=torch.float32)
                got = _launched(launcher, kern, args, plan, qscale=qscale)
                _assert_close_scaled(got, want, torch.float32)
    assert ringed == (5 if fmt == "int8" else 4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_chain_plans_match_the_plain_version(cuda_device, dtype):
    """Every association x cluster plan of the chain
    (``chain_card_candidates``) on the chain and its derived specs: one
    ``CONTRACT_CHAIN`` launch on the plan, the plain version's output."""
    from repro_torch.grad import derived_specs
    from repro_torch.search import chain_card_candidates

    gen = torch.Generator(device=cuda_device).manual_seed(34)
    fwd = PE.chain_matmul_spec(512, 128, 1024, 128)
    for spec in (fwd, *derived_specs(fwd).values()):
        args = _mode_args(spec, dtype, gen)
        plans = chain_card_candidates(spec, dtype)
        assert {p.assoc for p in plans} == {"xy", "yz"}
        want = cuda_gen.contract_ref(spec, *args, out_dtype=dtype)
        sched = codegen.default_schedule(spec)
        for plan in plans:
            kern = codegen.cached_compile(spec, sched, card=plan)
            got = _launched(modes.CONTRACT_CHAIN, kern, args, plan)
            _assert_close_scaled(got, want, dtype)


@pytest.mark.gpu
def test_mode_kernels_refuse_a_plan(cuda_device):
    """A plan the kernel cannot take raises; nothing falls back."""
    gen = torch.Generator(device=cuda_device).manual_seed(35)
    sched = lambda s: codegen.default_schedule(s)  # noqa: E731
    fp8 = PE.quantize_spec(PE.matmul_spec(*MODE_SHAPE), fmt="fp8")
    args = _mode_args(fp8, torch.float8_e4m3fn, gen, kmajor=True)
    with pytest.raises(RuntimeError, match="q8_plan_launch failed"):
        codegen.cached_compile(fp8, sched(fp8), card=modes.Q8Plan(-1),
                               out_dtype=torch.float32)(*args)
    int8 = PE.quantize_spec(PE.matmul_spec(*MODE_SHAPE), fmt="int8")
    args = _mode_args(int8, torch.int8, gen, kmajor=True)
    with pytest.raises(RuntimeError, match="q8_plan_launch failed"):
        codegen.cached_compile(int8, sched(int8), card=modes.Q8Plan(-1),
                               out_dtype=torch.float32)(*args)
    chain = PE.chain_matmul_spec(512, 128, 1024, 128)
    args = _mode_args(chain, torch.bfloat16, gen)
    for plan in (modes.ChainPlan("xy", 3), modes.ChainPlan("yz", 16)):
        with pytest.raises(RuntimeError, match="chain_launch failed"):
            codegen.cached_compile(chain, sched(chain), card=plan)(*args)
    with pytest.raises(ValueError, match="association"):
        codegen.cached_compile(chain, sched(chain),
                               card=modes.ChainPlan("zx", 1))(*args)
    dg = __import__("repro_torch.grad", fromlist=["derived_specs"]
                    ).derived_specs(PE.weighted_matmul_spec(*MODE_SHAPE))["g"]
    args = _mode_args(dg, torch.bfloat16, gen)
    with pytest.raises(RuntimeError, match="launch failed"):
        codegen.cached_compile(dg, sched(dg),  # a row reduce 128 wide only
                               card=cuda_gen.CardPlan("ring", 256, 1))(*args)
    # the launches after refused ones run
    out = codegen.cached_compile(chain, sched(chain))(*_mode_args(
        chain, torch.bfloat16, gen))
    assert torch.isfinite(out.float()).all()


@pytest.mark.gpu
def test_mode_ladders_and_the_ops_launch_their_winners(cuda_device):
    """Card ladders of the new modes at small shapes -- the weighted
    forward, ``dense_act``'s epilogue, the int8 tier (256 tiles, under
    the dequant epilogue), the bf16 chain -- each two or more plans, the
    heuristic's among them; then the ops launch each stored winner."""
    from repro_torch import search

    gen = torch.Generator(device=cuda_device).manual_seed(36)
    bf16 = torch.bfloat16
    db = search.default_plan_db()
    epi = codegen.Epilogue(act="gelu", bias=True, norm=True, eps=1e-5)
    m, k, n = MODE_SHAPE
    points = {
        "weighted": (PE.weighted_matmul_spec(m, k, n), bf16, None),
        "dense_act": (PE.matmul_spec(m, k, n), bf16, epi),
        "int8": (PE.quantize_spec(PE.matmul_spec(*Q8_SHAPE), fmt="int8"),
                 torch.int8, None),
        "chain": (PE.chain_matmul_spec(512, 128, 1024, 128), bf16, None),
    }
    win = {}
    for tag, (spec, dt, e) in points.items():
        if tag == "int8":
            e = search.quant_tier_epilogue(spec, "cuda")
        args = _mode_args(spec, dt, gen, kmajor=dt == torch.int8)
        res = search.search_schedule(spec, dtype=dt, device="cuda",
                                     plan_db=db, epilogue=e,
                                     arrays=dict(zip(spec.operands, args)))
        cards = [p.card for p in res.ranked]
        assert len(cards) >= 2 and None not in cards, tag
        assert res.baseline() is not None, tag
        win[tag] = res.best.card
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(bf16)
    w = torch.randn(k, n, generator=gen, device=cuda_device).to(bf16)
    g = torch.randn(k, generator=gen, device=cuda_device).to(bf16)
    ops.weighted_dense(x, w, g, differentiable=False)
    assert cuda_gen.CONTRACT.last_card == win["weighted"]
    beta, mean = torch.randn(2, n, device=cuda_device)
    var = torch.rand(n, device=cuda_device) + 0.5
    ops.dense_act(x, w, beta, mean, var, differentiable=False)
    assert cuda_gen.CONTRACT.last_card == win["dense_act"]
    xq = torch.randn(Q8_SHAPE[:2], generator=gen, device=cuda_device)
    wq = torch.randn(Q8_SHAPE[1:], generator=gen, device=cuda_device)
    with torch.no_grad():
        ops.dense(xq, wq, quant="int8")
    assert modes.CONTRACT_INT8.last_card == win["int8"]
    a, b, c = (torch.randn(s, device=cuda_device).to(bf16)
               for s in ((512, 128), (128, 1024), (1024, 128)))
    ops.chain_dense(a, b, c, differentiable=False)
    assert modes.CONTRACT_CHAIN.last_plan == win["chain"]
    # the plain product's own ladder stays apart: dense_act still runs
    # its epilogue ladder's winner, ops.dense the product's
    plain = search.search_schedule(PE.matmul_spec(m, k, n), dtype=bf16,
                                   device="cuda", plan_db=db)
    ops.dense_act(x, w, beta, mean, var, differentiable=False)
    assert cuda_gen.CONTRACT.last_card == win["dense_act"]
    ops.dense(x, w, differentiable=False)
    assert cuda_gen.CONTRACT.last_card == plain.best.card
