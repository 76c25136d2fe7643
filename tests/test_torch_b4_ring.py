"""B4's ring body (a persistent TMA / ``wgmma`` ring with staged TMA
stores, ``grouped_dw.cu``) on the CPU.

The kernel runs only on a card (``tests/test_torch_gpu.py`` holds it
there); what is tested here is what decides and shapes its launches, and
its walk and masking emulated:

* ``fused_gen.grouped_dw_body`` at the main path's dW layouts (kimi-k2's
  training cut, 32 groups of C = 320, and its full 384 groups of C = 28,
  gate/up and down, as the MoE backward hands them), ragged K1 and K2,
  and every layout it refuses (``"mma"``) or that is f32 (``"fma"``);
* the persistent tile walk (the kernel's ``dw_tile`` and loops, mirrored
  here as ``dw_ring_walk``):
  every (group, K1 tile, K2 tile) exactly once over every partition of
  ``tests/test_torch_kernel_tables.py``'s ``SIZES``, at several grids, an
  empty group's tiles with no K step (they store zeros);
* the rows of a group's last K step that belong to the next group, and the ring's arithmetic emulated step by step
  with those rows zeroed in x's tile alone, against ``grouped_dw_ref``
  and the reference's Pallas kernel in interpret mode;
* the source: the tile constants, the C entry's arguments against the
  ctypes mirror, the staging that fits shared memory.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codegen import compile as ref_compile
from repro.codegen import default_schedule as ref_default_schedule
from repro.core.enumerate import GroupedSpec as RefGroupedSpec
import repro_torch.core.enumerate as PE
from repro_torch import codegen as port_codegen
from repro_torch.codegen import fused_gen
from repro_torch.grad import derived_specs

from test_torch_kernel_tables import KIMI_SERVE, KIMI_TRAIN, SIZES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPED_DW_CU = os.path.join(ROOT, "src", "repro_torch", "codegen", "csrc",
                             "grouped_dw.cu")
GATE, DOWN = (7168, 2048), (2048, 7168)  # kimi-k2's (K, F) of gate/up, down


#: the ring's output tile (K1 rows, K2 columns) and its K step (group
#: rows), as grouped_dw.cu's W_BM, W_BN, W_BK
DW_RING_BM, DW_RING_BN, DW_RING_BK = 128, 256, 64


def dw_ring_walk(group_sizes, k1, k2, ctas):
    """The ring's persistent tile walk, as ``grouped_dw.cu``'s ``dw_tile``
    and its loops: for each CTA of the grid (one an SM, ``ctas``, or one a
    tile where there are fewer) the (group, K1 tile, K2 tile, K steps) it
    takes, in order.  Tile t is group t // (tm tn), K1 tile (t % (tm tn))
    % tm, K2 tile (t % (tm tn)) // tm; CTA b takes tiles b, b + grid, ....
    A tile of an empty group has 0 steps: it stores zeros."""
    tm, tn = -(-k1 // DW_RING_BM), -(-k2 // DW_RING_BN)
    per = tm * tn
    count = len(group_sizes) * per
    grid = min(count, ctas)
    return [[(t // per, t % per % tm, t % per // tm,
              -(-group_sizes[t // per] // DW_RING_BK))
             for t in range(b, count, grid)] for b in range(grid)]


def dw_zeroed_rows(size):
    """Rows of a group's last K step that belong to the next group (or lie
    past the tensor), which the ring zeroes in x's tile before its wgmmas:
    0 where the group fills its last step."""
    return -size % DW_RING_BK


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16)


def _dw_operands(sizes, k, f):
    """(lhs, rhs) of ``grouped_matmul.dW`` as the MoE backward hands them
    (the dispatched tokens and the expert product's cotangent, contiguous)
    and as the compiled kernel orders them for the launcher
    (``FusedKernel._dw_operands``)."""
    spec = derived_specs(PE.grouped_matmul_spec(tuple(sizes), k, f))["W"]
    kern = port_codegen.compile(spec, port_codegen.default_schedule(spec))
    shapes = {"n": sum(sizes), "k": k, "f": f}
    return kern._dw_operands(
        [_bf16(*(shapes[i] for i in ax)) for ax in spec.operands.values()])


@pytest.mark.parametrize("sizes,kf", [
    (KIMI_TRAIN, GATE), (KIMI_TRAIN, DOWN),        # the train step's dW
    ((28,) * 384, GATE), ((28,) * 384, DOWN),     # kimi-k2's full experts
    (KIMI_SERVE, (512, 256)),
    ((0, 1, 63, 64, 65, 320), (200, 136)),        # ragged, multiples of 8
])
def test_main_path_dw_layouts_take_the_ring(sizes, kf):
    lhs, rhs = _dw_operands(sizes, *kf)
    assert lhs.shape == (sum(sizes), kf[0]) and rhs.shape == (sum(sizes),
                                                              kf[1])
    assert fused_gen.grouped_dw_body(lhs, rhs) == "ring"
    assert fused_gen.grouped_dw_body(lhs.float(), rhs.float()) == "fma"


def test_layouts_the_ring_refuses_keep_mma():
    """K1 or K2 not a multiple of 8, an element stride along K1, a row
    stride that is not 16 bytes, an unaligned base: mma.sync; f32: FMA."""
    body = fused_gen.grouped_dw_body
    x, d = _bf16(100, 256), _bf16(100, 128)
    assert body(x, d) == "ring"
    assert body(_bf16(100, 77), d) == "mma"
    assert body(x, _bf16(100, 45)) == "mma"
    assert body(_bf16(256, 100).T, d) == "mma"          # element stride
    assert body(_bf16(100, 260)[:, :256], d) == "mma"   # 520-byte rows
    assert body(_bf16(100, 264)[:, :256], d) == "ring"  # 528-byte rows
    odd = _bf16(100 * 256 + 1)[1:].view(100, 256)
    assert body(odd, d) == "mma"
    assert body(_bf16(0, 256), _bf16(0, 128)) == "mma"  # no rows
    assert body(_bf16(1, 256)[:1], _bf16(1, 128)) == "ring"
    assert body(x.float(), d.float()) == "fma"
    assert body(x, d.float()) == "mma"


# --------------------------------------------------------------------------
# the persistent walk
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", SIZES + [KIMI_TRAIN[:3], (28,) * 384],
                         ids=lambda s: str(s)[:40])
@pytest.mark.parametrize("k1,k2,ctas", [(7168, 2048, 132), (2048, 7168, 132),
                                        (200, 136, 7), (8, 8, 132)])
def test_walk_covers_every_tile_once(sizes, k1, k2, ctas):
    walk = dw_ring_walk(sizes, k1, k2, ctas)
    tm, tn = -(-k1 // DW_RING_BM), -(-k2 // DW_RING_BN)
    count = len(sizes) * tm * tn
    assert len(walk) == min(ctas, count)
    seen = [t for cta in walk for t in cta]
    assert len(seen) == count
    assert {(g, m, n) for g, m, n, _ in seen} == {
        (g, m, n) for g in range(len(sizes)) for m in range(tm)
        for n in range(tn)}
    for g, m, n, steps in seen:
        assert steps == -(-sizes[g] // DW_RING_BK)
        assert (steps == 0) == (sizes[g] == 0)  # an empty group: zeros
    # the static stride: CTA b's tiles are b, b + grid, ... in order
    per = tm * tn
    for b, cta in enumerate(walk):
        ts = [g * per + n * tm + m for g, m, n, _ in cta]
        assert ts == list(range(b, count, len(walk)))


@pytest.mark.parametrize("size", [0, 1, 28, 63, 64, 65, 127, 128, 320, 700])
def test_zeroed_rows_of_the_last_step(size):
    zero = dw_zeroed_rows(size)
    steps = -(-size // DW_RING_BK)
    if size == 0:
        assert zero == 0 and steps == 0
    else:
        valid = size - DW_RING_BK * (steps - 1)
        assert 1 <= valid <= 64 and zero == 64 - valid
        assert (zero == 0) == (size % 64 == 0)


def emulate_ring(x, d, sizes, out_dtype):
    """grouped_dw.cu's ring, emulated per tile of the walk: each K step
    reads 64 rows of x and dout from the group's first row on (rows past
    the tensor read as zeros, as TMA fills them), zeroes the rows past the
    group in x's tile only, and sums the products in f32; empty groups'
    tiles store zeros."""
    n, k1 = x.shape
    k2 = d.shape[1]
    bk = DW_RING_BK
    pad = torch.zeros(n + bk, k1)
    pad[:n] = x.float()
    padd = torch.zeros(n + bk, k2)
    padd[:n] = d.float()
    out = torch.full((len(sizes), k1, k2), float("nan"))
    offsets = fused_gen._group_offsets(tuple(sizes))
    for cta in dw_ring_walk(tuple(sizes), k1, k2, 5):
        for g, m_t, n_t, steps in cta:
            rows = slice(m_t * 128, min(k1, m_t * 128 + 128))
            cols = slice(n_t * 256, min(k2, n_t * 256 + 256))
            acc = torch.zeros(rows.stop - rows.start, cols.stop - cols.start,
                              dtype=torch.float64)
            for i in range(steps):
                r0 = offsets[g] + i * bk
                xt = pad[r0:r0 + bk, rows].clone()
                valid = sizes[g] - i * bk
                if valid < bk:
                    assert bk - valid == dw_zeroed_rows(sizes[g])
                    xt[valid:] = 0  # the next group's rows, in x only
                acc += xt.double().T @ padd[r0:r0 + bk, cols].double()
            out[g, rows, cols] = acc.float()
    assert not bool(out.isnan().any())
    return out.to(out_dtype)


@pytest.mark.parametrize("sizes,k1,k2", [
    ((0, 1, 63, 64, 65, 70, 0), 136, 264),
    ((28,) * 6, 256, 64),
    ((130, 0, 64, 1), 64, 8),
])
def test_ring_emulation_matches_plain_version_and_reference(sizes, k1, k2):
    """The emulated ring (next group's rows nonzero, so the masking shows)
    equals ``grouped_dw_ref`` in f32 and the reference's Pallas kernel in
    interpret mode on the same bf16 inputs, to the bf16 TOL; empty groups
    exact zeros."""
    rng = np.random.default_rng(k1 + k2)
    n = sum(sizes)
    xn = rng.standard_normal((n, k1)).astype(np.float32)
    dn = rng.standard_normal((n, k2)).astype(np.float32)
    x = torch.from_numpy(xn).bfloat16()
    d = torch.from_numpy(dn).bfloat16()
    got = emulate_ring(x, d, sizes, torch.float32)
    want = fused_gen.grouped_dw_ref(x, d, sizes, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    for g, s in enumerate(sizes):
        if not s:
            assert bool((got[g] == 0).all())
    if n * (k1 + k2) <= 64 * 1024:  # the reference's interpret-mode kernel
        spec = RefGroupedSpec(
            name="grouped_matmul.dW",
            operands={"dout": ("n", "f"), "X": ("n", "k")},
            output=("g", "k", "f"),
            extents={"n": n, "k": k1, "f": k2, "g": len(sizes)},
            group_sizes=tuple(sizes))
        kern = ref_compile(spec, ref_default_schedule(spec), interpret=True)
        ref = kern(jnp.asarray(d.float().numpy(), jnp.bfloat16),
                   jnp.asarray(x.float().numpy(), jnp.bfloat16))
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        scale = np.abs(ref).max()
        assert np.abs(emulate_ring(x, d, sizes, torch.bfloat16).float()
                      .numpy() - ref).max() / scale <= 6e-2


# --------------------------------------------------------------------------
# the source
# --------------------------------------------------------------------------


def test_source_constants_and_entry_match_the_launcher():
    src = open(GROUPED_DW_CU).read()
    for name, want in (("W_BM", DW_RING_BM), ("W_BN", DW_RING_BN),
                       ("W_BK", DW_RING_BK)):
        assert re.search(r"constexpr int %s = %d;" % (name, want), src), name
    # dw_ring_walk's tile order is dw_tile's
    assert "const int e = t / per, r = t - e * per;" in src
    assert "r % tm, r / tm};" in src
    entry = re.search(r"int grouped_dw_launch\((.*?)\) \{", src, re.S)
    params = [p.split()[-1].lstrip("*") for p in entry.group(1).split(",")]
    assert params[:3] == ["body", "in_dtype", "out_dtype"]
    assert len(params) == 19
    # three 48 KB stages and two 32 KB staging buffers fit the 227 KB a
    # block may use
    stage = 128 * 64 * 2 + 64 * 256 * 2
    assert re.search(r"constexpr int W_STAGES = 3;", src)
    assert 3 * stage + 2 * 64 * 256 * 2 + 1024 + 48 <= 232448
