"""B1's tc32 body (f32 products in 3xTF32 on ``wgmma``) on the CPU.

``contract.cu``'s tc32 body runs only on a card (``tests/test_torch_gpu.py``
holds it there); what is tested here is what decides and shapes its
launches, and its arithmetic emulated:

* ``cuda_gen.contract_body`` at every f32 main-path layout as
  ``_launch_cuda`` folds it: the fused path's epilogue and plain rows
  (M = 2048, K = 4096, N = 12288), a small f32 model's forward GEMMs,
  decode's M = 4, ``matmul.dA`` (W^T k-contiguous) and ``matmul.dB`` (x^T
  m-contiguous, transposed as it is split) take tc32; the k-scale
  prologue, the row reduce and layouts TMA cannot read keep the FMA body;
* ``cuda_gen.tc32_tiles``: K split only where the grid is short (phase
  ``kernel``'s M = 128), no split empty, the scratch it needs; the x
  tile's width (M rounded up to 8, 16, 32 or 64 for a plain product at M <
  64 with x k-contiguous, else 128);
* ``ContractParams``' ctypes mirror, field for field and in size, and the
  body codes ``contract_launch`` dispatches on;
* the 3xTF32 split emulated in torch on the bit pattern (cvt.rna): a
  product at K = 4096 holds the f32 TOL against the reference's f32
  contraction, one TF32 product misses it, and summing each 32-deep stage
  apart (as the body does) keeps it;
* the stage's k order: the splitting threads' gather, W's fragments in
  either layout and wgmma's k slots agree on one permutation of the 32 k;
* the transposing split of an m-contiguous x: the m-major boxes read as
  the kernel reads them give, bit for bit, the hi and lo tiles of the
  k-major split, each task's 16-byte accesses free of bank conflicts;
* a whole 128 x 128 tile emulated fragment by fragment in the swapped
  orientation (C^T = W^T x^T, wgmma's rows the product's n permuted): the
  plain store and the staged tile put every value at its (m, n), and the
  fused epilogue's row and column factors (a vector along m, along n)
  give ``Epilogue.apply``'s values; a narrow tile (8 to 64 of M) stores
  exactly the M < 64 rows it holds.
"""

from __future__ import annotations

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.enumerate as PE
from repro_torch import grad as port_grad
from repro_torch.codegen import Epilogue, cuda_gen
from repro_torch.codegen.modes import VecArg

from test_torch_b1_ring import _Recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT_CU = os.path.join(ROOT, "src", "repro_torch", "codegen", "csrc",
                           "contract.cu")
TOL_F32 = 1e-4  # the reference's f32 TOL, on values scaled by max |ref|
FUSED = (2048, 4096, 12288)  # the fused path's M, K (D), N (F)


def _handed(monkeypatch, spec, *args, **kw):
    """(a3, b3, kwargs) of the one launch ``_launch_cuda`` makes."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_gen, "CONTRACT", rec)
    cuda_gen._launch_cuda(spec, *args, out_dtype=torch.float32, **kw)
    (call,) = rec.calls
    return call


def _body_of(a3, b3, kw):
    return cuda_gen.contract_body(
        a3, b3, plain=not (set(kw) & {"kscale", "mul", "epilogue", "t"}),
        kscale=kw.get("kscale"), row_reduce="t" in kw)


def _f32(*shape):
    return torch.empty(shape, dtype=torch.float32)


# --------------------------------------------------------------------------
# the body rule
# --------------------------------------------------------------------------


@pytest.mark.parametrize("what,m,k,n,want", [
    ("epilogue", *FUSED, "tc32"),   # the ten b1-modes f32 rows
    ("plain", *FUSED, "tc32"),      # the new plain f32 row
    ("plain", 128, 4096, 4096, "tc32"),  # phase kernel's f32 case
    ("plain", 16, 256, 512, "tc32"),     # a small f32 model's forward
    ("plain", 4, 4096, 1024, "tc32"),    # decode's M
    ("dA", *FUSED, "tc32"),         # dout @ W^T, W^T k-contiguous
    ("dB", *FUSED, "tc32"),         # x^T @ dout, x^T m-contiguous
    ("dA", 16, 256, 512, "tc32"),
    ("dB", 16, 256, 512, "tc32"),
])
def test_f32_main_path_layouts_take_their_body(monkeypatch, what, m, k, n,
                                               want):
    """Each f32 product of the main path as ``_launch_cuda`` hands it to
    the launcher (views, no copy) and the body the rule gives it."""
    spec = PE.matmul_spec(m, k, n)
    x, w, dout = _f32(m, k), _f32(k, n), _f32(m, n)
    kw = {}
    if what == "epilogue":
        epi = Epilogue(act="gelu", bias=True, norm=True)
        kw = dict(epilogue=epi,
                  vectors={v: _f32(n) for v in epi.vector_names})
    dsp = port_grad.derived_specs(spec)
    spec, args = {"epilogue": (spec, (x, w)), "plain": (spec, (x, w)),
                  "dA": (dsp["A"], (dout, w)),
                  "dB": (dsp["B"], (dout, x))}[what]
    a3, b3, handed = _handed(monkeypatch, spec, *args, **kw)
    assert _body_of(a3, b3, handed) == want
    if what == "dA":  # W^T as it lies: k-contiguous B
        assert b3.stride(1) == 1
    if what == "dB":  # x^T as it lies: m-contiguous A
        assert a3.stride(1) == 1 and a3.stride(2) != 1


def _weighted(what, m=256, d=128, f=192):
    spec = PE.weighted_matmul_spec(m, d, f)
    x, w, g, dout = _f32(m, d), _f32(d, f), _f32(d), _f32(m, f)
    dsp = port_grad.derived_specs(spec)
    return {"fwd": (spec, (x, w, g)), "dA": (dsp["A"], (dout, w, g)),
            "dB": (dsp["B"], (dout, x, g)), "dg": (dsp["g"], (dout, x, w))
            }[what]


@pytest.mark.parametrize("what,want", [
    ("fwd", "fma"),   # the k-scale prologue stays on the FMA pipes
    ("dA", "tc32"),   # the multiplier on n, W^T k-contiguous
    ("dB", "tc32"),   # the multiplier on m, x^T m-contiguous
    ("dg", "fma"),    # the row reduce stays on the FMA pipes
])
def test_f32_weighted_family_takes_its_body(monkeypatch, what, want):
    spec, args = _weighted(what)
    a3, b3, kw = _handed(monkeypatch, spec, *args)
    assert set(kw) & {"kscale", "mul", "t"}
    assert _body_of(a3, b3, kw) == want


def test_f32_layouts_tma_cannot_read_keep_the_fma_body():
    """An element stride along k, rows that are not 16-byte multiples (K
    = 130), an unaligned base, a zero batch stride, an empty extent, a
    k-scale vector and the row reduce: FMA, with x k- or m-contiguous.  W
    n- or k-contiguous, x k- or m-contiguous, M = 1 and K = 4 (one 16-byte
    row): tc32."""
    body = cuda_gen.contract_body
    w = _f32(1, 64, 64)
    assert body(_f32(1, 256, 128)[:, :, ::2], w) == "fma"
    assert body(_f32(1, 256, 130), _f32(1, 130, 64)) == "fma"
    assert body(_f32(1, 256, 64), _f32(1, 64, 130)[:, :, :129]) == "fma"
    odd = torch.empty(256 * 64 + 1)[1:].view(1, 256, 64)
    assert body(odd, w) == "fma"
    assert body(_f32(1, 256, 64).expand(3, 256, 64), _f32(3, 64, 64)) == (
        "fma")
    assert body(_f32(1, 0, 64), w) == "fma"
    ks = VecArg(_f32(64), 3)
    assert body(_f32(1, 256, 64), w, plain=False, kscale=ks) == "fma"
    assert body(_f32(1, 256, 64), w, plain=False, row_reduce=True) == "fma"
    assert body(_f32(1, 256, 64), w, plain=False) == "tc32"
    assert body(_f32(1, 256, 64), _f32(1, 64, 96).transpose(1, 2)
                .contiguous().transpose(1, 2)) == "tc32"
    assert body(_f32(1, 1, 4), _f32(1, 4, 8)) == "tc32"
    # x m-contiguous (matmul.dB's x^T): tc32 where TMA reads it
    xm = _f32(1, 64, 256).transpose(1, 2)            # (1, 256, 64)
    assert body(xm, w) == "tc32"
    assert body(xm, w, plain=False) == "tc32"
    assert body(_f32(1, 4, 256).transpose(1, 2), _f32(1, 4, 8)) == "tc32"
    assert body(xm, w, plain=False, kscale=ks) == "fma"
    assert body(xm, w, plain=False, row_reduce=True) == "fma"
    assert body(_f32(1, 64, 258).transpose(1, 2)[:, :256], w) == "fma"
    assert body(_f32(1, 64, 512).transpose(1, 2)[:, ::2], w) == "fma"
    # bf16 keeps its own rule: the ring for these layouts
    bf = torch.empty(1, 256, 64, dtype=torch.bfloat16)
    assert body(bf, torch.empty(1, 64, 64, dtype=torch.bfloat16)) == "ring"


@pytest.mark.parametrize("batch,m,n,k", [
    (1, *FUSED[:1], FUSED[2], FUSED[1]),  # 1536 tiles: no split
    (1, 128, 4096, 4096),                 # 32 tiles: split 4
    (1, 128, 512, 4096),                  # 4 tiles: split 16
    (3, 70, 200, 64),                     # short K: no split
    (1, 4, 1024, 4096),                   # decode's M: 8 tiles
    (1, 1, 1, 8),
    (700, 128, 128, 8192),                # many batches, each one tile
])
def test_tc32_tiles_split_k_only_where_the_grid_is_short(batch, m, n, k):
    """The tc32 body's tile is 128 x 128; K is split only where the output
    has fewer tiles than half the card, every split gets at least 8 steps
    of 32 and none is empty, and the grid stays within its limits; the
    split's scratch is one 128 x 128 partial a split of every tile."""
    plan = cuda_gen.tc32_tiles(batch, m, n, k)
    assert plan.tile_n == 128
    tiles = batch * -(-m // 128) * -(-n // 128)
    nk = -(-k // 32)
    if tiles >= cuda_gen.H100_SMS // 2:
        assert plan.splits == 1
    per = -(-nk // plan.splits)
    assert (plan.splits - 1) * per < nk  # no empty split
    assert plan.splits == 1 or per >= cuda_gen.TC32_MIN_STEPS
    assert plan.splits <= 16 and batch * plan.splits <= 65535
    floats, ints = cuda_gen.scratch_sizes("tc32", batch, m, n, plan)
    if plan.splits > 1:
        assert (floats, ints) == (tiles * plan.splits * 128 * 128, tiles)
    else:
        assert (floats, ints) == (0, 0)
    if (batch, m, n, k) == (1, 128, 4096, 4096):
        assert plan.splits == 4 and tiles * plan.splits == 128


# --------------------------------------------------------------------------
# the params mirror and the body codes
# --------------------------------------------------------------------------


def _c_struct(name):
    src = open(CONTRACT_CU).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        parts = " ".join(decl.split()).split(",")
        if parts[0]:
            fields += [parts[0].split()[-1].lstrip("*")] + [
                p.strip() for p in parts[1:]]
    return fields


def test_params_mirror_matches_the_struct_and_its_size():
    """``_Params`` lists ``struct ContractParams``' fields in order (``Vec``
    for each vector), and its size is the C layout's: 3 pointers, 13
    int64 extents and strides, 6 vectors of 32 bytes, T, its 2 strides,
    the 2 scratch pointers, eps and 7 ints: 392 bytes (the library checks
    the same at load)."""
    fields = _c_struct("ContractParams")
    assert fields == [n for n, _ in cuda_gen._Params._fields_]
    assert _c_struct("Vec") == ["p", "div", "len", "axis", "bf16"]
    assert ctypes.sizeof(cuda_gen._Params) == 392
    assert ctypes.sizeof(dict(cuda_gen._Params._fields_)["kscale"]) == 32


def test_body_codes_are_the_ones_contract_launch_dispatches():
    """``BODY_CODES`` against the source: body 3 runs ``launch_tc32``, 1 the
    ring, 2 the narrow body, 0 mma.sync or FMA by the operands' dtype; a
    code past 3 is refused; a forced mma.sync or FMA body (code 0 both)
    is checked against the operands' dtype in Python, the others by the
    kernel."""
    src = open(CONTRACT_CU).read()
    launch = src[src.index("int contract_launch("):]
    assert "p->body > 3)" in launch
    assert re.search(r"if \(p->body == 3\) return launch_tc32\(\*p, s\);",
                     launch)
    assert "if (p->body == 1)" in launch and "if (p->body == 2)" in launch
    assert cuda_gen.BODY_CODES == {"ring": 1, "narrow": 2, "mma": 0,
                                   "tc32": 3, "fma": 0}
    assert set(cuda_gen.BODIES) == set(cuda_gen.BODY_CODES)
    # the C side's tile constants the emulation below assumes
    for name, want in (("T_BN", cuda_gen.TC32_TILE),
                       ("T_BM", cuda_gen.TC32_TILE),
                       ("T_BK", cuda_gen.TC32_BK),
                       ("T_RING_BYTES", "192 \\* 1024"), ("T_SPLIT", 96)):
        assert re.search(r"constexpr int %s = %s;" % (name, want), src), name
    # the x tile widths launch_tc32 dispatches, and the narrow ones only
    # for a plain product
    tc = src[src.index("int launch_tc32("):]
    assert "w != 8 && w != 16 && w != 32 && w != 64 && w != T_BM" in tc
    assert "(w != T_BM && features(p) != FEAT_PLAIN)" in tc
    for w in cuda_gen.TC32_WIDTHS[:-1]:
        assert f"return launch_tc32_w<false, {w}>(p, tx, stream);" in tc
    assert "return launch_tc32_w<true, T_BM>(p, tx, stream);" in tc


# --------------------------------------------------------------------------
# 3xTF32, emulated on the bit pattern
# --------------------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 by its bits: + 0x1000, the low 13 bits cleared
    (round to nearest, ties away from zero: cvt.rna.tf32.f32)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, stage: int = 0):
    """a @ b as the tc32 body sums it: lo.hi + hi.lo + hi.hi, each product
    of two TF32 values exact, summed in f32 -- over all of K, or (``stage``)
    each ``stage`` k apart and the stages added in f32."""
    ah, al = split(a)
    bh, bl = split(b)

    def part(s):
        return ((al[:, s].double() @ bh[s].double()
                 + ah[:, s].double() @ bl[s].double())
                + ah[:, s].double() @ bh[s].double()).float()

    if not stage:
        return part(slice(None))
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], stage):
        acc = acc + part(slice(k0, k0 + stage))
    return acc


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tf32_rounding_on_the_bit_pattern():
    one, ulp = 1.0, 2.0 ** -10
    x = torch.tensor([one, one + ulp, one + 0.49 * ulp, one + 0.5 * ulp,
                      -(one + 0.5 * ulp)])
    assert tf32(x).tolist() == [one, one + ulp, one, one + ulp,
                                -(one + ulp)]
    r = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    assert bool((tf32(r).view(torch.int32) & 0x1FFF == 0).all())
    hi, lo = split(r)
    assert float((hi + lo - r).abs().max()) <= float(r.abs().max()) * 2**-21


@pytest.mark.parametrize("m,k,n", [(64, 4096, 128), (128, 1024, 96)])
def test_3xtf32_product_holds_the_f32_tolerance(m, k, n):
    """At K = 4096 (the fused path's D) the 3xTF32 product, summed over all
    of K or a 32-deep stage at a time, is within the f32 TOL of the
    reference's f32 contraction; one product of the rounded operands
    misses it (why the split)."""
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b),
                                 precision="highest"))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert _scaled_err(mm_3xtf32(ta, tb), want) <= TOL_F32
    assert _scaled_err(mm_3xtf32(ta, tb, stage=32), want) <= TOL_F32
    one = (tf32(ta).double() @ tf32(tb).double()).float()
    assert _scaled_err(one, want) > TOL_F32


# --------------------------------------------------------------------------
# the stage's k order and the fragments, emulated from the source's maps
# --------------------------------------------------------------------------


def k_of_slot(q, s):
    """The k (of a stage's 32) that k8 step ``q``'s slot ``s`` holds."""
    return 2 * (s % 4) + (q & 1) + 16 * (q >> 1) + 8 * (s // 4)


def split_row_positions():
    """Position p (step p // 8, slot p % 8) of a split row <- the k that
    ``tc32_split_half`` gathers there: half u, output chunk o = 4u + c,
    element i from input chunk 4u + (i >> 1) + 2h, element 2 (i & 1) +
    (q & 1)."""
    pos = [None] * 32
    for u in range(2):
        for c in range(4):
            o = 4 * u + c
            q, h = o >> 1, o & 1
            for i in range(4):
                pos[4 * o + i] = 4 * (4 * u + (i >> 1) + 2 * h) + (
                    2 * (i & 1) + (q & 1))
    return pos


def test_the_stage_k_order_is_one_permutation():
    pos = split_row_positions()
    assert sorted(pos) == list(range(32))
    assert pos == [k_of_slot(p // 8, p % 8) for p in range(32)]


def w_fragments(w_tile, w_layout):
    """{(row, q, slot): (k, n)} of the 128 x 8 A operand of each k8 step,
    as ``tc32_fragments`` loads W's tile (w_tile[k][n], 32 x 128): thread
    (warpgroup h, warp wp, lane 4g + t) holds rows 64h + 16wp + g (+ 8)
    of wgmma's M, its registers a0 (row g, slot t), a1 (g + 8, t), a2 (g,
    t + 4), a3 (g + 8, t + 4)."""
    out = {}
    for half in range(2):
        for wp in range(4):
            for g in range(8):
                for t in range(4):
                    nl = 64 * half + 16 * wp + 2 * g
                    regs = {}  # (q, reg) -> (k, n)
                    if w_layout == "k":
                        for h in range(2):
                            for j in range(4):
                                k = 2 * t + 8 * j
                                reg = h + 2 * (j & 1)
                                regs[(2 * (j >> 1), reg)] = (k, nl + h)
                                regs[(2 * (j >> 1) + 1, reg)] = (k + 1,
                                                                 nl + h)
                    else:
                        for q in range(4):
                            for h in range(2):
                                k = 2 * t + (q & 1) + 16 * (q >> 1) + 8 * h
                                regs[(q, 2 * h)] = (k, nl)
                                regs[(q, 2 * h + 1)] = (k, nl + 1)
                    row0 = 64 * half + 16 * wp + g
                    for (q, reg), kn in regs.items():
                        row = row0 + 8 * (reg & 1)
                        slot = t + 4 * (reg >> 1)
                        assert (row, q, slot) not in out
                        out[(row, q, slot)] = kn
    return out


@pytest.mark.parametrize("w_layout", ["n", "k"])
def test_w_fragments_hold_the_slot_k_and_the_row_n(w_layout):
    """Every (row, step, slot) of the A operand is loaded once, with the k
    of the stage's order and the n of the row permutation (row 16wp + g
    holds n 16wp + 2g, row + 8 holds n + 1)."""
    frags = w_fragments(None, w_layout)
    assert len(frags) == 128 * 4 * 8
    for (row, q, slot), (k, n) in frags.items():
        assert k == k_of_slot(q, slot)
        base, r = divmod(row, 16)
        assert n == 16 * base + 2 * (r % 8) + r // 8


def emulate_tile(x, w, w_layout, rows=None):
    """A BMX x 128 output tile of x (BMX, K) @ w (K, 128) as the tc32 body
    computes it, BMX = x's rows (128, or a narrow 8 to 64): per 32-deep
    stage, the split row positions of x^T (wgmma's B), W^T's fragments
    (wgmma's A, rows permuted), three products a k8 step, the stage summed
    apart and added in f32; then the accumulator fragments of every thread
    stored to (m, n) as the plain store does, the rows m < ``rows`` only
    (all by default).  Returns (C, the staged tile as the fused store reads
    it; 128 wide only)."""
    kdim = x.shape[1]
    width = x.shape[0]
    rows = width if rows is None else rows
    frags = w_fragments(None, w_layout)
    pos = split_row_positions()
    acc = torch.zeros(128, width)  # wgmma (row, column) = (n permuted, m)
    for k0 in range(0, kdim, 32):
        xs = x[:, k0 + torch.tensor(pos)]  # (m, position)
        xh, xl = split(xs)
        part = torch.zeros(128, width, dtype=torch.float64)
        for q in range(4):
            a = torch.zeros(128, 8)
            for row in range(128):
                for slot in range(8):
                    k, n = frags[(row, q, slot)]
                    a[row, slot] = w[k0 + k, n]
            ah, al = split(a)
            bh, bl = xh[:, 8 * q:8 * q + 8].T, xl[:, 8 * q:8 * q + 8].T
            part += (al.double() @ bh.double() + ah.double() @ bl.double()
                     + ah.double() @ bh.double())
        acc = acc + part.float()
    # the store: thread (half, wp, g, t), d[4j + 2h + e] at wgmma row
    # 64 half + 16 wp + g + 8h, column 8j + 2t + e -> C[m][n], n = nl + h
    c = torch.full((width, 128), float("nan"))
    tile = torch.full((width, 136), float("nan"))
    for half in range(2):
        for wp in range(4):
            for g in range(8):
                for t in range(4):
                    nl = 64 * half + 16 * wp + 2 * g
                    for j in range(width // 8):
                        for e in range(2):
                            m = 8 * j + 2 * t + e
                            if m >= rows:  # the store's mask
                                continue
                            for h in range(2):
                                row = 64 * half + 16 * wp + g + 8 * h
                                assert torch.isnan(c[m, nl + h])
                                c[m, nl + h] = acc[row, m]
                            # the staged tile: one float2 at (m, nl)
                            tile[m, nl:nl + 2] = acc[
                                64 * half + 16 * wp + g + torch.tensor(
                                    [0, 8]), m]
    assert not bool(c[:rows].isnan().any())  # every (m, n) written once
    assert bool(c[rows:].isnan().all())      # and no row past M
    return c, tile[:, :128]


@pytest.mark.parametrize("w_layout", ["n", "k"])
def test_tile_emulation_matches_the_product(w_layout):
    """The emulated tile equals x @ w within the f32 TOL (the 3xTF32 split)
    and, with exact operands, to f64 rounding: every index map holds."""
    rng = np.random.default_rng(3 if w_layout == "n" else 4)
    x = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    c, tile = emulate_tile(x, w, w_layout)
    want = (x.double() @ w.double()).numpy()
    assert _scaled_err(c, want) <= 1e-6
    assert torch.equal(c, tile)
    # exact operands (TF32 values): the maps alone decide the result
    xt, wt = tf32(x), tf32(w)
    c, _ = emulate_tile(xt, wt, w_layout)
    assert _scaled_err(c, (xt.double() @ wt.double()).numpy()) <= 1e-7


def test_staged_tile_row_and_column_factors():
    """The fused epilogue on the staged tile (rows m, columns n): a vector
    along n is a column factor, one along m (or batch) a row factor, each
    stage's other side the identity (1, 1, 0, 0, 1), applied in
    ``epilogue()``'s order -- the same values as ``Epilogue.apply`` on the
    product, whichever axis the multiplier runs along."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32))
    _, tile = emulate_tile(x, w, "n")
    vec = {k: torch.from_numpy(rng.standard_normal(128).astype(np.float32))
           for k in ("scale", "bias", "mean")}
    vec["var"] = torch.from_numpy(rng.random(128).astype(np.float32) + .5)
    mul = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    epi = Epilogue(act="silu", scale=True, bias=True, norm=True)
    eps = epi.eps
    for mul_axis in (1, 2):
        ident = {"mul": 1.0, "scale": 1.0, "bias": 0.0, "mean": 0.0,
                 "var": 1.0}
        row = {k: torch.full((128,), v) for k, v in ident.items()}
        col = {k: torch.full((128,), v) for k, v in ident.items()}
        (row if mul_axis == 1 else col)["mul"] = mul
        for k in ("scale", "bias", "mean"):
            col[k] = vec[k]
        col["var"] = torch.rsqrt(vec["var"] + eps)
        r = {k: v[:, None] for k, v in row.items()}
        cl = {k: v[None, :] for k, v in col.items()}
        z = tile * (r["mul"] * cl["mul"])
        z = z * (r["scale"] * cl["scale"])
        z = z + (r["bias"] + cl["bias"])
        z = (z - (r["mean"] + cl["mean"])) * (r["var"] * cl["var"])
        got = z * torch.sigmoid(z)
        acc = (x.double() @ w.double()).float()
        acc = acc * (mul[:, None] if mul_axis == 1 else mul[None, :])
        want = epi.apply(acc, vec)
        assert _scaled_err(got, want.numpy()) <= TOL_F32


# --------------------------------------------------------------------------
# the m-contiguous x: the transposing split, emulated from the source's maps
# --------------------------------------------------------------------------


def k_major_landed(x):
    """x (128 m, 32 k) as TMA lands a k-major box (128-byte swizzle): row m,
    16-byte chunk c (k 4c .. 4c + 3) at position c ^ m % 8 -> (128, 8, 4)."""
    out = torch.empty(128, 8, 4)
    for m in range(128):
        for c in range(8):
            out[m, c ^ (m & 7)] = x[m, 4 * c:4 * c + 4]
    return out


def m_major_landed(x):
    """x (128 m, 32 k) as TMA lands the four m-major boxes of 32 m x 32 k:
    box j, row k, chunk c (m 32j + 4c .. + 3) at position c ^ k % 8 -> (4,
    32, 8, 4)."""
    out = torch.empty(4, 32, 8, 4)
    for j in range(4):
        for k in range(32):
            for c in range(8):
                m = 32 * j + 4 * c
                out[j, k, c ^ (k & 7)] = x[m:m + 4, k]
    return out


def split_half_emulated(landed):
    """The hi tile (in place) and the lo tile ``tc32_split_half`` leaves
    for every (row, half) of a k-major landed tile."""
    hi = landed.clone()
    lo = torch.full_like(landed, float("nan"))
    for row in range(128):
        sw = row & 7
        for u in range(2):
            inp = [landed[row, (4 * u + c) ^ sw].clone() for c in range(4)]
            for c in range(4):
                o, q, h = 4 * u + c, c >> 1, c & 1
                vals = torch.stack([inp[(i >> 1) + 2 * h][2 * (i & 1) + (q & 1)]
                                    for i in range(4)])
                hi[row, o ^ sw], lo[row, o ^ sw] = split(vals)
    return hi, lo


def split_transpose_emulated(landed):
    """The hi and lo tiles ``tc32_split_transpose``'s 256 tasks write from
    an m-major landed tile, and each task's 16-byte read and write
    positions ({task: ([read positions by slot i], [write positions by
    row e])})."""
    hi = torch.full((128, 8, 4), float("nan"))
    lo = torch.full((128, 8, 4), float("nan"))
    reads = torch.zeros(4, 32, 8, dtype=torch.int64)
    where = {}
    for task in range(256):
        o, p, r, j = task & 7, (task >> 3) & 1, (task >> 4) & 3, task >> 6
        q, h = o >> 1, o & 1
        c = 2 * (((o & 1) + 2 * (o >> 2) + r) & 3) + p
        inp, rpos, wpos = [], [], []
        for i in range(4):
            k = 2 * i + (q & 1) + 16 * (q >> 1) + 8 * h
            inp.append(landed[j, k, c ^ (k & 7)])
            reads[j, k, c ^ (k & 7)] += 1
            rpos.append(c ^ (k & 7))
        for e in range(4):
            m = 32 * j + 4 * c + e
            at = o ^ (m & 7)
            assert bool(hi[m, at].isnan().all())  # written once
            hi[m, at], lo[m, at] = split(torch.stack([v[e] for v in inp]))
            wpos.append(at)
        where[task] = (rpos, wpos)
    assert bool((reads == 1).all())  # every landed chunk read once
    return hi, lo, where


def test_transposing_split_gives_the_k_major_split_bit_for_bit():
    """An m-contiguous x tile landed m-major and split by the transposing
    tasks gives the same hi and lo tiles, bit for bit, as the same values
    landed k-major and split in place: the consumers read one layout."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    want_hi, want_lo = split_half_emulated(k_major_landed(x))
    hi, lo, _ = split_transpose_emulated(m_major_landed(x))
    assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))
    # and those tiles hold the stage's k order: row m, step q, slot s
    pos = split_row_positions()
    flat = hi.clone()
    for m in range(128):
        flat[m] = hi[m, [o ^ (m & 7) for o in range(8)]]
    assert torch.equal(flat.reshape(128, 32), tf32(x[:, pos]))


def test_transposing_split_accesses_are_free_of_bank_conflicts():
    """Eight neighbouring splitting threads (one phase of a 16-byte shared
    access) hold eight consecutive tasks in every round of the loop
    (``task = st + 96 i``); each of their four reads and four writes hits
    eight distinct 16-byte positions of a 128-byte line."""
    _, _, where = split_transpose_emulated(torch.zeros(4, 32, 8, 4))
    for st0 in range(0, 96, 8):
        for task0 in range(st0, 256, 96):
            group = [where[t] for t in range(task0, task0 + 8)]
            for i in range(4):
                assert len({rp[i] for rp, _ in group}) == 8
                assert len({wp[i] for _, wp in group}) == 8


# --------------------------------------------------------------------------
# the narrow x tile of decode's M < 64
# --------------------------------------------------------------------------


def test_tc32_width_rule():
    """M rounded up to 8, 16, 32 or 64 for a plain product at M < 64 whose
    x is k-contiguous (``narrow_x``), 128 for the fused modes and an
    m-contiguous x at any M, and for every M >= 64; the heuristic plan, the
    launcher's plan and the search's candidates carry the width."""
    n, k = 151936, 4096  # the unembedding's decode forward
    for m in range(1, 64):
        w = cuda_gen.tc32_width(m, narrow_x=True)
        assert w in (8, 16, 32, 64) and w >= m
        assert w == 8 or w // 2 < m  # the narrowest that holds M
        assert cuda_gen.tc32_width(m) == cuda_gen.TC32_TILE
        plan = cuda_gen.tc32_tiles(1, m, n, k, narrow_x=True)
        assert plan.tile_n == w
        assert cuda_gen.tc32_tiles(1, m, n, k).tile_n == 128
        assert cuda_gen.launch_plan("tc32", None, 1, m, n, k,
                                    narrow_x=True) == (plan, None)
        assert cuda_gen.heuristic_plan("tc32", 1, m, n, k, narrow_x=True) \
            == cuda_gen.CardPlan("tc32", w, plan.splits)
    for m in (64, 65, 127, 2048):
        assert cuda_gen.tc32_width(m, narrow_x=True) == 128
        assert cuda_gen.tc32_tiles(1, m, n, k, narrow_x=True).tile_n == 128
    # a searched plan of any width is taken; others are refused
    for w in cuda_gen.TC32_WIDTHS:
        assert cuda_gen._tiles_of(cuda_gen.CardPlan("tc32", w, 2)) == \
            cuda_gen.RingPlan(w, 2)
    with pytest.raises(ValueError, match="tc32"):
        cuda_gen._tiles_of(cuda_gen.CardPlan("tc32", 24, 1))


def test_narrow_width_only_for_plain_k_contiguous_x():
    """What the search offers for an f32 product at M = 4: a plain one
    with x k-contiguous every width holding M and 128; the multiplier mode
    (fused) and an m-contiguous x only 128."""
    from repro_torch.search import space as P

    x, w = _f32(1, 4, 4096), _f32(1, 4096, 1024)
    plain = P.card_candidates(PE.matmul_spec(4, 4096, 1024), x, w)
    assert {p.body for p in plain} == {"tc32"}
    assert {p.tile_n for p in plain} == set(cuda_gen.TC32_WIDTHS)
    heur = cuda_gen.heuristic_plan("tc32", 1, 4, 1024, 4096, narrow_x=True)
    assert heur.tile_n == 8 and heur in plain
    xm = _f32(1, 4096, 4).transpose(1, 2)
    assert {p.tile_n for p in P.card_candidates(
        PE.matmul_spec(4, 4096, 1024), xm, w)} == {128}
    spec = port_grad.derived_specs(PE.weighted_matmul_spec(4, 1024, 4096))[
        "A"]
    fused = P.card_candidates(spec, x, w)
    assert fused and {p.tile_n for p in fused} == {128}


@pytest.mark.parametrize("batch,m,n,k", [
    (1, 4, 151936, 4096),   # the unembedding's decode forward: 1187 tiles
    (1, 4, 4096, 151936),   # its .dA: 32 tiles, K split
    (2, 17, 1024, 4096),
    (1, 63, 256, 8192),
    (3, 1, 128, 64),
])
def test_narrow_tiles_split_and_scratch(batch, m, n, k):
    """A narrow tile's grid is (M / width) x (N / 128) a batch; K splits
    only where it is short, and its scratch is one width x 128 partial a
    split of every tile."""
    plan = cuda_gen.tc32_tiles(batch, m, n, k, narrow_x=True)
    w = plan.tile_n
    tiles = batch * -(-m // w) * -(-n // 128)
    assert tiles == batch * -(-n // 128)  # M < 64: one x tile
    if tiles >= cuda_gen.H100_SMS // 2:
        assert plan.splits == 1
    else:
        assert plan.splits > 1 or -(-k // 32) < 2 * cuda_gen.TC32_MIN_STEPS
    floats, ints = cuda_gen.scratch_sizes("tc32", batch, m, n, plan)
    if plan.splits > 1:
        assert (floats, ints) == (tiles * plan.splits * 128 * w, tiles)
    else:
        assert (floats, ints) == (0, 0)


@pytest.mark.parametrize("m", [1, 4, 8, 17, 63])
def test_narrow_tile_emulation_stores_its_rows(m):
    """A narrow tile (rows past M zero-filled by TMA) emulated fragment by
    fragment: the rows m < M equal x @ w, and no row past M is stored."""
    width = cuda_gen.tc32_width(m, narrow_x=True)
    rng = np.random.default_rng(m)
    x = torch.zeros(width, 64)
    x[:m] = torch.from_numpy(rng.standard_normal((m, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    c, _ = emulate_tile(x, w, "n", rows=m)
    assert c.shape == (width, 128)
    want = (x[:m].double() @ w.double()).numpy()
    assert _scaled_err(c[:m], want) <= 1e-6
