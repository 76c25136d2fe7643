"""B5, B6 and B7's ring body on the CPU: which body each call takes, the
launch struct, the ring's fragment arithmetic, and B7's rounding.

``codegen/csrc/baselines.cu`` has three bodies (``_baselines.BODIES``):
the TMA / ``wgmma`` ring for B5, B6 and B7 with bf16 operands TMA can
read, ``mma.sync`` for every other bf16 call, and the FMA body for
f32.  The kernels run only on a card (``tests/test_torch_gpu.py``); what
is tested here is what the host decides and what the ring computes:

* ``_baselines.baseline_body`` at the fused path's shape, at M < 128 and
  where the ring refuses (K or N not a multiple of 8, an offset view, f32
  for every kind, a misaligned g, an empty extent);
* the ctypes ``_Params`` mirror against ``struct BaselineParams`` and the
  body codes against the source, the source's header (``hopper.cuh``) in
  its library's hash, the ring's shared memory (B6's double-buffered
  column factors included) within the card's 227 KB;
* B7's register path: each thread's A fragment read by ``ldmatrix`` from
  the 128-byte-swizzled tile, and the g values it scales them by, against
  ``mma``'s A fragment layout (emulated in numpy);
* B7's plain version rounds ``a * g`` to bf16 before the product, as the
  reference's Pallas kernel does (in interpret mode), at a seed where the
  rounding changes the result.
"""

from __future__ import annotations

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_rnz.fused_rnz import weighted_matmul_pallas
from repro.kernels.matmul.matmul import matmul_pallas
from repro_torch.codegen import build
from repro_torch.kernels import _baselines
from repro_torch.kernels.fused_rnz.fused_rnz import weighted_matmul_cuda
from repro_torch.kernels.fused_rnz.ref import weighted_matmul_ref
from repro_torch.kernels.matmul.matmul import matmul_cuda

SRC = os.path.join(os.path.dirname(_baselines.__file__), os.pardir,
                   "codegen", "csrc", "baselines.cu")
BF16 = torch.bfloat16
#: the fused path's shape (chip_smoke.py's phase baselines)
FUSED = (2048, 4096, 12288)


def _source():
    with open(SRC) as f:
        return f.read()


def _ops(m, k, n, dtype=BF16, device="cpu"):
    return (torch.zeros(m, k, dtype=dtype, device=device),
            torch.zeros(k, n, dtype=dtype, device=device),
            torch.zeros(k, dtype=dtype, device=device))


def _offset(shape, dtype=BF16):
    """A contiguous tensor whose base is one element past an aligned one."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


# --------------------------------------------------------------------------
# the body choice
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("m,k,n", [FUSED, (1000, 1000, 1000), (77, 256, 512),
                                   (1, 8, 8), (64, 96, 48)])
def test_aligned_bf16_b5_and_b7_take_the_ring(m, k, n, kind):
    """B5, B6 (kind 1, since its epilogue runs on the ring's fragments)
    and B7 with aligned bf16 operands take the ring."""
    device = "meta" if m * k > 2**20 else "cpu"
    a, b, g = _ops(m, k, n, device=device)
    g = g if kind == 2 else None
    assert _baselines.ring_refusal(kind, a, b, g) is None
    assert _baselines.baseline_body(kind, a, b, g) == "ring"


@pytest.mark.parametrize("what,kind,make,body,reason", [
    ("K not a multiple of 8", 0, lambda: _ops(64, 100, 64), "mma",
     "multiples of 8"),
    ("N not a multiple of 8", 2, lambda: _ops(64, 64, 100), "mma",
     "multiples of 8"),
    ("ragged K and N", 0, lambda: _ops(1000, 999, 1001), "mma",
     "multiples of 8"),
    ("an offset view of A", 0,
     lambda: (_offset((64, 64)),) + _ops(64, 64, 64)[1:], "mma",
     "16-byte aligned"),
    ("an offset view of B", 2,
     lambda: (_ops(64, 64, 64)[0], _offset((64, 64)), _ops(64, 64, 64)[2]),
     "mma", "16-byte aligned"),
    ("a misaligned g", 2, lambda: _ops(64, 64, 64)[:2] + (_offset((64,)),),
     "mma", "16-byte aligned"),
    ("f32 B5", 0, lambda: _ops(64, 64, 64, torch.float32), "fma",
     "float32 operands"),
    ("f32 B7", 2, lambda: _ops(64, 64, 64, torch.float32), "fma",
     "float32 operands"),
    ("f32 B6", 1, lambda: _ops(64, 64, 64, torch.float32), "fma",
     "float32 operands"),
    ("an empty extent", 0, lambda: _ops(0, 64, 64), "mma", "empty"),
    ("a strided A", 0,
     lambda: (torch.zeros(64, 128, dtype=BF16)[:, ::2],) + _ops(64, 64,
                                                                 64)[1:],
     "mma", "strided"),
])
def test_the_ring_refuses_what_tma_cannot_read(what, kind, make, body,
                                                reason):
    a, b, g = make()
    g = g if kind == 2 else None
    assert reason in _baselines.ring_refusal(kind, a, b, g), what
    assert _baselines.baseline_body(kind, a, b, g) == body, what


def test_a_misaligned_g_alone_keeps_b5_on_the_ring():
    """B5 reads no g: only B7's choice depends on it."""
    a, b, _ = _ops(64, 64, 64)
    assert _baselines.baseline_body(0, a, b) == "ring"
    assert _baselines.baseline_body(2, a, b, _offset((64,))) == "mma"


def test_the_launcher_starts_with_no_body_and_refuses_cpu_tensors():
    launcher = _baselines.BaselineLauncher("matmul", 0)
    assert launcher.launches == 0 and launcher.last_body is None
    a, b, _ = _ops(64, 64, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher(a, b, BF16, body="ring")
    assert launcher.launches == 0 and launcher.last_body is None


# --------------------------------------------------------------------------
# the source
# --------------------------------------------------------------------------


def test_params_mirror_is_the_sources_struct():
    """``_Params`` names the fields of ``struct BaselineParams`` in order
    with the C types' sizes (the library checks the size again at load)."""
    body = re.search(r"struct BaselineParams \{(.*?)\};", _source(),
                     re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        ctype, names = re.match(r"(const void\*|const float\*|void\*|"
                                r"long long|float|int) (.+);", line).groups()
        fields += [(n.strip(), ctype) for n in names.split(",")]
    size = {"const void*": 8, "const float*": 8, "void*": 8, "long long": 8,
            "float": 4, "int": 4}
    assert [f for f, _ in _baselines._Params._fields_] == [
        f for f, _ in fields]
    assert ctypes.sizeof(_baselines._Params) == sum(
        size[t] for _, t in fields) == 104
    assert [ctypes.sizeof(t) for _, t in _baselines._Params._fields_] == [
        size[t] for _, t in fields]


def test_body_codes_match_the_source():
    """``BODIES`` in the order of the struct's body codes."""
    line = re.search(r"int body;\s*// (.*)", _source()).group(1)
    codes = dict((int(c), w) for c, w in re.findall(r"\b(\d) ([\w.]+)", line))
    assert codes == {0: "mma.sync", 1: "ring", 2: "fma"}
    assert _baselines.BODIES == ("mma", "ring", "fma")


def test_the_source_hashes_the_hopper_header():
    """baselines.cu includes hopper.cuh, so an edit of the header rebuilds
    it."""
    assert [os.path.basename(p) for p in build.sources("baselines")] == [
        "baselines.cu", "hopper.cuh"]


def test_the_ring_fits_the_cards_shared_memory():
    """128 x 256 tiles, 64-deep K steps, 4 stages of A (16 KB) and B (32
    KB), g's 128 bytes a stage, B6's column factors (beta, mean, rsqrt(var
    + eps) of 256 columns, two buffers), barriers: within the 227 KB a
    block can take; 768 tiles at the fused path's shape."""
    src = _source()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (R_BM|R_BN|R_BK|R_STAGES|R_THREADS) = (\d+);", src)}
    assert const == {"R_BM": 128, "R_BN": 256, "R_BK": 64, "R_STAGES": 4,
                     "R_THREADS": 384}
    assert "constexpr int R_F_BYTES = 2 * 3 * R_BN * 4;" in src
    stage = const["R_BM"] * const["R_BK"] * 2 + const["R_BK"] * const[
        "R_BN"] * 2
    factors = 2 * 3 * const["R_BN"] * 4
    smem = const["R_STAGES"] * (stage + const["R_BK"] * 2) + 1024 + (
        factors + 2 * const["R_STAGES"] * 8)
    assert stage == 48 * 1024 and smem <= 232448
    m, _, n = FUSED
    assert (m // const["R_BM"]) * (n // const["R_BN"]) == 768


# --------------------------------------------------------------------------
# B7's register path, emulated
# --------------------------------------------------------------------------


def _swizzled(tile):
    """A (rows, 64) bf16 tile as TMA writes it under the 128-byte swizzle:
    row r's 16-byte chunk c (8 elements) at chunk c ^ r % 8."""
    out = np.empty_like(tile)
    for r in range(tile.shape[0]):
        for c in range(8):
            p = c ^ (r % 8)
            out[r, 8 * p:8 * p + 8] = tile[r, 8 * c:8 * c + 8]
    return out


def test_b7_fragments_and_their_g_follow_the_mma_layout():
    """``ring_loop_scaled``: lane l of a warp gives ldmatrix the address of
    row (l % 8) + 8 (l / 8 % 2) of its 16 rows, chunk (2 q + l / 16) ^
    row % 8 of the swizzled tile; thread t receives, from matrix j, the
    pair at row t / 4 and columns 2 (t % 4) of that 8 x 8 matrix.  Those
    are mma's A fragment of the k16 step q (rows t / 4 and + 8, k pairs 2
    (t % 4) and + 8), and the g pair the kernel reads, index 8 q + t % 4 +
    4 (j / 2) of g as bf16 pairs, is the pair of those k."""
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 2**15, size=(64, 64))  # one warpgroup's rows
    smem = _swizzled(tile)
    for warp in range(4):
        for q in range(4):
            # each lane's ldmatrix address: (row, physical chunk)
            addr = []
            for lane in range(32):
                row = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)
                addr.append((row, (2 * q + (lane >> 4)) ^ (row & 7)))
            for t in range(32):
                for j in range(4):
                    row, chunk = addr[8 * j + t // 4]
                    got = smem[row, 8 * chunk + 2 * (t % 4):
                               8 * chunk + 2 * (t % 4) + 2]
                    want_row = warp * 16 + t // 4 + 8 * (j & 1)
                    want_k = 16 * q + 2 * (t % 4) + 8 * (j >> 1)
                    np.testing.assert_array_equal(
                        got, tile[want_row, want_k:want_k + 2])
                    g_pair = 8 * q + (t % 4) + 4 * (j >> 1)
                    assert 2 * g_pair == want_k


# --------------------------------------------------------------------------
# B7's rounding, against the reference
# --------------------------------------------------------------------------


def _bf16(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    j = jnp.asarray(x, dtype=jnp.bfloat16)
    return j, torch.from_numpy(np.array(j, np.float32)).to(BF16)


@pytest.mark.parametrize("m,k,n,seed", [(64, 96, 48, 3), (128, 64, 256, 5)])
def test_b7_plain_version_rounds_a_times_g_to_bf16(m, k, n, seed):
    """At shapes the ring takes: B7's plain version (the card's oracle)
    rounds a * g to bf16 before the product, as the reference's Pallas
    kernel does, and at this seed that rounding changes the product."""
    ja, ta = _bf16((m, k), seed)
    jb, tb = _bf16((k, n), seed + 1)
    jg, tg = _bf16((k,), seed + 2)
    assert _baselines.baseline_body(2, ta, tb, tg) == "ring"
    got = weighted_matmul_ref(ta, tb, tg, out_dtype=torch.float32)
    want = weighted_matmul_pallas(ja, jb, jg, block_m=32, block_n=16,
                                  block_k=32, out_dtype=jnp.float32,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    rounded = (ta * tg).float() @ tb.float()
    unrounded = (ta.float() * tg.float()) @ tb.float()
    torch.testing.assert_close(got, rounded, rtol=1e-6, atol=1e-5)
    assert (got - unrounded).abs().max().item() > 1e-3
    # the CPU wrapper runs the plain version
    on_cpu = weighted_matmul_cuda(ta, tb, tg, block_m=m, block_n=n,
                                  block_k=k)
    assert torch.equal(on_cpu, got.to(BF16))


def test_b5_cpu_wrapper_matches_the_reference_at_a_ring_shape():
    ja, ta = _bf16((128, 64), 7)
    jb, tb = _bf16((64, 256), 8)
    assert _baselines.baseline_body(0, ta, tb) == "ring"
    got = matmul_cuda(ta, tb, block_m=64, block_n=128, block_k=32,
                      out_dtype=torch.float32)
    want = matmul_pallas(ja, jb, block_m=64, block_n=128, block_k=32,
                         out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
