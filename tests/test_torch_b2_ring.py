"""B2's bodies on the CPU: which body each launch takes, and the
arithmetic of the two tensor-core bodies against the reference.

``attention.cu`` has four bodies (``fused_gen.ATTENTION_BODIES``): the
bf16 ring (TMA and wgmma), the bf16 mma.sync body, the f32 3xTF32 body on
the tensor cores and the f32 FMA body.  The kernels run only on a card
(``tests/test_torch_gpu.py``); what is tested here is what the host
decides and what the new bodies compute:

* ``fused_gen.attention_body`` at every attn-path row of ``chip_smoke.py``
  (the ring at (a), (b), (c) and (e), the 3xTF32 body at (d)) and at the
  shapes the ring refuses (d = 4, d = 196, e = 256, a row stride that is
  not a multiple of 8, an unaligned pointer, mixed dtypes, no KV column);
* the 3xTF32 split, emulated in numpy (TF32 = f32 rounded to nearest at
  the 13th mantissa bit): Q.K^T and P.V at the attn-small and d = 128
  shapes within the f32 TOL (1e-4 scaled) of float64, where one TF32
  product misses it;
* an emulation of each tensor-core body's whole forward (its KV block
  width, its online softmax in the log2 domain, 3xTF32 products or bf16
  operands with P rounded to bf16) against the reference's
  ``ops.attention`` in interpret mode, at the reference's tolerances;
* the source's body codes and widest heads equal the Python's, the
  source includes ``hopper.cuh`` (so an edit of the header rebuilds it),
  ``chip_smoke._kernel_of`` attributes the new kernels' names, and the
  build phase prints ptxas's registers, spills and C75xx messages;
* the ring's tile counter is kept per (device, stream); ``chip_smoke.py``
  leaves out of a traced session only the marker's one record, and bounds
  the 3xTF32 row at its body's rate.
"""

from __future__ import annotations

import os
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as ref_ops
from repro_torch.codegen import build, fused_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 6e-2)}
LOG2E = np.float32(1.4426950408889634)
MASK = np.float32(fused_gen.MASK_VALUE)
#: the reference's attention test grid (tests/test_attention_kernels.py)
#: and one ragged head_dim-128 shape: (h, s, t, d)
SMALL = [(3, s, t, d) for d in (4, 8) for s, t in ((8, 8), (8, 16), (16, 8))]
SHAPES = SMALL + [(4, 100, 77, 128)]


# --------------------------------------------------------------------------
# the body choice
# --------------------------------------------------------------------------


def _meta(h, n, d, dtype=torch.bfloat16):
    return torch.empty(h, n, d, dtype=dtype, device="meta")


#: chip_smoke.py's attn-path rows: (h, s = t, d, dtype) and their body
ATTN_PATH = {
    "a": ((128, 512, 128, torch.bfloat16), "ring"),
    "b": ((128, 512, 128, torch.bfloat16), "ring"),  # + kv_lengths
    "c": ((128, 512, 128, torch.bfloat16), "ring"),  # + its backward
    "d": ((32, 512, 128, torch.float32), "tc32"),
    "e": ((32, 4096, 128, torch.bfloat16), "ring"),
}


@pytest.mark.parametrize("row", sorted(ATTN_PATH))
def test_attention_body_at_the_attn_path_rows(row):
    (h, s, d, dtype), body = ATTN_PATH[row]
    q, k, v = (_meta(h, s, d, dtype) for _ in range(3))
    assert fused_gen.attention_body(q, k, v) == body


def test_the_attn_path_rows_are_chip_smokes():
    """The rows above are the ones ``chip_smoke.py`` runs and checks."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    assert chip_smoke.ATTN_PATH_BODIES == {k: b for k, (_, b) in
                                           ATTN_PATH.items()}
    assert ATTN_PATH["a"][0][:3] == (chip_smoke.ATTN_HEADS,
                                     chip_smoke.ATTN_SEQ, chip_smoke.ATTN_DIM)
    assert ATTN_PATH["e"][0][:2] == (chip_smoke.ATTN_LONG_HEADS,
                                     chip_smoke.ATTN_LONG_SEQ)


def _strided(h, n, d, stored, dtype=torch.bfloat16):
    """(h, n, d) whose rows are ``stored`` elements apart."""
    return torch.empty(h, n, stored, dtype=dtype, device="meta")[:, :, :d]


def _unaligned(h, n, d):
    """(h, n, d) bf16 whose data start 2 bytes past a 16-byte boundary."""
    return torch.zeros(h * n * d + 1, dtype=torch.bfloat16)[1:].view(h, n, d)


@pytest.mark.parametrize("what,make,bf16_body,f32_body", [
    ("d = 4", lambda dt: [_meta(2, 9, 4, dt)] * 3, "mma", "tc32"),
    ("d = 196", lambda dt: [_meta(2, 9, 196, dt)] * 3, "mma", "fma"),
    ("e = 256", lambda dt: [_meta(2, 9, 64, dt), _meta(2, 9, 64, dt),
                            _meta(2, 9, 256, dt)], "mma", "fma"),
    ("e = 136", lambda dt: [_meta(2, 9, 64, dt), _meta(2, 9, 64, dt),
                            _meta(2, 9, 136, dt)], "mma", "fma"),
    ("q row stride 132", lambda dt: [_strided(2, 9, 128, 132, dt),
                                     _meta(2, 9, 128, dt),
                                     _meta(2, 9, 128, dt)], "mma", "tc32"),
    ("v head stride 4 past a multiple of 8", lambda dt: [
        _meta(2, 9, 64, dt), _meta(2, 9, 64, dt),
        torch.empty(2 * 9 * 64 + 4, dtype=dt, device="meta")
        .as_strided((2, 9, 64), (9 * 64 + 4, 64, 1))], "mma", "tc32"),
    ("no KV column", lambda dt: [_meta(2, 9, 64, dt), _meta(2, 0, 64, dt),
                                 _meta(2, 0, 64, dt)], "mma", "tc32"),
])
def test_attention_body_where_the_ring_refuses(what, make, bf16_body,
                                               f32_body):
    assert fused_gen.attention_body(*make(torch.bfloat16)) == bf16_body, what
    assert fused_gen.attention_body(*make(torch.float32)) == f32_body, what


def test_attention_body_unaligned_and_mixed():
    """An unaligned pointer keeps the mma.sync body; mixed dtypes never
    take a tensor-core body of another dtype (the launcher refuses them)."""
    k = torch.zeros(2, 9, 64, dtype=torch.bfloat16)
    assert fused_gen.attention_body(_unaligned(2, 9, 64), k, k) == "mma"
    assert fused_gen.attention_body(k, k, k) == "ring"
    f = k.float()
    assert fused_gen.attention_body(k, f, f) == "mma"
    assert fused_gen.attention_body(k, k, f) == "mma"
    assert fused_gen.attention_body(f, k, k) == "fma"
    assert fused_gen.attention_body(f, f, k) == "fma"


@pytest.mark.parametrize("d,e", [(8, 8), (64, 64), (112, 112), (128, 128),
                                 (64, 128), (128, 24), (40, 96)])
def test_attention_body_takes_every_aligned_head_up_to_128(d, e):
    """The ring takes d and e multiples of 8 up to 128, a transposed q
    view (heads not outermost) included; f32 the same widths on 3xTF32."""
    for dtype, body in ((torch.bfloat16, "ring"), (torch.float32, "tc32")):
        q = torch.empty(9, 3, d, dtype=dtype, device="meta").transpose(0, 1)
        k = _meta(3, 17, d, dtype)
        v = _meta(3, 17, e, dtype)
        assert fused_gen.attention_body(q, k, v) == body


# --------------------------------------------------------------------------
# 3xTF32
# --------------------------------------------------------------------------


def tf32(x):
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero: cvt.rna.tf32.f32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def mm_tf32(a, b, terms):
    """a @ b as the tensor cores compute it from TF32 operands, summed in
    f32: one product of the rounded operands (``terms`` 1), or the 3xTF32
    split a = hi + lo, b = hi + lo, lo.hi + hi.lo + hi.hi (``terms`` 3)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return np.matmul(ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return np.matmul(al, bh) + np.matmul(ah, bl) + np.matmul(ah, bh)


def _scaled_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tf32_rounding():
    """Round to nearest at the 13th bit, ties away; exact TF32 values stay."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    assert tf32(one) == one and tf32(one + ulp) == one + ulp
    assert tf32(one + ulp * np.float32(0.49)) == one
    assert tf32(one + ulp * np.float32(0.5)) == one + ulp  # tie: away
    assert tf32(-(one + ulp * np.float32(0.5))) == -(one + ulp)
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    assert np.all(tf32(x).view(np.uint32) & 0x1FFF == 0)
    assert np.abs(tf32(x) - x).max() <= np.abs(x).max() * 2.0 ** -11


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_3xtf32_products_hold_the_f32_tolerance(shape):
    """Q.K^T and P.V in 3xTF32 within the f32 TOL (1e-4, scaled by max
    |ref|) of float64; one TF32 product misses it (why the split)."""
    h, s, t, d = shape
    rng = np.random.default_rng(20000 + s * 31 + t * 7 + d)
    q = rng.standard_normal((h, s, d)).astype(np.float32)
    k = rng.standard_normal((h, t, d)).astype(np.float32)
    v = rng.standard_normal((h, t, d)).astype(np.float32)
    sc = np.matmul(q.astype(np.float64), k.astype(np.float64)
                   .transpose(0, 2, 1))
    p = np.exp(sc / np.sqrt(d) - (sc / np.sqrt(d)).max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    pv = np.matmul(p.astype(np.float64), v.astype(np.float64))
    limit = TOL["float32"][1]
    for got, want in ((lambda n: mm_tf32(q, k.transpose(0, 2, 1), n), sc),
                      (lambda n: mm_tf32(p, v, n), pv)):
        assert _scaled_err(got(3), want) <= limit
        assert _scaled_err(got(1), want) > limit


# --------------------------------------------------------------------------
# the tensor-core bodies' forward, emulated, against the reference
# --------------------------------------------------------------------------


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float(
        ).numpy()


def emulate_forward(q, k, v, *, causal, lengths, body):
    """The forward of B2's ``"tc32"`` body (64-column KV blocks, 3xTF32
    products) or ``"ring"`` body (128-column blocks, bf16 operands summed
    in f32, P rounded to bf16 for P.V), in f32: per head, the online
    softmax in the log2 domain with the finite mask value, probabilities
    re-zeroed where masked, the running sum taken before P's rounding,
    rows with no visible column exact zeros."""
    block = 64 if body == "tc32" else 128
    prod = ((lambda a, b: mm_tf32(a, b, 3)) if body == "tc32" else
            (lambda a, b: np.matmul(np.float32(a), np.float32(b))))
    h, s, d = q.shape
    t, e = k.shape[1], v.shape[2]
    scale = np.float32(1.0 / np.sqrt(np.float32(d))) * LOG2E
    out = np.zeros((h, s, e), np.float32)
    rows = np.arange(s)[:, None]
    with np.errstate(over="ignore", invalid="ignore"):
        for hh in range(h):
            tlen = t if lengths is None else min(t, max(int(lengths[hh]), 0))
            m = np.full(s, MASK, np.float32)
            l = np.zeros(s, np.float32)
            acc = np.zeros((s, e), np.float32)
            for c0 in range(0, tlen, block):
                cols = np.arange(c0, min(c0 + block, t))[None, :]
                sc = prod(q[hh], k[hh, c0:c0 + block].T) * scale
                valid = (cols < tlen) & ((cols <= rows) if causal else True)
                sc = np.where(valid, sc, MASK).astype(np.float32)
                mn = np.maximum(m, sc.max(-1))
                alpha = np.exp2(m - mn).astype(np.float32)
                m = mn
                p = np.where(sc == MASK, np.float32(0),
                             np.exp2(sc - m[:, None])).astype(np.float32)
                l = l * alpha + p.sum(-1, dtype=np.float32)
                if body == "ring":
                    p = _bf16(p)
                acc = acc * alpha[:, None] + prod(p, v[hh, c0:c0 + block])
            out[hh] = acc / np.where(l == 0, np.float32(1), l)[:, None]
    return out


def _close(got, want, dtype, what):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale,
                               want / scale, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("body,dtype", [("tc32", "float32"),
                                        ("ring", "bfloat16")])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_emulated_body_matches_the_reference(shape, causal, body, dtype):
    """Each tensor-core body's arithmetic against the reference's
    ``ops.attention`` (its Pallas kernel in interpret mode) on the same
    inputs, at the reference's tolerances (f32 for 3xTF32; bf16 for the
    ring, whose P is rounded to bf16)."""
    h, s, t, d = shape
    rng = np.random.default_rng(21000 + s * 31 + t * 7 + d + causal)
    q, k, v = (rng.standard_normal((h, n, d)).astype(np.float32)
               for n in (s, t, t))
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    jdt = getattr(jnp, dtype)
    want = ref_ops.attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                             jnp.asarray(v, jdt), causal=causal,
                             interpret=True)
    got = emulate_forward(q, k, v, causal=causal, lengths=None, body=body)
    _close(got, np.asarray(want, np.float32), dtype,
           f"{body} h={h} s={s} t={t} d={d} causal={causal}")


@pytest.mark.parametrize("body,dtype", [("tc32", "float32"),
                                        ("ring", "bfloat16")])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_emulated_body_with_kv_lengths(causal, body, dtype):
    """Per-head lengths [t, 3, 0] and one past T: the reference's values,
    exact zeros in the head of length 0."""
    rng = np.random.default_rng(21500 + causal)
    h, s, t, d = 4, 16, 8, 8
    q, k, v = (rng.standard_normal((h, n, d)).astype(np.float32)
               for n in (s, t, t))
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    lengths = np.asarray([t, 3, 0, t + 5], np.int32)
    jdt = getattr(jnp, dtype)
    want = ref_ops.attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                             jnp.asarray(v, jdt), causal=causal,
                             kv_lengths=jnp.asarray(lengths), interpret=True,
                             differentiable=False)
    got = emulate_forward(q, k, v, causal=causal, lengths=lengths, body=body)
    np.testing.assert_array_equal(got[2], 0.0)
    _close(got, np.asarray(want, np.float32), dtype,
           f"{body} kv_lengths causal={causal}")


# --------------------------------------------------------------------------
# the source and the smoke agree with the Python
# --------------------------------------------------------------------------


def _source():
    with open(os.path.join(build.CSRC, "attention.cu")) as f:
        return f.read()


def test_body_codes_and_widths_equal_the_sources():
    src = _source()
    codes = dict((name, int(code)) for name, code in re.findall(
        r"BODY_(\w+) = (\d)", src))
    assert {n.lower(): c for n, c in codes.items()} == {
        b: i for i, b in enumerate(fused_gen.ATTENTION_BODIES)}
    box = int(re.search(r"constexpr int RG_BOX = (\d+);", src).group(1))
    assert re.search(r"constexpr int RG_MAX_HEAD = 2 \* RG_BOX;", src)
    assert 2 * box == fused_gen.ATTN_RING_MAX_HEAD
    assert int(re.search(r"constexpr int TC_MAX_HEAD = (\d+);", src)
               .group(1)) == fused_gen.ATTN_TC32_MAX_HEAD
    assert int(re.search(r"constexpr int MAX_HEAD = (\d+);", src)
               .group(1)) == fused_gen.ATTN_MAX_HEAD


def test_attention_source_hashes_the_hopper_header():
    assert [os.path.basename(p) for p in build.sources("attention")] == [
        "attention.cu", "hopper.cuh"]


def test_kernel_names_map_to_the_attention_launcher():
    """``chip_smoke._kernel_of`` attributes every B2 body's device kernel
    to the attention launcher (none is a library attention kernel)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    of = chip_smoke._kernel_of
    ns = "void (anonymous namespace)::"
    for name in ("attn_bf16_ring_kernel<2, 2>(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, (anonymous "
                 "namespace)::AttnArgs)",
                 "attn_bf16_ring_kernel<1, 2>(...)",
                 "attn_f32_tc_kernel<128>((anonymous namespace)::AttnArgs)",
                 "attn_bf16_kernel<128>(...)", "attn_f32_kernel<256>(...)"):
        assert of(ns + name) == "attention", name
    assert of("pytorch_flash::flash_fwd_kernel<...>") is None


def test_build_phase_reports_registers_spills_and_wgmma_serialization():
    """``chip_smoke._ptxas_lines`` names each kernel with its registers and
    spills, and passes on every warning and C75xx message (a ``wgmma``
    serialization is an info line, not a warning)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Z4ringv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4ringv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized in the function '_Z4ringv'",
        "ptxas info    : Compiling entry function '_Z3tcv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3tcv",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 255 registers",
        "ptxas warning : Registers are spilled to local memory",
    ])
    assert chip_smoke._ptxas_lines(report) == [
        "_Z4ringv: 168 registers; 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads",
        "_Z3tcv: 255 registers; 8 bytes stack frame, 4 bytes spill stores, "
        "4 bytes spill loads",
        "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized in the function '_Z4ringv'",
        "ptxas warning : Registers are spilled to local memory",
    ]


# --------------------------------------------------------------------------
# the launcher's counter and chip_smoke.py's accounting
# --------------------------------------------------------------------------


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_ring_counter_is_kept_per_stream():
    """Two streams of one device get two tile counters, each zero; one
    stream gets the same counter on every call."""
    launcher = fused_gen.AttentionLauncher()
    cpu = torch.device("cpu")
    _, first = launcher._scratch.get(cpu, 1, 0, 2)
    _, other = launcher._scratch.get(cpu, 2, 0, 2)
    _, again = launcher._scratch.get(cpu, 1, 0, 2)
    assert again is first and other is not first
    assert other.data_ptr() != first.data_ptr()
    assert first.dtype == torch.int32 and first.numel() >= 2
    assert not bool(first.any()) and not bool(other.any())


def _trace(tmp_path, names):
    """A Chrome trace of one device kernel each, in this order."""
    import json

    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * i,
               "dur": 5.0} for i, n in enumerate(names)]
    events.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "ts": 0.0, "dur": 1.0})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.mark.parametrize("names,want", [
    # the marker first: its record alone is left out
    (["void at::native::FillFunctor<double>", "ring", "ring", "ring"],
     {"ring": 3}),
    # a float64 fill after the marker counts as other device work
    (["void at::native::FillFunctor<double>", "ring",
      "void at::native::FillFunctor<double>", "ring"],
     {"ring": 2, "void at::native::FillFunctor<double>": 1}),
    # the marker's record lost: nothing is left out
    (["ring", "void at::native::FillFunctor<double>", "ring"],
     {"ring": 2, "void at::native::FillFunctor<double>": 1}),
    ([], {}),
])
def test_only_the_markers_record_is_left_out(tmp_path, names, want):
    assert _chip_smoke()._kernels_after_marker(_trace(tmp_path, names)) == \
        want


def test_tc32_row_is_bounded_at_its_bodys_rate():
    """attn-path (d) (32 heads, S = T = 512, d = 128, causal, f32): its
    operations at 3xTF32's rate (TF32's 495 TFLOP/s over 3) bound it
    below the FMA rate's bound, and above its bytes."""
    cs = _chip_smoke()
    ops_, nbytes = cs._attn_work(32, 512, 512, 128, 128, True, None, 4)
    bound, ops_ms, bytes_ms, by = cs._bound(ops_, nbytes, "float32",
                                            cs.PEAK_3XTF32)
    assert cs.PEAK_3XTF32 == pytest.approx(495e12 / 3)
    assert ops_ms == pytest.approx(ops_ / 165e12 * 1e3)
    fma = cs._bound(ops_, nbytes, "float32")[0]
    assert fma == pytest.approx(ops_ / 67e12 * 1e3)
    assert bytes_ms < bound < fma and by == "operations"


@pytest.mark.parametrize("traces,launched,passes,takes", [
    # every record in the first trace, after the marker's
    ([["marker", "ring", "ring", "ring"]], 4, True, 1),
    # a trace that lost the marker's record is taken again
    ([[], ["ring", "ring"], ["marker", "ring", "ring", "ring"]], 4, True,
     3),
    # no whole trace in TAKES (the last trace repeats): the check fails
    # (the launcher's count alone does not show that nothing else ran)
    ([["ring", "ring"], [], ["ring"], ["ring", "ring", "ring"]], 4, False,
     "TAKES"),
    # a call that launched nothing, by the launcher's count
    ([["marker", "ring", "ring"]], 3, False, 1),
    # other device work fails at once
    ([["marker", "ring", "ring", "copy"]], 4, False, 1),
    # more records than launches fail at once
    ([["marker"] + ["ring"] * 4], 4, False, 1),
    # fewer records with the marker's kept fail at once
    ([["marker", "ring", "ring"]], 4, False, 1),
])
def test_alone_counts_launches_by_the_launcher_and_takes_short_traces_again(
        monkeypatch, traces, launched, passes, takes):
    """``_alone`` over 3 calls of one launch (and its warm-up call): the
    launcher counts ``launched`` a take, the take's trace holds
    ``traces`` ("marker" the session's marker record)."""
    cs = _chip_smoke()
    launcher = types.SimpleNamespace(launches=0)
    calls = []

    def fake(run, reps=3):
        calls.append(reps)
        launcher.launches += launched
        return [cs.MARKER_KERNEL if n == "marker" else n
                for n in traces[min(len(calls), len(traces)) - 1]]

    monkeypatch.setattr(cs, "_marker_records", fake)
    monkeypatch.setattr(cs, "_launcher", lambda kernel: launcher)
    monkeypatch.setattr(cs, "_kernel_of",
                        lambda name: "attention" if name == "ring" else None)
    if passes:
        cs._alone(None, "attention", 1, "case")
    else:
        with pytest.raises(AssertionError):
            cs._alone(None, "attention", 1, "case")
    assert len(calls) == (cs.TAKES if takes == "TAKES" else takes)
