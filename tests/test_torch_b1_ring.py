"""B1's ring bodies (TMA and wgmma) on the CPU: which body each launch
takes, and the layouts ``_launch_cuda`` hands them.

``contract.cu`` and ``contract_q8.cu`` each have a ring body for Hopper
beside their mma.sync body.  The kernels run only on a card
(``tests/test_torch_gpu.py``); what is tested here is the Python that
decides and prepares their launches:

* ``cuda_gen.contract_body`` at every main-path shape and layout as
  ``_launch_cuda`` folds it: qwen3-8b's train forward, ``matmul.dA`` and
  ``matmul.dB`` at M = 2048 take the ring with the strided views (no
  copy), serve at M = 128 and 512 the ring, decode at M = 4 the narrow
  body, the attention backward's batched folds what their strides allow,
  the fused modes the ring at M >= 64 (no copy of ``weighted_matmul.dA``
  / ``.dB``'s transposed operands) and the mma.sync body below, ragged
  and element-strided operands the mma.sync body (copied as before);
* ``cuda_gen.narrow_tiles`` at every decode GEMM and
  ``cuda_gen.scratch_sizes`` per body;
* ``ops._tuned_kernel``'s process memo: a hit after the first lookup, a
  ``PlanDB.put`` or a tuner-cache write drops it, the phase keys it;
* ``modes.q8_body``: k-major B takes the 8-bit ring, n-major B and the
  transposed fold the mma.sync body;
* ``cuda_gen.ring_tiles``: every split non-empty, the grid within its
  limits, the few-tile shapes split;
* the folded products with the launcher replaced by a CPU batched product
  of the views it was handed, against the reference's ``jnp.einsum`` of
  the same spec;
* ``chip_smoke._kernel_of`` attributes the new kernels' device names;
* ``build.library_path`` hashes the headers a source includes.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.enumerate as RE
import repro.grad as ref_grad
import repro_torch.core.enumerate as PE
import repro_torch.ops as port_ops
from repro_torch import grad as port_grad
from repro_torch import obs
from repro_torch.codegen import Epilogue, build, cuda_gen, modes
from repro_torch.codegen import default_schedule as port_default_schedule
from repro_torch.codegen.cache import schedule_to_dict
from repro_torch.search import default_plan_db, serving_phase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: qwen3-8b's layer GEMMs (K, N): q/o, k/v, gate/up, down
LAYER_GEMMS = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))


class _Recorder:
    """Stands in for a launcher: keeps what it was handed and returns an
    uninitialised (batch, M, N) output (the shapes are full size; nothing
    is computed)."""

    def __init__(self):
        self.calls = []

    def __call__(self, a, b, out_dtype, **kw):
        self.calls.append((a, b, kw))
        if "t" in kw:  # the row reduce: one value a column
            return torch.empty((b.shape[2],), dtype=out_dtype)
        return torch.empty((a.shape[0], a.shape[1], b.shape[2]),
                           dtype=out_dtype)


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16)


def _same_storage(view, base):
    return view.untyped_storage().data_ptr() == (
        base.untyped_storage().data_ptr())


def _train_case(what, m, k, n):
    """(spec, operands) as the forward and the backward hand them."""
    spec = PE.matmul_spec(m, k, n)
    x, w, dout = _bf16(m, k), _bf16(k, n), _bf16(m, n)
    dsp = port_grad.derived_specs(spec)
    return {"fwd": (spec, (x, w)), "dA": (dsp["A"], (dout, w)),
            "dB": (dsp["B"], (dout, x))}[what]


@pytest.mark.parametrize("what", ["fwd", "dA", "dB"])
@pytest.mark.parametrize("k,n", LAYER_GEMMS)
def test_train_layer_takes_the_ring_with_no_copy(monkeypatch, k, n, what):
    """qwen3-8b's train GEMMs at M = 2048 (4 x 512 tokens): the forward,
    ``matmul.dA`` (B = W^T, k-contiguous) and ``matmul.dB`` (A = x^T,
    m-contiguous, folded so the result lands in dW's own order) reach the
    launcher as views of the operands themselves and take the ring; no
    copy of an operand or of the result."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_gen, "CONTRACT", rec)
    spec, args = _train_case(what, 2048, k, n)
    out = cuda_gen._launch_cuda(spec, *args, out_dtype=torch.bfloat16)
    assert out.shape == tuple(spec.extents[i] for i in spec.output)
    (a3, b3, kw), = rec.calls
    assert kw == {}
    assert cuda_gen.contract_body(a3, b3) == "ring"
    # views, no copy: each shares an operand's storage, and the result is
    # the launcher's own output
    first, second = (args[1], args[0]) if what == "dB" else args
    assert _same_storage(a3, first) and _same_storage(b3, second)
    assert out.is_contiguous()
    strides = {"fwd": ((k, 1), (n, 1)), "dA": ((n, 1), (1, n)),
               "dB": ((1, k), (n, 1))}[what]
    assert (a3.stride()[1:], b3.stride()[1:]) == strides


@pytest.mark.parametrize("m,body", [(4, "narrow"), (128, "ring"),
                                    (512, "ring")])
@pytest.mark.parametrize("k,n", LAYER_GEMMS)
def test_serve_shapes_pick_their_body(monkeypatch, m, k, n, body):
    """A prefill (M = 128, 512) takes the ring; a decode step of 4 lanes
    the narrow body, with x and W as they lie (no copy)."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_gen, "CONTRACT", rec)
    x, w = _bf16(m, k), _bf16(k, n)
    cuda_gen._launch_cuda(PE.matmul_spec(m, k, n), x, w,
                          out_dtype=torch.bfloat16)
    (a3, b3, _), = rec.calls
    assert cuda_gen.contract_body(a3, b3) == body


@pytest.mark.parametrize("h,s,t,d,body", [
    (128, 512, 512, 128, "ring"),   # one qwen3-8b prefill's folded heads
    (4, 100, 77, 128, "mma"),       # S = 100: K-major rows of 77 or 100
    (2, 8, 16, 8, "narrow"),        # the reference's test shapes: M < 64
])
def test_attention_backward_folds(monkeypatch, h, s, t, d, body):
    """``attention.dQ`` (A = dS k-contiguous, B = K n-contiguous), ``.dK``
    and ``.dV`` (A = dS^T / P^T m-contiguous; dV folded the other way
    round, so its result lands in (h, t, e) order) as the backward hands
    them: the ring where every stride allows it, the narrow body at
    M < 64 (dK's and dV's m-contiguous A copied k-contiguous first), else
    the mma.sync body."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_gen, "CONTRACT", rec)
    dsp = port_grad.derived_specs(PE.attention_spec(h, s, t, d))
    q, kk, g = _bf16(h, s, d), _bf16(h, t, d), _bf16(h, s, d)
    ds = p = _bf16(h, s, t)
    cases = ((dsp["Q"], (ds, kk)), (dsp["K"], (ds, q)), (dsp["V"], (g, p)))
    for spec, args in cases:
        cuda_gen._launch_cuda(spec, *args, out_dtype=torch.bfloat16)
    bodies = [cuda_gen.contract_body(a3, b3) for a3, b3, _ in rec.calls]
    assert bodies == [body] * 3
    if body == "ring":
        handed = ((ds, kk), (ds, q), (p, g))
        for (a3, b3, _), (first, second) in zip(rec.calls, handed):
            assert _same_storage(a3, first) and _same_storage(b3, second)


def test_ragged_and_strided_operands_take_the_mma_body(monkeypatch):
    """Rows that are not 16-byte multiples, element strides and an odd
    base address keep the mma.sync body (f32 the FMA body), the fused
    modes take the ring, aligned f32 the tc32 body, and the transposed
    operands of the mma.sync body are copied as before."""
    body = cuda_gen.contract_body
    x, w = _bf16(1, 256, 130), _bf16(1, 130, 256)
    assert body(x, w) == "mma"                          # K = 130
    big = _bf16(1, 256, 512)
    assert body(big[:, :, ::2], _bf16(1, 256, 64)) == "mma"  # k stride 2
    odd = _bf16(256 * 64 + 1)[1:].view(1, 256, 64)      # 2-byte offset
    assert body(odd, _bf16(1, 64, 64)) == "mma"
    assert body(_bf16(1, 256, 64), _bf16(1, 64, 64)) == "ring"
    assert body(_bf16(1, 256, 64), _bf16(1, 64, 64), plain=False) == "ring"
    f32 = torch.empty(1, 256, 64)
    assert body(f32, torch.empty(1, 64, 64)) == "tc32"
    # f32 that TMA cannot read keeps the FMA body: an element stride
    # along k, rows of 130 floats (not 16-byte multiples), an odd base
    assert body(torch.empty(1, 256, 128)[:, :, ::2],
                torch.empty(1, 64, 64)) == "fma"
    assert body(torch.empty(1, 256, 130), torch.empty(1, 130, 64)) == "fma"
    odd32 = torch.empty(256 * 64 + 1)[1:].view(1, 256, 64)  # 4-byte offset
    assert body(odd32, torch.empty(1, 64, 64)) == "fma"
    # a zero batch stride (an expanded operand) is no TMA layout
    assert body(_bf16(1, 256, 64).expand(3, 256, 64),
                _bf16(3, 64, 64)) == "mma"
    # the mma.sync body still gets its copies: dA at a 4-row batch with
    # rows of W (1001 elements) TMA cannot read; at N = 1024 the narrow
    # body reads W^T k-contiguous as it lies
    rec = _Recorder()
    monkeypatch.setattr(cuda_gen, "CONTRACT", rec)
    spec, args = _train_case("dA", 4, 4096, 1001)
    cuda_gen._launch_cuda(spec, *args, out_dtype=torch.bfloat16)
    (a3, b3, _), = rec.calls
    assert body(a3, b3) == "mma" and b3.stride(2) == 1
    assert not _same_storage(b3, args[1])
    rec.calls.clear()
    spec, args = _train_case("dA", 4, 4096, 1024)
    cuda_gen._launch_cuda(spec, *args, out_dtype=torch.bfloat16)
    (a3, b3, _), = rec.calls
    assert body(a3, b3) == "narrow" and _same_storage(b3, args[1])


def _weighted_case(what, m, d, f, dt=torch.bfloat16):
    """(spec, operands) of ``weighted_matmul`` and its derived specs as the
    backward hands them (x (m, d), w (d, f), g (d,), dout (m, f))."""
    spec = PE.weighted_matmul_spec(m, d, f)
    x, w = torch.empty(m, d, dtype=dt), torch.empty(d, f, dtype=dt)
    g, dout = torch.empty(d, dtype=dt), torch.empty(m, f, dtype=dt)
    dsp = port_grad.derived_specs(spec)
    return {"fwd": (spec, (x, w, g)), "dA": (dsp["A"], (dout, w, g)),
            "dB": (dsp["B"], (dout, x, g)), "dg": (dsp["g"], (dout, x, w))
            }[what]


@pytest.mark.parametrize("what", ["fwd", "dA", "dB", "dg", "epilogue"])
@pytest.mark.parametrize("m", [4, 63, 64, 2048])
def test_fused_modes_pick_their_body(monkeypatch, m, what):
    """The fused modes (k-scale, multiplier on n and on m, row reduce, the
    epilogue) of two bf16 operands take the ring where the product's M is
    64 or more and keep the mma.sync body below.  f32 takes the tc32 body
    at any M for the epilogue, ``.dA``'s multiplier (x k-contiguous, W^T
    k-contiguous) and ``.dB``'s (its A, x^T, m-contiguous, transposed as
    it is split); the k-scale prologue and the row reduce keep the FMA
    body.  ``.dB``'s product is x^T . dout, whose M is D (256) whatever
    m."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_gen, "CONTRACT", rec)
    rows = 256 if what == "dB" else m
    f32 = "tc32" if what in ("dA", "dB", "epilogue") else "fma"
    for dt, want in ((torch.bfloat16, "ring" if rows >= 64 else "mma"),
                     (torch.float32, f32)):
        rec.calls.clear()
        if what == "epilogue":
            spec = PE.matmul_spec(m, 256, 384)
            epi = Epilogue(act="gelu", bias=True, norm=True)
            vecs = {k: torch.empty(384) for k in epi.vector_names}
            cuda_gen._launch_cuda(spec, torch.empty(m, 256, dtype=dt),
                                  torch.empty(256, 384, dtype=dt),
                                  out_dtype=dt, epilogue=epi, vectors=vecs)
        else:
            spec, args = _weighted_case(what, m, 256, 384, dt)
            cuda_gen._launch_cuda(spec, *args, out_dtype=dt)
        (a3, b3, kw), = rec.calls
        assert set(kw) & {"kscale", "mul", "epilogue", "t"}
        assert a3.shape[1] == rows
        assert cuda_gen.contract_body(a3, b3, plain=False,
                                      kscale=kw.get("kscale"),
                                      row_reduce="t" in kw) == want


@pytest.mark.parametrize("what", ["dA", "dB"])
def test_weighted_backward_takes_the_ring_with_no_copy(monkeypatch, what):
    """``weighted_matmul.dA`` (B = W^T, k-contiguous; g on n) and ``.dB``
    (A = x^T, m-contiguous; g on m) at the fused path's shape reach the
    launcher as views of their operands, with the multiplier on the
    output axis that holds g, and take the fused ring."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_gen, "CONTRACT", rec)
    spec, args = _weighted_case(what, 2048, 4096, 12288)
    cuda_gen._launch_cuda(spec, *args, out_dtype=torch.bfloat16)
    (a3, b3, kw), = rec.calls
    assert cuda_gen.contract_body(a3, b3, plain=False) == "ring"
    first, second = (args[1], args[0]) if what == "dB" else args[:2]
    assert _same_storage(a3, first) and _same_storage(b3, second)
    assert kw["mul"].axis == (2 if what == "dA" else 1)


@pytest.mark.parametrize("m", [1, 4, 8, 16, 33, 63])
@pytest.mark.parametrize("k,n", LAYER_GEMMS)
def test_narrow_tiles_at_the_decode_gemms(m, k, n):
    """At every decode GEMM of a qwen3-8b layer: the narrowest token width
    that holds M, 128 of N a CTA, at least one CTA an SM and no more than
    fit on the card at once, and no empty split."""
    sms = cuda_gen.H100_SMS
    bn, rows, splits = cuda_gen.narrow_tiles(m, n, k, sms)
    assert bn == min(w for w in cuda_gen.NARROW_WIDTHS if w >= m)
    assert rows == cuda_gen.RING_BM
    nk = -(-k // cuda_gen.RING_BK)
    per = -(-nk // splits)
    assert 1 <= splits <= cuda_gen.NARROW_MAX_SPLITS
    assert (splits - 1) * per < nk and per >= cuda_gen.NARROW_MIN_STEPS
    ctas = -(-n // rows) * splits
    assert sms <= ctas <= cuda_gen.NARROW_PER_SM * sms


def test_narrow_tiles_at_small_and_batched_shapes():
    """Past 64 tokens the width stays 64 (the kernel refuses M > 64);
    a short K is not split below a step a split; a batch divides the
    card's CTAs between its products."""
    t = cuda_gen.narrow_tiles
    assert t(4, 4096, 4096) == (8, 128, 8)
    assert t(4, 1024, 4096) == (8, 128, 32)
    assert t(4, 12288, 4096) == (8, 128, 2)
    assert t(4, 4096, 12288) == (8, 128, 8)
    assert t(65, 4096, 4096).tile_n == 64
    assert t(4, 4096, 64).splits == 1
    assert t(16, 4096, 4096, batch=4).splits == 2


def test_scratch_sizes_per_body():
    """Split partials and counters follow each body's tile: the ring's
    128 x tile_n output tiles, the narrow body's 128 of N by its token
    width; the row reduce one partial row per row block of the body's
    tile (128 x 128 on the fused ring, the mma.sync and FMA bodies' own)
    and a counter per column block; an unsplit launch none."""
    sz = cuda_gen.scratch_sizes
    ring = cuda_gen.ring_tiles(1, 128, 1024, 4096)
    assert sz("ring", 1, 128, 1024, ring) == (8 * 16 * 128 * 128, 8)
    assert sz("ring", 1, 2048, 4096, cuda_gen.ring_tiles(1, 2048, 4096,
                                                          4096)) == (0, 0)
    narrow = cuda_gen.narrow_tiles(4, 1024, 4096)
    assert sz("narrow", 1, 4, 1024, narrow) == (8 * 32 * 128 * 8, 8)
    assert sz("narrow", 3, 4, 1000, narrow) == (24 * 32 * 128 * 8, 24)
    assert sz("ring", 1, 2048, 4096, row_reduce=True) == (16 * 4096, 32)
    assert sz("mma", 1, 2048, 4096, row_reduce=True, tile=(64, 128)) == (
        32 * 4096, 32)
    assert sz("fma", 1, 2048, 4096, row_reduce=True, tile=(128, 64)) == (
        16 * 4096, 64)


@pytest.fixture
def fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    obs.metrics_reset()
    return tmp_path


def _memo_counts():
    c = obs.metrics_json()["counters"]
    return c.get("ops.lookup.memo_hit", 0), c.get("ops.lookup.memo_miss", 0)


def test_tuned_kernel_memo_hits_after_the_first_lookup(fresh_caches):
    """The second lookup of a spec returns the first one's kernel from the
    memo, without the plan DB, the tuner cache or ``cached_compile``."""
    spec = PE.matmul_spec(128, 256, 128)
    first = port_ops._tuned_kernel(spec, torch.float32, interpret=True)
    c = obs.metrics_json()["counters"]
    looked = {k: v for k, v in c.items()
              if k.startswith(("plandb.", "autotune.", "codegen.memo."))}
    again = port_ops._tuned_kernel(PE.matmul_spec(128, 256, 128),
                                   torch.float32, interpret=True)
    assert again is first
    assert _memo_counts() == (1, 1)
    c = obs.metrics_json()["counters"]
    assert {k: v for k, v in c.items()
            if k.startswith(("plandb.", "autotune.", "codegen.memo."))
            } == looked
    # another dtype, epilogue or interpret flag is its own entry
    port_ops._tuned_kernel(spec, torch.bfloat16, interpret=True)
    port_ops._tuned_kernel(spec, torch.float32, interpret=False)
    port_ops._tuned_kernel(spec, torch.float32, interpret=True,
                           epilogue=Epilogue(act="relu"))
    assert _memo_counts() == (1, 4)


def test_tuned_kernel_memo_follows_the_plan_db(fresh_caches):
    """A ``PlanDB.put`` drops the memo: the next lookup returns the newly
    stored schedule, as a lookup without the memo would; ``.clear`` drops
    it again."""
    spec = PE.matmul_spec(128, 256, 128)
    tuned = port_ops._tuned_kernel(spec, torch.float32, interpret=True)
    stored = port_default_schedule(spec, {"i": 64, "k": 64, "j": 128})
    assert schedule_to_dict(stored) != schedule_to_dict(tuned.schedule)
    default_plan_db().put(spec, torch.float32,
                          [{"schedule": schedule_to_dict(stored)}])
    got = port_ops._tuned_kernel(spec, torch.float32, interpret=True)
    assert schedule_to_dict(got.schedule) == schedule_to_dict(stored)
    assert _memo_counts() == (0, 2)
    assert port_ops._tuned_kernel(spec, torch.float32,
                                  interpret=True) is got
    default_plan_db().clear()
    back = port_ops._tuned_kernel(spec, torch.float32, interpret=True)
    assert schedule_to_dict(back.schedule) == schedule_to_dict(
        tuned.schedule)
    assert _memo_counts() == (1, 3)


def test_tuned_kernel_memo_is_keyed_by_phase(fresh_caches):
    """A decode-phase ladder answers inside ``serving_phase("decode")``
    only; each phase keeps its own memo entry."""
    spec = PE.matmul_spec(128, 256, 128)
    decode = port_default_schedule(spec, {"i": 64, "k": 64, "j": 128})
    default_plan_db().put(spec, torch.float32,
                          [{"schedule": schedule_to_dict(decode)}],
                          phase="decode")
    outside = port_ops._tuned_kernel(spec, torch.float32, interpret=True)
    with serving_phase("decode"):
        inside = port_ops._tuned_kernel(spec, torch.float32, interpret=True)
        assert port_ops._tuned_kernel(spec, torch.float32,
                                      interpret=True) is inside
    assert schedule_to_dict(inside.schedule) == schedule_to_dict(decode)
    assert schedule_to_dict(outside.schedule) != schedule_to_dict(decode)
    assert port_ops._tuned_kernel(spec, torch.float32,
                                  interpret=True) is outside
    assert _memo_counts() == (2, 2)


def _q8(*shape, fmt):
    dt = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
    return torch.empty(shape, dtype=dt)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_8bit_body_choice(monkeypatch, fmt):
    """The 8-bit ring takes K-major operands only: A k-contiguous and B as
    ``ops.dense(quant=)`` writes W (k-contiguous); the n-major B (the
    ragged case's), the transposed fold (A stored (K, M)), unaligned rows,
    M < 64 and an fp8 K below ``FP8_RING_MIN_K`` keep q8_mma_kernel."""
    q = modes.q8_body
    for m, k, n in ((2048, 4096, 12288), (2048, 12288, 4096), (64, 384, 16)):
        a, wt = _q8(1, m, k, fmt=fmt), _q8(1, n, k, fmt=fmt)
        assert q(a, wt.transpose(1, 2)) == "ring"           # k-major W
        assert q(a, _q8(1, k, n, fmt=fmt)) == "mma"         # n-major W
    assert q(_q8(1, 1000, 999, fmt=fmt),
             _q8(1, 1001, 999, fmt=fmt).transpose(1, 2)) == "mma"
    assert q(_q8(1, 32, 4096, fmt=fmt),
             _q8(1, 4096, 4096, fmt=fmt).transpose(1, 2)) == "mma"
    # fp8 keeps mma.sync's f32 sums below FP8_RING_MIN_K; int8 is exact
    short = modes.FP8_RING_MIN_K - 16
    want = "mma" if fmt == "fp8" else "ring"
    assert q(_q8(1, 128, short, fmt=fmt),
             _q8(1, 128, short, fmt=fmt).transpose(1, 2)) == want
    # through the launch path: the transposed fold hands A (K, M) as a view
    name = "CONTRACT_INT8" if fmt == "int8" else "CONTRACT_FP8"
    rec = _Recorder()
    monkeypatch.setattr(cuda_gen, name, rec)
    spec = PE.quantize_spec(PE.transposed_matmul_spec(1024, 2048, 1024),
                            fmt=fmt)
    a, b = _q8(2048, 1024, fmt=fmt), _q8(2048, 1024, fmt=fmt)
    cuda_gen._launch_cuda(spec, a, b, out_dtype=torch.float32)
    (a3, b3, _), = rec.calls
    assert a3.stride(1) == 1 and q(a3, b3) == "mma"
    # ops.dense(quant=)'s layout: x (M, D) and W k-major
    rec.calls.clear()
    spec = PE.quantize_spec(PE.matmul_spec(2048, 4096, 12288), fmt=fmt)
    x, wt = _q8(2048, 4096, fmt=fmt), _q8(12288, 4096, fmt=fmt)
    cuda_gen._launch_cuda(spec, x, wt.t(), out_dtype=torch.float32)
    (a3, b3, _), = rec.calls
    assert q(a3, b3) == "ring"


@pytest.mark.parametrize("m", [64, 128, 512, 2048, 4096])
@pytest.mark.parametrize("k,n", LAYER_GEMMS + ((64, 64), (8, 300),
                                               (100000, 128)))
def test_ring_tiles_split_and_fill(m, k, n):
    """Every split holds at least one K step and the grid fits; shapes
    with many tiles are not split."""
    for batch in (1, 3):
        bn, splits = cuda_gen.ring_tiles(batch, m, n, k)
        assert bn in (128, 256)
        nk = -(-k // cuda_gen.RING_BK)
        per = -(-nk // splits)
        assert 1 <= splits <= 16 and (splits - 1) * per < nk
        assert batch * splits <= 65535
        tiles = batch * -(-m // 128) * -(-n // bn)
        if tiles >= cuda_gen.H100_SMS // 2:
            assert splits == 1


def test_ring_tiles_at_the_main_path_shapes():
    """The shapes the plan was sized for: the few-tile serve shapes split
    to fill 132 SMs; the wide train shapes take 256-column tiles."""
    t = cuda_gen.ring_tiles
    assert t(1, 128, 1024, 4096) == (128, 16)    # 8 tiles x 16
    assert t(1, 128, 4096, 4096) == (128, 4)     # 32 tiles x 4
    assert t(1, 512, 1024, 4096) == (128, 4)
    assert t(1, 512, 4096, 4096) == (128, 1)
    assert t(1, 2048, 4096, 4096) == (256, 1)
    assert t(1, 2048, 12288, 4096) == (256, 1)
    assert t(1, 2048, 1024, 4096) == (128, 1)


def _bmm_of_views(record):
    """A launcher that computes what the kernel would from the views it is
    handed: f32 sums of bf16 products, rounded once to the output type."""

    def run(a, b, out_dtype, **kw):
        record.append((a, b))
        return torch.bmm(a.float(), b.float()).to(out_dtype)

    return run


@pytest.mark.parametrize("name", ["fwd", "dA", "dB"])
def test_ring_layouts_compute_the_references_product(monkeypatch, name):
    """At a small ring-eligible train shape (M = 128, K = 96, N = 160), the
    views ``_launch_cuda`` hands the ring, multiplied as they lie, give the
    reference's product of the same spec (``jnp.einsum`` of the
    reference's derived spec) within the bf16 TOL."""
    rec = []
    monkeypatch.setattr(cuda_gen, "CONTRACT", _bmm_of_views(rec))
    m, k, n = 128, 96, 160
    rng = np.random.default_rng(7)
    x, w, dout = (rng.standard_normal(s).astype(np.float32)
                  for s in ((m, k), (k, n), (m, n)))
    port_spec, _ = _train_case(name, m, k, n)
    ref_base = RE.matmul_spec(m, k, n)
    ref_spec = {"fwd": ref_base, **{
        f"d{key}": s for key, s in ref_grad.derived_specs(ref_base).items()
    }}[name]
    arrays = {"fwd": (x, w), "dA": (dout, w), "dB": (dout, x)}[name]
    bf = [torch.from_numpy(v).bfloat16() for v in arrays]
    got = cuda_gen._launch_cuda(port_spec, *bf, out_dtype=torch.float32)
    (a3, b3), = rec
    assert cuda_gen.contract_body(a3, b3) == "ring"
    want = np.asarray(jnp.einsum(RE.einsum_formula(ref_spec), *[
        jnp.asarray(v.float().numpy()) for v in bf]))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               rtol=6e-2, atol=6e-2)


def test_kernel_names_map_to_their_launchers():
    """``chip_smoke._kernel_of`` attributes the rings' device kernels to
    the launchers that count them, beside the bodies they join."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    of = chip_smoke._kernel_of
    ns = "void (anonymous namespace)::"
    assert of(ns + "contract_bf16_ring_kernel<256>(CUtensorMap_st, "
              "CUtensorMap_st, void*, int)") == "contract"
    assert of(ns + "contract_bf16_ring_kernel<128>(...)") == "contract"
    assert of(ns + "q8_ring_kernel<true, 1>(CUtensorMap_st, CUtensorMap_st, "
              "Q8Params)") == "contract_int8"
    assert of(ns + "q8_ring_kernel<true, 2>(...)") == "contract_int8"
    assert of(ns + "q8_ring_kernel<false, 1>(...)") == "contract_fp8"
    assert of(ns + "contract_bf16_mma_kernel<__nv_bfloat16, true>(...)") == (
        "contract")
    assert of(ns + "contract_bf16_ring_fused_kernel<128>(CUtensorMap_st, "
              "CUtensorMap_st, ContractParams, int)") == "contract"
    assert of(ns + "contract_bf16_narrow_kernel<8>(CUtensorMap_st, "
              "CUtensorMap_st, void*, int)") == "contract"
    assert of(ns + "q8_mma_kernel<true>(Q8Params)") == "contract_int8"
    assert of(ns + "q8_mma_kernel<false>(Q8Params)") == "contract_fp8"
    assert of("ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_tn") is None


def test_library_name_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edit to a header a source includes renames its library (so it
    is rebuilt); a header it does not include does not."""
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text(
        '#include <stdint.h>\n#include "h.cuh"\nint f() { return g(); }\n')
    (tmp_path / "h.cuh").write_text('#include "i.cuh"\n'
                                    'inline int g() { return 1; }\n')
    (tmp_path / "i.cuh").write_text("// nested\n")
    (tmp_path / "other.cuh").write_text("// unused\n")
    assert [os.path.basename(p) for p in build.sources("k")] == [
        "k.cu", "h.cuh", "i.cuh"]
    first = build.library_path("k")
    (tmp_path / "other.cuh").write_text("// changed\n")
    assert build.library_path("k") == first
    (tmp_path / "i.cuh").write_text("// nested, changed\n")
    assert build.library_path("k") != first


def test_real_sources_hash_the_hopper_header():
    """Both ring sources include ``hopper.cuh``."""
    for name in ("contract", "contract_q8"):
        assert [os.path.basename(p) for p in build.sources(name)] == [
            f"{name}.cu", "hopper.cuh"]
