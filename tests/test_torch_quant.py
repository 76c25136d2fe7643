"""The port's int8/fp8 tier against the reference.

Inputs are made with numpy from a seed and handed to both packages; the
reference runs its Pallas kernels in interpret mode, the port its kernels'
plain versions (CPU tensors).  Tolerances are the reference's
(``tests/test_quant_kernels.py``, ``tests/test_differential.py``): int8
exact, fp8 at 1e-4 of max(|ref|, 1), the dequantized ``ops.dense`` at
1e-5 of max(|ref|, 1).

* ``optim.quant``: ``quantize_tensor``, ``quantize_channels`` (and its
  k-major form), ``quantize_tree``, ``dequantize_tree``,
  ``tree_quant_bytes`` bit for bit, with empty tensors, all-zero blocks
  and ``min_size``;
* the quant spec and key contracts of ``tests/test_quant_kernels.py``
  (``TestQuantSpec``, ``TestQuantKeys``, ``TestFusedRefusals``);
* the dequant epilogue matrix; the output dtype rule;
* ``ops.dense(quant=)``: kernel path against the dequantized oracle and the
  reference, the odd-shape fallback, the empty batch, an unknown format,
  no silent gradient;
* the quantized rows of ``tests/test_differential.py`` through the port's
  ``codegen.compile``, and the raw int8 kernel at odd extents;
* ``cuda_gen._launch_cuda``'s folding of the 8-bit modes against an
  emulation of the kernels' arithmetic (the kernels need the card);
* weight-only serving: the int8 tree of both packages from weights
  carried across, and greedy tokens of the engine with ``quant="int8"``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.enumerate as RE
import repro_torch.codegen.cache as port_cache
import repro_torch.core.enumerate as PE
from repro import codegen as ref_codegen
from repro import ops as ref_ops
from repro.codegen.cache import cache_key as ref_cache_key
from repro.codegen.cache import schedule_to_dict as ref_schedule_to_dict
from repro.codegen.cache import spec_signature as ref_signature
from repro.optim import quant as RQ
from repro.search import candidate_schedule, einsum_reference, reference_arrays
from repro_torch import codegen as port_codegen
from repro_torch import grad as port_grad
from repro_torch import ops as port_ops
from repro_torch.codegen import cuda_gen
from repro_torch.optim import quant as PQ

from test_torch_foundation import to_port_spec

FORMATS = ("int8", "fp8")
STORE = {"int8": (torch.int8, np.int8),
         "fp8": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn)}
EXTENT_POOL = (2, 3, 4, 6, 8)  # test_differential.py
FAMILIES = {  # test_differential.py: family -> (ctor, arity, seed offset)
    "matmul": ("matmul_spec", 3, 1000),
    "matvec": ("matvec_spec", 2, 2000),
    "weighted_matmul": ("weighted_matmul_spec", 3, 3000),
    "batched_matmul": ("batched_matmul_spec", 4, 4000),
    "transposed_matmul": ("transposed_matmul_spec", 3, 5000),
    "chain_matmul": ("chain_matmul_spec", 4, 6000),
}
QUANT_SEEDS = (0, 1, 2)


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


def _np(x) -> np.ndarray:
    """Raw storage of a torch or jax array as numpy (fp8 as its bytes)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.detach().numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(a))


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def _close_scaled(got, want, tol, what=""):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol,
                               err_msg=what)


# --------------------------------------------------------------------------
# optim.quant: bit for bit
# --------------------------------------------------------------------------

SHAPES = [(7, 5), (64, 33), (0, 4), (3, 0), (4, 128, 3), (1,), (300,)]


def _tensor_case(shape, seed, zero_rows=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.choice([0.01, 1.0, 300.0])).astype(
        np.float32)
    if zero_rows and x.size:
        x[..., :1] = 0.0
    return x


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_tensor_bit_for_bit(shape, fmt):
    for seed in range(3):
        x = _tensor_case(shape, 700 + seed)
        rq, rs = RQ.quantize_tensor(jnp.asarray(x), fmt)
        pq, ps = PQ.quantize_tensor(torch.from_numpy(x), fmt)
        assert pq.dtype == STORE[fmt][0] and tuple(pq.shape) == shape
        np.testing.assert_array_equal(_np(pq), _np(rq))
        assert ps.dtype == torch.float32
        np.testing.assert_array_equal(_np(ps), np.asarray(rs))
    zeros = np.zeros(shape, np.float32)
    pq, ps = PQ.quantize_tensor(torch.from_numpy(zeros), fmt)
    assert float(ps) == 1.0 and not _np(pq).any()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [s for s in SHAPES if len(s) >= 2], ids=str)
def test_quantize_channels_bit_for_bit(shape, fmt):
    for seed in range(3):
        x = _tensor_case(shape, 710 + seed, zero_rows=True)
        rq, rs = RQ.quantize_channels(jnp.asarray(x), fmt)
        pq, ps = PQ.quantize_channels(torch.from_numpy(x), fmt)
        np.testing.assert_array_equal(_np(pq), _np(rq))
        np.testing.assert_array_equal(_np(ps), np.asarray(rs))
        if len(shape) == 2:
            # the k-major copy the 8-bit kernel reads: same values
            qt, st = PQ.quantize_channels_kmajor(torch.from_numpy(x), fmt)
            assert qt.is_contiguous() and tuple(qt.shape) == shape[::-1]
            np.testing.assert_array_equal(_np(qt.t().contiguous()), _np(rq))
            np.testing.assert_array_equal(_np(st), np.asarray(rs))


def test_quantize_helpers_refuse_unknown_formats():
    with pytest.raises(KeyError):
        PQ.quantize_tensor(torch.ones(3), "int4")
    with pytest.raises(ValueError, match="int4"):
        PQ._storage_dtype("int4")
    with pytest.raises(NotImplementedError, match="'int8'"):
        PQ.quantize_tree({"w": torch.ones(64, 64)}, fmt="fp8")


def _trees(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"big": (64, 96), "stack": (3, 40, 50), "small": (8, 8),
              "vec": (5000,), "zero": (32, 256), "ragged": (7, 77)}
    tree = {k: rng.standard_normal(s).astype(dtype) for k, s in shapes.items()}
    tree["zero"][:, :] = 0.0
    tree["nested"] = {"a": rng.standard_normal((70, 70)).astype(dtype),
                      "b": [rng.standard_normal((2, 4096)).astype(dtype)]}
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("min_size", [64, 4096, 10**6])
def test_quantize_tree_bit_for_bit(min_size):
    np_tree = _trees(720)
    rtree = RQ.quantize_tree(_map(jnp.asarray, np_tree), min_size=min_size)
    ptree = PQ.quantize_tree(_map(torch.from_numpy, np_tree),
                             min_size=min_size)

    def pairs(r, p):
        if isinstance(r, dict):
            for k in r:
                yield from pairs(r[k], p[k])
        elif isinstance(r, list):
            for a, b in zip(r, p):
                yield from pairs(a, b)
        else:
            yield r, p

    n_quant = 0
    for r, p in pairs(rtree, ptree):
        assert isinstance(r, RQ.Quantized) == isinstance(p, PQ.Quantized)
        if isinstance(r, RQ.Quantized):
            n_quant += 1
            np.testing.assert_array_equal(p.q.numpy(), np.asarray(r.q))
            np.testing.assert_array_equal(p.scale.numpy(),
                                          np.asarray(r.scale))
            assert p.shape == tuple(r.shape)
        else:
            np.testing.assert_array_equal(_np(p), np.asarray(r))
    assert n_quant == {64: 7, 4096: 5, 10**6: 0}[min_size]
    assert PQ.tree_quant_bytes(ptree) == RQ.tree_quant_bytes(rtree)
    rback = RQ.dequantize_tree(rtree)
    pback = PQ.dequantize_tree(ptree)
    for r, p in pairs(rback, pback):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(_np(p), np.asarray(r))


def test_quantize_and_dequantize_in_chunks_keep_the_bits(monkeypatch):
    """A leaf larger than ``CHUNK`` is quantized chunk by chunk: the same
    bits as one whole pass (a chunk is a whole number of blocks); a bf16
    leaf expands to the reference's bf16 bits."""
    rng = np.random.default_rng(730)
    x = torch.from_numpy(rng.standard_normal((37, 1000)).astype(np.float32))
    whole = PQ.quantize(x)
    monkeypatch.setattr(PQ, "CHUNK", 4 * PQ.BLOCK)
    chunked = PQ.quantize(x)
    assert torch.equal(chunked.q, whole.q)
    assert torch.equal(chunked.scale, whole.scale)
    assert torch.equal(PQ.dequantize(chunked), PQ.dequantize(whole))
    rq = RQ.quantize(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(chunked.q.numpy(), np.asarray(rq.q))
    # a bf16 leaf (a partial last block too): f32 products rounded once
    for cols in (1000, 999):
        xb = x[:, :cols].bfloat16()
        back = PQ.dequantize(PQ.quantize(xb))
        want = RQ.dequantize(RQ.quantize(jnp.asarray(xb.float().numpy(),
                                                     jnp.bfloat16)))
        assert back.dtype == torch.bfloat16 and back.shape == xb.shape
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(want, np.float32))


# --------------------------------------------------------------------------
# the quant spec and keys (tests/test_quant_kernels.py's contracts)
# --------------------------------------------------------------------------


class TestQuantSpec:
    def test_quant_meta_validates_fields(self):
        for mod in (RE, PE):
            with pytest.raises(ValueError, match="dtype"):
                mod.QuantMeta(dtype="int4", accum="int32")
            with pytest.raises(ValueError, match="accumulator"):
                mod.QuantMeta(dtype="int8", accum="int16")
            with pytest.raises(ValueError, match="granularity"):
                mod.QuantMeta(dtype="int8", accum="int32", scale="per_row")
        for fmt in FORMATS:
            r, p = RE.QUANT_FORMATS[fmt], PE.QUANT_FORMATS[fmt]
            assert (p.dtype, p.accum, p.scale) == (r.dtype, r.accum, r.scale)

    def test_quantize_spec_guards(self):
        spec = PE.matmul_spec(8, 8, 8)
        sub = port_codegen.default_schedule(spec, {"i": 4, "j": 8, "k": 8})
        if sub.spec.parent is not None:
            with pytest.raises(ValueError, match="root"):
                PE.quantize_spec(sub.spec)
        with pytest.raises(NotImplementedError, match="no quantized"):
            PE.quantize_spec(PE.attention_spec(2, 8, 8, 4))
        with pytest.raises(ValueError, match="int4"):
            PE.quantize_spec(spec, fmt="int4")

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_quantized_specs_equal_the_references(self, fmt):
        for ctor, args in (("matmul_spec", (4, 6, 8)),
                           ("chain_matmul_spec", (2, 3, 4, 5)),
                           ("weighted_matmul_spec", (4, 6, 8))):
            r = RE.quantize_spec(getattr(RE, ctor)(*args), fmt=fmt)
            p = PE.quantize_spec(getattr(PE, ctor)(*args), fmt=fmt)
            assert p == to_port_spec(r)
            assert p.name == r.name == ctor[:-5]  # the family name stays
        r = RE.quantized_matmul_spec(4, 6, 8, fmt, scale="per_tensor")
        p = PE.quantized_matmul_spec(4, 6, 8, fmt, scale="per_tensor")
        assert p == to_port_spec(r)

    def test_quant_survives_subdivision_via_root(self):
        spec = PE.quantized_matmul_spec(16, 16, 16, "int8")
        sched = port_codegen.default_schedule(spec, {"i": 8, "j": 16,
                                                     "k": 16})
        assert sched.spec.root().quant == PE.QUANT_FORMATS["int8"]


class TestQuantKeys:
    def test_signature_folds_quant_only_when_present(self):
        plain = port_cache.spec_signature(PE.matmul_spec(64, 64, 64))
        assert "quant" not in plain
        q = port_cache.spec_signature(
            PE.quantized_matmul_spec(64, 64, 64, fmt="int8"))
        assert q == ref_signature(RE.quantized_matmul_spec(64, 64, 64,
                                                           fmt="int8"))
        assert q["quant"] == {"dtype": "int8", "accum": "int32",
                              "scale": "per_channel"}

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_quant_keys_disjoint_from_bf16(self, fmt):
        meta = PE.QUANT_FORMATS[fmt]
        spec = PE.matmul_spec(128, 128, 128)
        qspec = PE.quantize_spec(spec, fmt=fmt)
        store = STORE[fmt][0]
        keys = {
            port_cache.cache_key(spec, dtype=torch.float32, hardware="pin/hw"),
            port_cache.cache_key(spec, dtype=torch.bfloat16,
                                 hardware="pin/hw"),
            port_cache.cache_key(qspec, dtype=store, hardware="pin/hw"),
            port_cache.cache_key(qspec, dtype=torch.bfloat16,
                                 hardware="pin/hw"),
        }
        assert len(keys) == 4
        # the same key as the reference's, naming the storage dtype
        rq = RE.quantize_spec(RE.matmul_spec(128, 128, 128), fmt=fmt)
        assert port_cache.cache_key(qspec, dtype=store, hardware="pin/hw") \
            == ref_cache_key(rq, dtype=np.dtype(meta.dtype),
                             hardware="pin/hw")
        assert port_cache.dtype_name(store) == meta.dtype
        assert port_cache.dtype_itemsize(store) == 1

    def test_quant_key_derivation_is_stable(self):
        a = port_cache.cache_key(
            PE.quantized_matmul_spec(64, 64, 64, fmt="int8"),
            dtype=torch.int8, hardware="pin/hw")
        b = port_cache.cache_key(
            PE.quantize_spec(PE.matmul_spec(64, 64, 64), fmt="int8"),
            dtype=torch.int8, hardware="pin/hw")
        assert a == b
        assert a != port_cache.cache_key(
            PE.quantized_matmul_spec(64, 64, 64, fmt="int8",
                                     scale="per_tensor"),
            dtype=torch.int8, hardware="pin/hw")

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_tuned_quant_schedules_equal_the_references(self, fmt):
        from repro.codegen.tune import tune_schedule as ref_tune

        for m, k, n in ((128, 128, 128), (2048, 4096, 12288)):
            r = RE.quantized_matmul_spec(m, k, n, fmt)
            p = PE.quantized_matmul_spec(m, k, n, fmt)
            rt = ref_tune(r, dtype=np.dtype(PE.QUANT_FORMATS[fmt].dtype))
            pt = port_codegen.tune_schedule(p, dtype=STORE[fmt][0])
            assert port_cache.schedule_to_dict(pt) == \
                ref_schedule_to_dict(rt)


class TestFusedRefusals:
    def test_fused_kernels_take_no_epilogue(self):
        spec = PE.attention_spec(2, 8, 8, 4)
        with pytest.raises(NotImplementedError,
                           match="^fused kernels take no epilogue$"):
            port_codegen.compile(spec, port_codegen.default_schedule(spec),
                                 epilogue=port_codegen.Epilogue(dequant=True))

    def test_fused_families_have_no_mesh_tier(self):
        spec = PE.grouped_matmul_spec((2, 3), 4, 4)
        with pytest.raises(NotImplementedError,
                           match="^fused families have no mesh tier yet$"):
            port_codegen.compile(spec, port_codegen.default_schedule(spec),
                                 mesh=object())


# --------------------------------------------------------------------------
# the dequant epilogue and the output dtype
# --------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["id", "relu", "gelu", "tanh", "silu"])
@pytest.mark.parametrize("stages", ["dequant", "dequant+scale+bias",
                                    "dequant+norm", "dequant+all"])
def test_dequant_epilogue_matches_reference(stages, act):
    kw = {"dequant": True}
    if "scale" in stages or "all" in stages:
        kw["scale"] = True
    if "bias" in stages or "all" in stages:
        kw["bias"] = True
    if "norm" in stages or "all" in stages:
        kw["norm"] = True
    ref = ref_codegen.Epilogue(act=act, **kw)
    port = port_codegen.Epilogue(act=act, **kw)
    assert port.vector_names == ref.vector_names
    assert port.vector_names[0] == "qscale"
    rng = np.random.default_rng(740)
    acc = rng.integers(-5000, 5000, (6, 10)).astype(np.int32)
    vecs = {"qscale": rng.random(10) / 50, "scale": rng.standard_normal(10),
            "bias": rng.standard_normal(10),
            "mean": rng.standard_normal(10) * 0.1,
            "var": rng.random(10) + 0.5}
    vecs = {k: v.astype(np.float32).reshape(1, -1) for k, v in vecs.items()
            if k in ref.vector_names}
    want = ref.apply(jnp.asarray(acc), {k: jnp.asarray(v)
                                        for k, v in vecs.items()})
    got = port.apply(torch.from_numpy(acc), {k: torch.from_numpy(v)
                                             for k, v in vecs.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f64(got), np.asarray(want, np.float64),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("epi", ["none", "dequant", "dequant+gelu",
                                 "relu"])
def test_quantized_kernel_matches_reference_kernel(fmt, epi):
    """codegen.compile of a quantized spec, with and without epilogues: the
    port's output dtype and values are the reference kernel's."""
    m, d, f = 8, 12, 6
    spec_r = RE.quantized_matmul_spec(m, d, f, fmt)
    spec_p = PE.quantized_matmul_spec(m, d, f, fmt)
    arrays = reference_arrays(spec_r, dtype=np.dtype(PE.QUANT_FORMATS[fmt]
                                                     .dtype), seed=5)
    kw = {"none": None, "dequant": dict(dequant=True),
          "dequant+gelu": dict(dequant=True, act="gelu", bias=True),
          "relu": dict(act="relu")}[epi]
    rng = np.random.default_rng(741)
    vecs = {"qscale": (rng.random(f) / 20).astype(np.float32),
            "bias": rng.standard_normal(f).astype(np.float32)}
    r_epi = None if kw is None else ref_codegen.Epilogue(**kw)
    p_epi = None if kw is None else port_codegen.Epilogue(**kw)
    names = r_epi.vector_names if r_epi else ()
    sched_r = candidate_schedule(spec_r, tuple(spec_r.indices),
                                 dict(spec_r.extents))
    rk = ref_codegen.compile(spec_r, sched_r, epilogue=r_epi, interpret=True)
    want = np.asarray(rk(*(jnp.asarray(arrays[n]) for n in spec_r.operands),
                         **{k: jnp.asarray(vecs[k]) for k in names}))
    pk = port_codegen.compile(spec_p, port_codegen.default_schedule(spec_p),
                              epilogue=p_epi)
    got = pk(*(_to_torch(arrays[n]) for n in spec_p.operands),
             **{k: torch.from_numpy(vecs[k]) for k in names})
    assert port_cache.dtype_name(got.dtype) == str(want.dtype)
    if want.dtype == np.int32:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close_scaled(got, want, 1e-5)


def test_explicit_out_dtype_wins():
    spec = PE.quantized_matmul_spec(4, 6, 8, "int8")
    kern = port_codegen.compile(spec, port_codegen.default_schedule(spec),
                                out_dtype=torch.float32)
    a = torch.ones(4, 6, dtype=torch.int8)
    b = torch.ones(6, 8, dtype=torch.int8)
    out = kern(a, b)
    assert out.dtype == torch.float32 and bool((out == 6).all())


# --------------------------------------------------------------------------
# ops.dense(quant=)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_ops_dense_quant_kernel_path(fmt):
    rng = np.random.default_rng(13000)
    x = rng.standard_normal((128, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 128)) / 8).astype(np.float32)
    got = port_ops.dense(torch.from_numpy(x), torch.from_numpy(w), quant=fmt,
                         interpret=True)
    assert got.shape == (128, 128) and got.dtype == torch.float32
    qx, sx = RQ.quantize_tensor(jnp.asarray(x), fmt)
    qw, sw = RQ.quantize_channels(jnp.asarray(w), fmt)
    ref = (np.asarray(qx, np.float64) * float(sx)) @ (
        np.asarray(qw, np.float64) * np.asarray(sw, np.float64)[None, :])
    _close_scaled(got, ref, 1e-5, "dense(quant) kernel path vs oracle")
    want = ref_ops.dense(jnp.asarray(x), jnp.asarray(w), quant=fmt,
                         interpret=True)
    _close_scaled(got, want, 1e-5, "dense(quant) vs the reference")
    full = x.astype(np.float64) @ w.astype(np.float64)
    rel = np.abs(_f64(got) - full).max() / max(np.abs(full).max(), 1.0)
    assert rel < (0.05 if fmt == "int8" else 0.1)


def test_ops_dense_quant_fallback_odd_shapes():
    rng = np.random.default_rng(13100)
    x = rng.standard_normal((3, 5, 60)).astype(np.float32)
    w = rng.standard_normal((60, 7)).astype(np.float32)
    got = port_ops.dense(torch.from_numpy(x), torch.from_numpy(w),
                         quant="int8")
    assert got.shape == (3, 5, 7)
    want = ref_ops.dense(jnp.asarray(x), jnp.asarray(w), quant="int8")
    np.testing.assert_allclose(_f64(got), np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-5)


def test_ops_dense_quant_empty_batch_and_unknown_format():
    out = port_ops.dense(torch.zeros(0, 16), torch.ones(16, 8), quant="int8")
    assert out.shape == (0, 8) and out.dtype == torch.float32
    out = port_ops.dense(torch.zeros(0, 128), torch.ones(128, 128),
                         quant="fp8", interpret=True)
    assert out.shape == (0, 128)
    with pytest.raises(ValueError, match="int4"):
        port_ops.dense(torch.ones(4, 4), torch.ones(4, 4), quant="int4")


def test_ops_dense_quant_kernel_path_has_no_silent_gradient():
    x = torch.randn(128, 128, requires_grad=True)
    w = torch.randn(128, 128)
    out = port_ops.dense(x, w, quant="int8", interpret=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        out.sum().backward()
    with torch.no_grad():
        assert port_ops.dense(x, w, quant="int8",
                              interpret=True).grad_fn is None


@pytest.mark.parametrize("fmt", FORMATS)
def test_ops_dense_quant_takes_the_tuned_quant_spec(fmt, monkeypatch):
    seen = []
    real = port_ops._tuned_kernel

    def spy(spec, dtype, **kw):
        seen.append((spec, dtype, kw))
        return real(spec, dtype, **kw)

    monkeypatch.setattr(port_ops, "_tuned_kernel", spy)
    port_ops.dense(torch.randn(128, 256), torch.randn(256, 128), quant=fmt,
                   interpret=True)
    ((spec, dtype, kw),) = seen
    assert spec == PE.quantized_matmul_spec(128, 256, 128, fmt)
    assert dtype == STORE[fmt][0]
    assert kw["epilogue"] == port_codegen.Epilogue(dequant=True)
    assert kw["out_dtype"] == torch.float32


# --------------------------------------------------------------------------
# the quantized rows of tests/test_differential.py
# --------------------------------------------------------------------------


def _draw(family, seed):
    ctor, arity, offset = FAMILIES[family]
    rng = np.random.default_rng(offset + seed)
    extents = [int(rng.choice(EXTENT_POOL)) for _ in range(arity)]
    return getattr(RE, ctor)(*extents), getattr(PE, ctor)(*extents)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("seed", QUANT_SEEDS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generated_kernel_quantized(family, seed, fmt):
    """The port's generated kernel over int8/fp8 storage against the f64
    einsum over the dequantized values: exactly for int8, at 1e-4 of
    max(|ref|, 1) for fp8; and the raw result dtype of the reference."""
    ref_base, port_base = _draw(family, seed)
    spec_r = RE.quantize_spec(ref_base, fmt=fmt)
    spec_p = PE.quantize_spec(port_base, fmt=fmt)
    arrays = reference_arrays(spec_r, dtype=np.dtype(
        PE.QUANT_FORMATS[fmt].dtype), seed=seed)
    want = einsum_reference(spec_r, arrays)
    kern = port_codegen.compile(spec_p, port_codegen.default_schedule(spec_p))
    got = kern(*(_to_torch(arrays[n]) for n in spec_p.operands))
    if fmt == "int8":
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy().astype(np.float64), want)
    else:
        assert got.dtype == torch.float32
        _close_scaled(got, want, 1e-4, f"{family} seed={seed}")


def test_odd_extent_kernel_exact_small_ints():
    spec_r = RE.quantized_matmul_spec(3, 7, 5, fmt="int8")
    spec_p = PE.quantized_matmul_spec(3, 7, 5, fmt="int8")
    arrays = reference_arrays(spec_r, dtype=np.int8, seed=5)
    kern = port_codegen.compile(spec_p, port_codegen.default_schedule(spec_p))
    out = kern(*(torch.from_numpy(arrays[n]) for n in spec_p.operands))
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), einsum_reference(spec_r, arrays)
                          .astype(np.int64))


def test_int32_accumulation_is_exact_past_2_to_the_24():
    """At the MLP's widths an int8 product's sums pass 2**24, where f32
    stops holding integers: the plain version sums exactly (int64), then
    wraps to int32 as the kernel and the reference do."""
    k = 4096
    a = torch.full((2, k), 127, dtype=torch.int8)
    b = torch.full((k, 3), 127, dtype=torch.int8)
    b[0, 0] = 126
    spec = PE.quantized_matmul_spec(2, k, 3, "int8")
    out = cuda_gen.contract_ref(spec, a, b, out_dtype=torch.int32)
    assert int(out[0, 1]) == 127 * 127 * k
    assert int(out[0, 0]) == 127 * 127 * k - 127
    big = torch.full((1, 300000), 127, dtype=torch.int8)
    col = torch.full((300000, 1), 127, dtype=torch.int8)
    wrap = cuda_gen.contract_ref(PE.quantized_matmul_spec(1, 300000, 1,
                                                          "int8"),
                                 big, col, out_dtype=torch.int32)
    assert int(wrap) == np.int64(127 * 127 * 300000).astype(np.int32)


# --------------------------------------------------------------------------
# _launch_cuda's folding of the 8-bit modes, against an emulation
# --------------------------------------------------------------------------


def _emulated_8bit(record, name):
    """contract_q8.cu's arithmetic on CPU tensors: operands upcast to the
    accumulator (int64 standing in for int32's exact sums), vectors
    indexed as (coord // div) % len, the epilogue on the f32 accumulator.
    On the tensor cores an int8 k-scale runs as the ring does: A's byte
    planes (``modes.int8_planes``), 256 H.B + L.B wrapped to int32; the
    modes the ring alone takes (k-scale, multiplier, row reduce) are
    recorded with the body they need, ``name + "/ring"``."""
    from repro_torch.codegen import modes

    def run(a, b, out_dtype, *, int_acc, kscale=None, mul=None,
            epilogue=None, vectors=None, t=None):
        tc = name != "CONTRACT_UPCAST"
        fused = kscale is not None or mul is not None or t is not None
        record.append(name + ("/ring" if tc and fused else ""))
        if tc and fused:
            # the ring's rule: both operands K-major as TMA reads them
            assert modes.q8_ring_refusal(a, b, kscale) is None, (
                a.stride(), b.stride())
        batch, m, k = a.shape
        n = b.shape[2]
        coords = (torch.arange(batch), torch.arange(m), torch.arange(n),
                  torch.arange(k))
        shape = {0: (batch, 1, 1), 1: (1, m, 1), 2: (1, 1, n)}
        wide = torch.int64 if int_acc else torch.float32

        def at(vec, dtype=wide):
            x = vec.tensor
            return x[(coords[vec.axis] // vec.div) % x.numel()].to(dtype)

        if tc and kscale is not None:
            assert kscale.tensor.dtype == torch.int8
            h, low = modes.int8_planes(a[0], kscale.tensor).to(wide)
            bw = b[0].to(wide)
            acc = (256 * (h @ bw) + low @ bw)[None]
        else:
            af = a.to(wide)
            if kscale is not None:
                af = af * at(kscale)[None, None, :]
            acc = torch.bmm(af, b.to(wide))
        if int_acc:  # the kernel's int32 sums wrap
            acc = acc.to(torch.int32).to(wide)
        if t is not None:
            s = (acc[0] * t.to(wide)).sum(0)
            return (s.to(torch.int32) if int_acc else s).to(out_dtype)
        if mul is not None:
            acc = acc * at(mul).reshape(shape[mul.axis])
        if int_acc:
            acc = acc.to(torch.int32)
        if epilogue is not None:
            acc = epilogue.apply(acc.float(), {
                nm: at(v, torch.float32).reshape(shape[v.axis])
                for nm, v in vectors.items()})
        return acc.to(out_dtype)

    return run


def _emulated_bf16(record):
    """contract.cu's bf16 k-scale ring on CPU tensors (the fp8 family's
    forward over exact bf16 upcasts), recorded as ``"CONTRACT"``."""
    from test_torch_fused import _emulated_contract

    def run(a, b, out_dtype, **kw):
        record.append("CONTRACT")
        assert a.dtype == b.dtype == kw["kscale"].tensor.dtype == (
            torch.bfloat16)
        assert cuda_gen.contract_body(a, b, plain=False,
                                      kscale=kw["kscale"]) == "ring"
        return _emulated_contract(a, b, out_dtype, **kw)

    return run


#: a weighted family the 8-bit rings take: every M >= 64, every K a
#: multiple of 16 and, for fp8's ring, at least FP8_RING_MIN_K (384)
RING_WEIGHTED = (384, 80, 400)


def _weighted_family(extents):
    w = PE.weighted_matmul_spec(*extents)
    return (w, *port_grad.derived_specs(w).values())


#: the launcher each of the weighted family's specs takes at
#: RING_WEIGHTED, by format: the forward's k-scale (int8 byte planes on
#: the ring; fp8 on contract.cu's bf16 ring), .dA / .dB (multiplier) and
#: .dg (row reduce) on the 8-bit ring
RING_ROUTES = {
    "int8": ("CONTRACT_INT8/ring",) * 4,
    "fp8": ("CONTRACT",) + ("CONTRACT_FP8/ring",) * 3,
}


@pytest.mark.parametrize("fmt", FORMATS)
def test_launch_folding_of_8bit_modes_against_an_emulation(monkeypatch, fmt):
    """Every 8-bit route of ``_launch_cuda``: two-operand products of every
    family on the tensor-core launcher; the weighted family (and its
    derived specs) on the rings where every operand is 8-bit and the
    shapes allow it (``RING_ROUTES``), on the upcast launcher at M < 64;
    a one-sided reduce on the upcast launcher; with and without the
    dequant epilogue, each gives ``contract_ref``'s values."""
    record = []
    for name in ("CONTRACT_INT8", "CONTRACT_FP8", "CONTRACT_UPCAST"):
        monkeypatch.setattr(cuda_gen, name, _emulated_8bit(record, name))
    monkeypatch.setattr(cuda_gen, "CONTRACT", _emulated_bf16(record))
    store = STORE[fmt][0]
    cases = [
        (PE.matmul_spec(6, 9, 4), None, "CONTRACT_INT8"),
        (PE.matvec_spec(6, 9), None, "CONTRACT_INT8"),
        (PE.batched_matmul_spec(3, 5, 4, 2), None, "CONTRACT_INT8"),
        (PE.transposed_matmul_spec(6, 9, 4), None, "CONTRACT_INT8"),
        (PE.matmul_spec(6, 9, 4), port_codegen.Epilogue(
            dequant=True, act="gelu", bias=True), "CONTRACT_INT8"),
        (PE.ContractionSpec(name="bt", operands={"A": ("b", "i", "j"),
                                                 "B": ("b", "j", "k")},
                            output=("k", "i", "b"),
                            extents={"b": 3, "i": 5, "j": 4, "k": 2}),
         port_codegen.Epilogue(dequant=True, scale=True), "CONTRACT_INT8"),
        (PE.ContractionSpec(name="one_side", operands={"A": ("i", "j", "r"),
                                                       "B": ("j", "k")},
                            output=("i", "k"),
                            extents={"i": 4, "j": 5, "r": 3, "k": 6}),
         None, "CONTRACT_UPCAST"),
    ] + [(s, None, "CONTRACT_UPCAST")
         for s in _weighted_family((7, 10, 5))] + [
        (s, None, route) for s, route in zip(
            _weighted_family(RING_WEIGHTED), RING_ROUTES[fmt])]
    rng = np.random.default_rng(750)
    for base, epi, launcher in cases:
        if fmt == "fp8" and launcher == "CONTRACT_INT8":
            launcher = "CONTRACT_FP8"
        spec = PE.quantize_spec(base, fmt=fmt)
        arrays = []
        for axes in spec.operands.values():
            v = rng.standard_normal([spec.extents[i] for i in axes]) * 4
            arrays.append(torch.from_numpy(np.clip(np.round(v), -127, 127))
                          .to(store) if fmt == "int8"
                          else torch.from_numpy(v.astype(np.float32))
                          .to(store))
        vecs = {}
        if epi is not None:
            n = spec.extents[spec.output[-1]]
            vecs = {nm: torch.rand(n) for nm in epi.vector_names}
        out_dtype = cuda_gen._default_out_dtype(spec, epi, store)
        record.clear()
        got = cuda_gen._launch_cuda(spec, *arrays, out_dtype=out_dtype,
                                    epilogue=epi, vectors=vecs)
        assert record == [launcher], (spec.name, record)
        want = cuda_gen.contract_ref(spec, *arrays, out_dtype=out_dtype,
                                     epilogue=epi, vectors=vecs)
        assert got.shape == want.shape and got.dtype == want.dtype
        if want.dtype == torch.int32:
            assert torch.equal(got, want), spec.name
        else:
            _close_scaled(got, want, 1e-5, spec.name)


# --------------------------------------------------------------------------
# the weighted family's 8-bit routes: the arithmetic they rest on
# --------------------------------------------------------------------------


def test_int8_planes_split_every_product_exactly():
    """Over all 256 x 256 int8 pairs (a, g): H and L are int8, 256 H + L
    == a g; and at a small shape with the extremes in it, 256 H.B + L.B
    equals (A g).B modulo 2^32, the reference's int32 sums (in numpy)."""
    from repro_torch.codegen import modes

    vals = np.arange(-128, 128, dtype=np.int8)
    a = np.repeat(vals[:, None], 256, axis=1)  # a[i, k] = vals[i]
    planes = modes.int8_planes(torch.from_numpy(a),
                               torch.from_numpy(vals)).numpy()
    assert planes.dtype == np.int8 and planes.shape == (2, 256, 256)
    h, low = planes.astype(np.int64)
    assert np.array_equal(256 * h + low,
                          a.astype(np.int64) * vals.astype(np.int64))
    assert h.min() == -63 and h.max() == 64
    assert low.min() == -128 and low.max() == 127
    rng = np.random.default_rng(23)
    m, k, n = 5, 300, 7
    A = rng.integers(-128, 128, (m, k)).astype(np.int8)
    B = rng.integers(-128, 128, (k, n)).astype(np.int8)
    g = rng.integers(-128, 128, (k,)).astype(np.int8)
    A[0], B[:, 0], g[:] = -128, -128, np.where(g < 0, -128, 127)
    h, low = modes.int8_planes(torch.from_numpy(A),
                               torch.from_numpy(g)).numpy().astype(np.int64)
    b64 = B.astype(np.int64)
    got = (256 * (h @ b64) + low @ b64).astype(np.int32)
    want = ((A.astype(np.int64) * g.astype(np.int64)) @ b64).astype(np.int32)
    assert np.array_equal(got, want)
    assert np.abs(want.astype(np.int64)).max() > 2**24  # past f32's ints
    with pytest.raises(TypeError, match="int8"):
        modes.int8_planes(torch.from_numpy(A).int(), torch.from_numpy(g))


def test_every_e4m3_product_is_exact_in_bf16():
    """All 2^16 pairs of e4m3 values (NaN aside): the bf16 upcasts are
    exact, and a * g rounded to bf16 is the exact product (at most 8
    significant bits, exponents well inside bf16's), so fp8's k-scale on
    the bf16 ring sums the values the reference's f32 upcasts do."""
    bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    vals = bits.view(torch.float8_e4m3fn).float()
    vals = vals[~torch.isnan(vals)]
    assert vals.numel() == 254
    assert torch.equal(vals.bfloat16().float(), vals)
    prod = vals[:, None] * vals[None, :]  # exact in f32 (8 x 8 bits)
    assert torch.equal(prod.bfloat16().float(), prod)
    scaled = (vals.bfloat16()[:, None] * vals.bfloat16()[None, :]).float()
    assert torch.equal(scaled, prod)


@pytest.mark.parametrize("case", ["int32 g", "M < 64", "mixed operand",
                                  "fp8 short K", "int8 K not 16-aligned"])
def test_weighted_family_routes_that_stay_on_the_upcast_body(case):
    """``eight_bit_route`` keeps the upcast body where the rings cannot
    take the operands: an int32 g (not 8-bit), M < 64, an int32 operand
    (a one-sided reduce's sum), an fp8 K below FP8_RING_MIN_K, an int8
    K whose K-major copy TMA cannot read (rows not 16 bytes apart)."""
    i8, f8 = torch.int8, torch.float8_e4m3fn
    m, k, n, dt, g_dt = 128, 64, 96, i8, i8
    if case == "M < 64":
        m = 63
    elif case == "fp8 short K":
        k, dt, g_dt = 128, f8, f8
    elif case == "int8 K not 16-aligned":
        k = 72
    elif case == "int32 g":
        g_dt = torch.int32
    a3 = torch.zeros(1, m, k, dtype=dt)
    b3 = torch.zeros(n, k, dtype=dt).t()[None]  # K-major
    if case == "mixed operand":
        a3 = a3.int()
    int_acc = dt == i8
    g = torch.zeros(n, dtype=g_dt)
    assert cuda_gen.eight_bit_route("vector", a3, b3, g,
                                    int_acc=int_acc) == "upcast"
    t = torch.zeros(m, n, dtype=g_dt)
    assert cuda_gen.eight_bit_route("row_reduce", a3, b3, t,
                                    int_acc=int_acc) == "upcast"
    # the k-scale (g on k) of the forward
    gk = port_codegen.modes.VecArg(torch.zeros(k, dtype=g_dt), 3)
    assert cuda_gen.eight_bit_route("vector", a3, b3, gk.tensor, gk,
                                    int_acc=int_acc) == (
        "bf16" if case == "fp8 short K" else "upcast")


@pytest.mark.parametrize("case,why", [
    ("k-scale", None), ("multiplier", None), ("int32 g", "int8 planes"),
    ("batch 2", "int8 planes"), ("g on n", "int8 planes"),
    ("n-major B", "mma body"), ("M < 64", "mma body"),
])
def test_q8_ring_refusal_is_the_rule_route_and_launcher_share(case, why):
    """``modes.q8_ring_refusal``: None where the 8-bit ring takes the
    product with its k-scale or multiplier, else why not; and
    ``eight_bit_route`` sends the product to the tensor cores exactly
    where it finds nothing once B is K-major (the route copies an n-major
    B; the launcher raises with the same reason)."""
    modes = port_codegen.modes
    batch, m, k, n = 1, 128, 64, 96
    if case == "batch 2":
        batch = 2
    elif case == "M < 64":
        m = 63
    a = torch.zeros(batch, m, k, dtype=torch.int8)
    b = torch.zeros(batch, n, k, dtype=torch.int8).transpose(1, 2)
    if case == "n-major B":
        b = b.contiguous()
    g = torch.zeros(n if case == "g on n" else k,
                    dtype=torch.int32 if case == "int32 g" else torch.int8)
    kscale = None if case == "multiplier" else modes.VecArg(g, 3)
    got = modes.q8_ring_refusal(a, b, kscale)
    if why is None:
        assert got is None
    else:
        assert why in got, got
    if batch == 1 and case != "g on n":
        route = cuda_gen.eight_bit_route(
            "vector", a, b, g, kscale, int_acc=True)
        assert (route == "tensor cores") == (
            why is None or case == "n-major B"), route


def test_weighted_family_routes_at_the_main_shape():
    """At the fused path's M = 2048, D = 4096, F = 12288 (meta tensors: no
    data), every spec of the 8-bit weighted family takes its ring: the
    vector and row-reduce modes on the 8-bit ring (transposed operands
    K-major after copies), fp8's forward on the bf16 ring."""
    m, d, f = 2048, 4096, 12288
    for fmt, dt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        int_acc = fmt == "int8"
        meta = dict(dtype=dt, device="meta")
        x = torch.empty(m, d, **meta)      # A (i, j)
        w = torch.empty(d, f, **meta)      # B (j, k)
        dout = torch.empty(m, f, **meta)   # (i, k)
        g = torch.empty(d, **meta)
        gk = port_codegen.modes.VecArg(g, 3)
        route = lambda *a, **kw: cuda_gen.eight_bit_route(  # noqa: E731
            *a, int_acc=int_acc, **kw)
        assert route("vector", x[None], w[None], g, gk) == (
            "tensor cores" if int_acc else "bf16")
        # .dA: dout (i, k) @ B^T (k, j), g on n
        assert route("vector", dout[None], w.t()[None], g) == "tensor cores"
        # .dB: A^T (j, i) @ dout (i, k), g on m: both need K-major copies
        assert route("vector", x.t()[None], dout[None], g) == "tensor cores"
        # .dg: dout @ B^T into (i, j), T = A
        assert route("row_reduce", dout[None], w.t()[None], x) == (
            "tensor cores")
        a_copy = cuda_gen._kmajor(x.t()[None], 2, meta=True)
        b_copy = cuda_gen._kmajor(dout[None], 1, meta=True)
        assert a_copy.stride() == (m * d, m, 1)
        assert b_copy.stride() == (m * f, 1, m)
        assert cuda_gen._kmajor(dout[None], 2, meta=True).shape == (1, m, f)


def test_dequant_epilogue_on_f32_operands_rides_the_multiplier(monkeypatch):
    """contract.cu has no qscale stage: a dequant epilogue on an f32 spec
    goes in as its multiplier vector, which its epilogue applies first."""
    from test_torch_fused import _emulated_contract

    seen = {}

    def spy(a, b, out_dtype, **kw):
        seen.update(kw)
        return _emulated_contract(a, b, out_dtype, **kw)

    monkeypatch.setattr(cuda_gen, "CONTRACT", spy)
    spec = PE.matmul_spec(6, 9, 4)
    epi = port_codegen.Epilogue(dequant=True, bias=True, act="tanh")
    a, b = torch.randn(6, 9), torch.randn(9, 4)
    vecs = {"qscale": torch.rand(4), "bias": torch.randn(4)}
    got = cuda_gen._launch_cuda(spec, a, b, out_dtype=torch.float32,
                                epilogue=epi, vectors=vecs)
    assert seen["mul"] is not None and "qscale" not in seen["vectors"]
    want = cuda_gen.contract_ref(spec, a, b, out_dtype=torch.float32,
                                 epilogue=epi, vectors=vecs)
    _close_scaled(got, want, 1e-6)


# --------------------------------------------------------------------------
# weight-only serving
# --------------------------------------------------------------------------


def test_weight_only_tree_of_the_model_is_the_references():
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.models import transformer as PT

    from test_torch_model import reference_params

    ref_cfg = ref_get_config("qwen3-8b").smoke()
    port_cfg = port_get_config("qwen3-8b").smoke()
    ref_params, np_params = reference_params(ref_cfg, seed=3)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    rtree = RQ.quantize_tree(ref_params, min_size=64)
    ptree = PQ.quantize_tree(port_params, min_size=64)
    assert PQ.tree_quant_bytes(ptree) == RQ.tree_quant_bytes(rtree) > 0
    wq_r = rtree["seg0"]["dense"]["attn"]["wq"]
    wq_p = ptree["seg0"]["dense"]["attn"]["wq"]
    np.testing.assert_array_equal(wq_p.q.numpy(), np.asarray(wq_r.q))
    np.testing.assert_array_equal(wq_p.scale.numpy(), np.asarray(wq_r.scale))
    back = PQ.dequantize_tree(ptree)["seg0"]["dense"]["attn"]["wq"]
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(RQ.dequantize_tree(rtree)["seg0"]["dense"]["attn"]["wq"]))


@pytest.mark.parametrize("shape,dtype", [
    ((3, 5, 7), torch.float32),      # layers straddle blocks
    ((2, 300), torch.bfloat16),      # a partial last block
    ((4, 64, 64), torch.bfloat16),   # whole blocks per layer
    ((5, 1, 3), torch.float32),      # all layers inside one block
])
def test_quantized_layers_are_slices_of_the_whole_expansion(shape, dtype):
    """``QuantizedLayers`` expands one layer of a stacked leaf: the same
    bits as ``dequantize`` of the whole leaf, sliced."""
    rng = np.random.default_rng(740)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    qv = PQ.quantize(x.to(dtype))
    whole = PQ.dequantize(qv)
    layers = PQ.QuantizedLayers(qv)
    assert len(layers) == shape[0]
    for i in range(shape[0]):
        got = layers[i]
        assert got.dtype == dtype and got.shape == shape[1:]
        assert torch.equal(got, whole[i])
    with pytest.raises(IndexError):
        layers[shape[0]]


@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b"])
def test_layer_by_layer_expansion_gives_the_whole_trees_logits(arch,
                                                               monkeypatch):
    """The serving runners' expansion (embedding now, each stacked layer
    inside the layer loop) against the whole tree expanded up front:
    prefill and decode logits bit for bit, in bf16."""
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.launch.serving.runners import _deq_fn
    from repro_torch.models import transformer as PT

    monkeypatch.setenv("REPRO_MOE_GROUPED", "1")
    cfg = port_get_config(arch).smoke()
    params = PT.init(cfg, torch.Generator().manual_seed(5), "cpu")
    tree = PQ.quantize_tree(params, min_size=64)
    lazy = _deq_fn("int8")(tree)
    held = [t for k, v in lazy.items() if k.startswith("seg")
            for t in PQ._leaves(v) if isinstance(t, PQ.Quantized)]
    assert held and not any(isinstance(t, PQ.Quantized) for t in
                            PQ._leaves(lazy["embedding"]))
    full = PQ.dequantize_tree(tree)
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        got, got_c = PT.prefill(lazy, cfg, tokens, 12)
        want, want_c = PT.prefill(full, cfg, tokens, 12)
        assert torch.equal(got, want)
        nxt = want[:, -1].argmax(-1)[:, None]
        got, _ = PT.decode_step(lazy, cfg, got_c, nxt)
        want, _ = PT.decode_step(full, cfg, want_c, nxt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b"])
def test_int8_serving_tokens_match_reference(arch, monkeypatch):
    """A smoke config (dense; MoE with its experts grouped) served with
    ``quant="int8"`` by both engines from the same weights and trace, in
    f32: greedy tokens equal, and the ``serve.quant_bytes`` gauge is the
    tree's bytes."""
    from repro.configs import get_config as ref_get_config
    from repro.launch.serving import ContinuousEngine as RefEngine
    from repro.launch.serving import synthetic_trace as ref_trace
    from repro_torch import obs
    from repro_torch.configs import get_config as port_get_config
    from repro_torch.launch.serving import ContinuousEngine, synthetic_trace
    from repro_torch.models import transformer as PT

    from test_torch_model import reference_params

    monkeypatch.setenv("REPRO_MOE_GROUPED", "1")
    ref_cfg = dataclasses.replace(ref_get_config(arch).smoke(),
                                  dtype="float32")
    port_cfg = dataclasses.replace(port_get_config(arch).smoke(),
                                   dtype="float32")
    ref_params, np_params = reference_params(ref_cfg, seed=4)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    kw = dict(vocab=ref_cfg.vocab, seed=12, rate_hz=0.0,
              prompt_lens=(5, 11), max_news=(3, 6))
    r_trace, p_trace = ref_trace(3, **kw), synthetic_trace(3, **kw)
    eng_kw = dict(lanes=2, page_size=4, n_pages=16, max_ctx=24)
    RefEngine(ref_cfg, params=ref_params, quant="int8", **eng_kw).run(r_trace)
    obs.metrics_reset()
    eng = ContinuousEngine(port_cfg, params=port_params, device="cpu",
                           quant="int8", **eng_kw)
    eng.run(p_trace)
    assert obs.metrics_json()["gauges"]["serve.quant_bytes"] == \
        PQ.tree_quant_bytes(eng.params) > 0
    for a, b in zip(r_trace, p_trace):
        assert len(b.out_tokens) == b.max_new
        assert b.out_tokens == a.out_tokens, b.rid
