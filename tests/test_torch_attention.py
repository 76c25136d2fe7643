"""The port's fused attention (kernel B2's path) against the reference.

Inputs are made with numpy from a seed and handed to both packages; the
reference runs its Pallas kernel in interpret mode (or its plain jnp
version), the port its kernel's plain version (CPU tensors, ``interpret``)
or its plain softmax.  Tolerances are the reference's
``tests/test_attention_kernels.py``: outputs scaled by max(|ref|, 1), f32
(1e-4, 1e-4), bf16 (6e-2, 6e-2); cotangents 1e-3 (f32).

* ``ops.attention`` forward over that file's grid (head dims x (q_seq,
  kv_seq) x full/causal x f32/bf16), on the kernel path and the plain one;
* ``kv_lengths`` with a 0 entry: exact zeros in that head;
* the three cotangents against ``jax.vjp`` of the reference's
  ``ops.attention`` and of a pure-jnp softmax, with and without
  ``kv_lengths``;
* ``codegen.compile(attention_spec, schedule)`` on CPU tensors against the
  reference's interpret-mode kernel over drawn legal schedules, with and
  without ``kv_lengths``;
* tuned schedules, cache keys and plan keys of ``AttentionSpec`` and its
  derived specs equal to the reference's;
* the refusals and the dispatch (forward on the fused spec, backward on
  ``attention.dQ/.dK/.dV``).

Kernel B2 itself runs on the card: ``tests/test_torch_gpu.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codegen.cache as ref_cache
import repro.core.enumerate as RE
import repro_torch.codegen.cache as port_cache
import repro_torch.core.enumerate as PE
from repro import codegen as ref_codegen
from repro import grad as ref_grad
from repro import ops as ref_ops
from repro.core.cost import TPU as REF_TPU
from repro.search import candidate_schedule, reference_arrays
from repro.search.plandb import plan_key as ref_plan_key
from repro_torch import codegen as port_codegen
from repro_torch import grad as port_grad
from repro_torch import ops as port_ops
from repro_torch.codegen import fused_gen
from repro_torch.codegen.tune import TUNER_VERSION
from repro_torch.search.plandb import plan_key as port_plan_key

from test_torch_foundation import GOLDEN_HW, to_port_spec

HEAD_DIMS = (4, 8)
SEQS = ((8, 8), (8, 16), (16, 8))  # (q_seq, kv_seq): square + both ragged
MASKS = ("full", "causal")
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (6e-2, 6e-2)}
GRAD_TOL = 1e-3
CASES = [(d, s, t, mask) for d in HEAD_DIMS for s, t in SEQS
         for mask in MASKS]


@pytest.fixture(autouse=True)
def _isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, np.float32).astype(np.float64)


def _close(got, want, tol, what):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol[0],
                               atol=tol[1], err_msg=what)


def _qkv(rng, h, s, t, d, e=None):
    e = d if e is None else e
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((h, s, d), (h, t, d), (h, t, e))]


def _both(arrays, dtype):
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


# --------------------------------------------------------------------------
# ops.attention forward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("interpret", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,s,t,mask", CASES)
def test_ops_attention_forward_matches_reference(d, s, t, mask, dtype,
                                                 interpret):
    causal = mask == "causal"
    rng = np.random.default_rng(16000 + d * 97 + s * 13 + t * 7 + causal)
    h = int(rng.choice((1, 2, 3)))
    jx, tx = _both(_qkv(rng, h, s, t, d), dtype)
    want = ref_ops.attention(*jx, causal=causal, interpret=interpret)
    got = port_ops.attention(*tx, causal=causal, interpret=interpret)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype],
           f"ops.attention h={h} s={s} t={t} d={d} {mask} {dtype}")


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["kernel", "plain"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_attention_kv_lengths(dtype, causal, differentiable):
    """Per-head lengths [t, 3, 0]: the reference's values, and exact zeros
    in the head with no visible key.  The ids name the reference's route:
    ``differentiable=False`` reaches its kernel, a differentiable call with
    lengths its plain softmax; the port runs its kernel path both ways
    (``grad.attention_vjp`` takes the lengths)."""
    rng = np.random.default_rng(16500 + causal)
    h, s, t, d = 3, 8, 8, 4
    jx, tx = _both(_qkv(rng, h, s, t, d), dtype)
    lengths = np.asarray([t, 3, 0], np.int32)
    want = ref_ops.attention(*jx, causal=causal,
                             kv_lengths=jnp.asarray(lengths),
                             interpret=True, differentiable=differentiable)
    got = port_ops.attention(*tx, causal=causal,
                             kv_lengths=torch.from_numpy(lengths),
                             interpret=True, differentiable=differentiable)
    np.testing.assert_array_equal(_f64(got[2]), 0.0)
    _close(got, want, TOL[dtype], f"kv_lengths {dtype} causal={causal}")


# --------------------------------------------------------------------------
# the cotangents
# --------------------------------------------------------------------------


def _jnp_attention(q, k, v, causal):
    h, s, d = q.shape
    t = k.shape[1]
    sc = jnp.einsum("hsd,htd->hst", q, k,
                    preferred_element_type=jnp.float32) * d ** -0.5
    if causal:
        cols = jax.lax.broadcasted_iota(jnp.int32, (h, s, t), 2)
        rows = jax.lax.broadcasted_iota(jnp.int32, (h, s, t), 1)
        sc = jnp.where(cols <= rows, sc, -jnp.inf)
    p = jax.nn.softmax(sc, axis=-1)
    return jnp.einsum("hst,hte->hse", p, v,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 16, 8, 8),
                                   (2, 8, 16, 4)], ids=str)
def test_ops_attention_cotangents_match_jax_vjp(shape, mask):
    causal = mask == "causal"
    h, s, t, d = shape
    rng = np.random.default_rng(17000 + sum(shape) + causal)
    jx, tx = _both(_qkv(rng, h, s, t, d), "float32")
    g = rng.standard_normal((h, s, d)).astype(np.float32)
    _, rvjp = jax.vjp(lambda *a: ref_ops.attention(*a, causal=causal,
                                                   interpret=True), *jx)
    _, jvjp = jax.vjp(lambda *a: _jnp_attention(*a, causal), *jx)
    leaves = [x.clone().requires_grad_(True) for x in tx]
    out = port_ops.attention(*leaves, causal=causal, interpret=True)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, p, r, j in zip(("dQ", "dK", "dV"), grads, rvjp(jnp.asarray(g)),
                             jvjp(jnp.asarray(g))):
        for want in (r, j):
            np.testing.assert_allclose(_f64(p), _f64(want), rtol=GRAD_TOL,
                                       atol=GRAD_TOL,
                                       err_msg=f"attention {name} ({mask})")


def _jnp_masked_attention(q, k, v, causal, lengths):
    """A pure-jnp softmax under causal and per-head length masks; a row
    with no visible column gives zeros (and zero cotangents)."""
    h, s, d = q.shape
    t = k.shape[1]
    sc = jnp.einsum("hsd,htd->hst", q, k,
                    preferred_element_type=jnp.float32) * d ** -0.5
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, s, t), 2)
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, s, t), 1)
    valid = cols < jnp.asarray(lengths)[:, None, None]
    if causal:
        valid = valid & (cols <= rows)
    sc = jnp.where(valid, sc, -1e30)
    p = jnp.where(valid, jnp.exp(sc - sc.max(axis=-1, keepdims=True)), 0.0)
    p = p / jnp.maximum(p.sum(axis=-1, keepdims=True), 1e-30)
    return jnp.einsum("hst,hte->hse", p, v,
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("interpret", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("mask", MASKS)
def test_ops_attention_kv_lengths_cotangents_match_jax_vjp(mask, interpret):
    """Lengths [t, 3, 0, 6] with a gradient: the kernel route
    (``grad.attention_vjp``, the recompute masked as the forward) and the
    plain one against ``jax.vjp`` of the reference's differentiable call
    and of a pure-jnp masked softmax; the head of length 0 gets zero
    cotangents."""
    causal = mask == "causal"
    rng = np.random.default_rng(17300 + causal)
    h, s, t, d = 4, 8, 16, 4
    jx, tx = _both(_qkv(rng, h, s, t, d), "float32")
    lengths = np.asarray([t, 3, 0, 6], np.int32)
    g = rng.standard_normal((h, s, d)).astype(np.float32)
    _, rvjp = jax.vjp(lambda *a: ref_ops.attention(
        *a, causal=causal, kv_lengths=jnp.asarray(lengths), interpret=True),
        *jx)
    _, jvjp = jax.vjp(lambda *a: _jnp_masked_attention(*a, causal, lengths),
                      *jx)
    leaves = [x.clone().requires_grad_(True) for x in tx]
    out = port_ops.attention(*leaves, causal=causal,
                             kv_lengths=torch.from_numpy(lengths),
                             interpret=interpret)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, p, r, j in zip(("dQ", "dK", "dV"), grads, rvjp(jnp.asarray(g)),
                             jvjp(jnp.asarray(g))):
        assert bool(torch.isfinite(p).all()), name
        np.testing.assert_array_equal(_f64(p[2]), 0.0)
        for want in (r, j):
            np.testing.assert_allclose(_f64(p), _f64(want), rtol=GRAD_TOL,
                                       atol=GRAD_TOL,
                                       err_msg=f"attention {name} ({mask}, "
                                               f"kv_lengths)")


@pytest.mark.parametrize("mask", MASKS)
def test_ops_attention_bfloat16_cotangents(mask):
    """bf16 operands: cotangents in bf16 (cast as the reference casts them)
    within the bf16 TOL of the reference's."""
    causal = mask == "causal"
    rng = np.random.default_rng(17500 + causal)
    h, s, t, d = 2, 16, 16, 8
    jx, tx = _both(_qkv(rng, h, s, t, d), "bfloat16")
    g = rng.standard_normal((h, s, d)).astype(np.float32)
    _, rvjp = jax.vjp(lambda *a: ref_ops.attention(*a, causal=causal,
                                                   interpret=True), *jx)
    leaves = [x.clone().requires_grad_(True) for x in tx]
    out = port_ops.attention(*leaves, causal=causal, interpret=True)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).bfloat16())
    rgrads = rvjp(jnp.asarray(g, jnp.bfloat16))
    for name, p, r in zip(("dQ", "dK", "dV"), grads, rgrads):
        assert p.dtype == torch.bfloat16
        _close(p, r, TOL["bfloat16"], f"attention bf16 {name} ({mask})")


def test_attention_kernel_path_runs_the_derived_specs(monkeypatch):
    """Forward on the fused spec, backward on ``attention.dQ/.dK/.dV`` (only
    those autograd asks for), with or without lengths;
    ``differentiable=False`` detaches; the plain path stays torch ops."""
    seen = []
    real = port_ops._tuned_kernel

    def spy(spec, dtype, **kw):
        seen.append(spec.name)
        return real(spec, dtype, **kw)

    monkeypatch.setattr(port_ops, "_tuned_kernel", spy)
    q, k, v = (torch.randn(2, 8, 4, requires_grad=True) for _ in range(3))
    out = port_ops.attention(q, k, v, causal=True, interpret=True)
    assert seen == ["attention"]
    out.sum().backward()
    assert sorted(seen[1:]) == ["attention.dK", "attention.dQ",
                                "attention.dV"]
    seen.clear()
    v2 = v.detach().requires_grad_(True)
    port_ops.attention(q.detach(), k.detach(), v2,
                       interpret=True).sum().backward()
    assert seen == ["attention", "attention.dV"]
    seen.clear()
    raw = port_ops.attention(q, k, v, interpret=True, differentiable=False)
    assert raw.grad_fn is None and not raw.requires_grad
    assert seen == ["attention"]
    seen.clear()
    lengths = torch.tensor([8, 2], dtype=torch.int32)
    masked = port_ops.attention(q, k, v, kv_lengths=lengths, interpret=True)
    assert seen == ["attention"] and masked.grad_fn is not None
    masked.sum().backward()
    assert sorted(seen[1:]) == ["attention.dK", "attention.dQ",
                                "attention.dV"]
    seen.clear()
    plain = port_ops.attention(q, k, v)  # CPU, no interpret: torch ops
    assert seen == [] and plain.grad_fn is not None


# --------------------------------------------------------------------------
# codegen.compile of the fused spec over drawn schedules
# --------------------------------------------------------------------------


def _divisors(n: int):
    return [x for x in range(1, n + 1) if n % x == 0]


def _draw_schedule(spec, rng):
    """The reference test's draw: shuffled order, divisor blocks, d and e
    whole."""
    order = list(spec.indices)
    rng.shuffle(order)
    whole = set(spec.root().whole_indices)
    blocks = {i: spec.extents[i] if i in whole
              else int(rng.choice(_divisors(spec.extents[i])))
              for i in spec.indices}
    return candidate_schedule(spec, tuple(order), blocks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,s,t,mask", CASES)
def test_compiled_attention_matches_reference_kernel(d, s, t, mask, dtype):
    causal = mask == "causal"
    seed = 18000 + d * 97 + s * 13 + t * 7 + causal
    rng = np.random.default_rng(seed)
    h = int(rng.choice((1, 2, 3)))
    ref = RE.attention_spec(h, s, t, d, causal=causal)
    port = PE.attention_spec(h, s, t, d, causal=causal)
    rs = _draw_schedule(ref, rng)
    ps = port_cache.schedule_from_dict(ref_cache.schedule_to_dict(rs), port)
    arrays = reference_arrays(ref, dtype=np.float32, seed=seed)
    jx, tx = _both([arrays[n] for n in ref.operands], dtype)
    rk = ref_codegen.compile(ref, rs, interpret=True)
    pk = port_codegen.compile(port, ps)
    assert isinstance(pk, fused_gen.FusedKernel) and pk.kind == "attention"
    got = pk(*tx)
    assert got.dtype == getattr(torch, dtype)
    _close(got, rk(*jx), TOL[dtype], f"compiled attention {mask} {dtype}")
    lengths = rng.integers(0, t + 1, size=h).astype(np.int32)
    got = pk(*tx, kv_lengths=torch.from_numpy(lengths))
    _close(got, rk(*jx, kv_lengths=jnp.asarray(lengths)), TOL[dtype],
           f"compiled attention {mask} {dtype} kv_lengths {lengths}")
    for hh in np.flatnonzero(lengths == 0):
        np.testing.assert_array_equal(_f64(got[hh]), 0.0)


def test_attention_ref_masks_a_whole_leading_block():
    """Rows whose first KV positions are all masked (lengths 0 and causal
    rows beyond a short head) take the finite mask value: no NaN, and the
    rows with no valid column are exact zeros, as in the reference."""
    rng = np.random.default_rng(18500)
    h, s, t, d = 2, 12, 12, 8
    arrays = _qkv(rng, h, s, t, d)
    lengths = np.asarray([0, 5], np.int32)
    spec = RE.attention_spec(h, s, t, d, causal=True)
    rk = ref_codegen.compile(
        spec, ref_codegen.default_schedule(spec, {"h": 1, "s": 4, "t": 4,
                                                  "d": d, "e": d}),
        interpret=True)
    want = rk(*(jnp.asarray(a) for a in arrays),
              kv_lengths=jnp.asarray(lengths))
    got = fused_gen.attention_ref(
        *(torch.from_numpy(a) for a in arrays), causal=True,
        kv_lengths=torch.from_numpy(lengths), out_dtype=torch.float32)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(_f64(got[0]), 0.0)
    _close(got, want, TOL["float32"], "attention_ref, masked leading block")


# --------------------------------------------------------------------------
# schedules and keys
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_schedules_and_keys_equal_reference(dtype):
    from repro.codegen.tune import tune_schedule as ref_tune

    t_dt, np_dt = getattr(torch, dtype), np.dtype(getattr(jnp, dtype))
    extra = {"tuner": TUNER_VERSION, "keep": 3, "measured": False,
             "hw": sorted((n, v) for n, v in REF_TPU.items()
                          if isinstance(v, (int, float)))}
    pairs = []
    for args, causal in (((128, 512, 512, 128), True),
                         ((4, 100, 77, 128), False),
                         ((3, 16, 8, 8), True)):
        ref = RE.attention_spec(*args, causal=causal)
        port = PE.attention_spec(*args, causal=causal)
        assert port == to_port_spec(ref)
        pairs.append((ref, port))
        pairs += list(zip(ref_grad.derived_specs(ref).values(),
                          port_grad.derived_specs(port).values()))
    for r, p in pairs:
        rt = ref_tune(r, dtype=np_dt)
        pt = port_codegen.tune_schedule(p, dtype=t_dt)
        assert port_cache.schedule_to_dict(pt) == \
            ref_cache.schedule_to_dict(rt), p.name
        assert port_cache.cache_key(p, dtype=t_dt, hardware=GOLDEN_HW,
                                    extra=extra) == \
            ref_cache.cache_key(r, dtype=np_dt, hardware=GOLDEN_HW,
                                extra=extra), p.name
        for kw in ({}, {"phase": "prefill"}, {"phase": "decode"}):
            assert port_plan_key(p, t_dt, GOLDEN_HW, **kw) == \
                ref_plan_key(r, np_dt, GOLDEN_HW, **kw), p.name


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


def test_attention_refuses_what_the_reference_refuses():
    q = np.zeros((2, 8), np.float32)
    k = v = np.zeros((2, 8, 4), np.float32)
    with pytest.raises(ValueError) as ref_err:
        ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with pytest.raises(ValueError) as port_err:
        port_ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v))
    assert str(port_err.value) == str(ref_err.value)
    spec = PE.attention_spec(2, 8, 8, 4)
    sched = port_codegen.default_schedule(spec)
    kern = port_codegen.compile(spec, sched)
    qkv = [torch.zeros(2, 8, 4) for _ in range(3)]
    with pytest.raises(ValueError, match="kv_lengths: expected 2 entries, "
                                         "got 3"):
        kern(*qkv, kv_lengths=torch.tensor([8, 8, 8]))
    with pytest.raises(NotImplementedError, match="fused kernels take no "
                                                  "epilogue"):
        port_codegen.compile(spec, sched,
                             epilogue=port_codegen.Epilogue(act="relu"))
    with pytest.raises(NotImplementedError, match="fused families have no "
                                                  "mesh tier yet"):
        port_codegen.compile(spec, sched, mesh=object())
    grouped = PE.grouped_matmul_spec((3, 5), 4, 6)
    gk = port_codegen.compile(grouped, port_codegen.default_schedule(grouped))
    with pytest.raises(TypeError, match="only applies to attention"):
        gk(torch.zeros(8, 4), torch.zeros(2, 4, 6), kv_lengths=[1, 2])
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_codegen.ATTENTION(*qkv, False, None, torch.float32)
