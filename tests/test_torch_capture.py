"""The port's whole-model capture (``repro_torch.capture``) against the
reference's ``repro.capture``.

The reference's capture walks a jaxpr with ``jax.core.Var`` and kin, which
jax 0.9 moved to ``jax.extend.core``: the autouse fixture sets the four
names back onto ``jax.core`` for the test's duration (``monkeypatch``),
so the reference's harvest and rewrite run unchanged and serve as the
oracle.  Nothing of ``src/repro`` is edited.

* the classifier (``classify_dot_general``) against the reference's on a
  table of layouts, with ``interpret`` on and off: op, spec, extents,
  status and reason equal;
* ``einsum_dot`` against the ``dot_general`` that ``jnp.einsum`` emits;
* the conformance trio's (``demo_configs``) train reports against the
  reference's, site for site: where they part (the attention motif, which
  the reference misses on jax 0.9, and the SSM's products, which the port
  writes pairwise and row by row) the test names the difference;
* the captured trio's loss and every gradient against the reference's
  uncaptured loss and ``jax.grad`` at the reference's ``TOL`` (rtol =
  atol = 2e-5), and against the port's uncaptured;
* the reference's floors (dense >= 8, moe >= 10, ssm >= 2), every
  fallback with a reason; ``dispatch=False`` replaying bit for bit;
* plan-DB pickup after ``sweep_captured``; derived-spec keys on the
  backward; a replayed kernel launch differentiating through its op's
  autograd formula; remat regions replayed under checkpoint;
* abstract (fake-tensor) train, prefill and decode harvests equal to the
  concrete ones; ``model_gemm_specs`` dedup; the report's JSON round
  trip; ``optimize(quant="int8")`` under 0.05 of max |x @ w|.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.extend.core as jex_core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import capture as ref_capture
from repro.capture import harvest as ref_harvest
from repro.models.api import get_api as ref_get_api
from repro_torch import capture
from repro_torch import ops
from repro_torch.capture import harvest as port_harvest
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import transformer as PT
from repro_torch.models.api import get_api as port_get_api
from repro_torch.optim.adamw import leaves

#: the reference's tests/test_capture.py tolerance (f32 configs)
TOL = dict(rtol=2e-5, atol=2e-5)
B, S = capture.DEMO_BATCH, capture.DEMO_SEQ
NAMES = ("dense", "moe", "ssm")


@pytest.fixture(autouse=True)
def _shim_and_isolate(tmp_path, monkeypatch):
    """jax 0.9 keeps ``Var``, ``Literal``, ``Jaxpr`` and ``ClosedJaxpr`` in
    ``jax.extend.core``; the reference's capture reads them off
    ``jax.core``."""
    for name in ("Var", "Literal", "Jaxpr", "ClosedJaxpr"):
        monkeypatch.setattr(jax.core, name, getattr(jex_core, name),
                            raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_PLAN_DB", str(tmp_path / "plans.json"))
    monkeypatch.delenv("REPRO_INTERPRET", raising=False)
    monkeypatch.delenv("REPRO_REMAT_POLICY", raising=False)
    monkeypatch.setenv("REPRO_LOG", "quiet")


def _case(name):
    """(port cfg, ref cfg, port loss, ref loss, port params, ref params,
    port batch, ref batch): the reference's seeded init carried across."""
    rcfg = ref_capture.demo_configs()[name]
    pcfg = capture.demo_configs()[name]
    rapi, papi = ref_get_api(rcfg), port_get_api(pcfg)
    rparams, _ = rapi.init(rcfg, jax.random.key(0))
    pparams = PT.params_from_reference(
        pcfg, jax.tree.map(np.asarray, rparams), device="cpu")
    toks = np.random.default_rng(7).integers(0, rcfg.vocab, (B, S))
    rbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(toks, jnp.int32)}
    pbatch = {"tokens": torch.tensor(toks, dtype=torch.int32),
              "labels": torch.tensor(toks, dtype=torch.int32)}

    def rloss(p, b):
        return rapi.loss(p, rcfg, b)

    def ploss(p, b):
        return papi.loss(p, pcfg, b)

    return pcfg, rcfg, ploss, rloss, pparams, rparams, pbatch, rbatch


def _flat(d, prefix=()):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# the classifier and the einsum lowering, layout by layout
# ---------------------------------------------------------------------------

F32, BF16, I32 = np.float32, jnp.bfloat16, np.int32

#: (name, lhs shape, rhs shape, dimension numbers, lhs dtype, rhs dtype,
#: grouped lhs)
LAYOUTS = [
    ("dense", (128, 128), (128, 256), (((1,), (0,)), ((), ())), F32, F32,
     False),
    ("dense_unaligned", (100, 128), (128, 64), (((1,), (0,)), ((), ())),
     F32, F32, False),
    ("dense_3d", (2, 64, 128), (128, 128), (((2,), (0,)), ((), ())), BF16,
     BF16, False),
    ("transposed", (16, 8), (16, 12), (((0,), (0,)), ((), ())), F32, F32,
     False),
    ("batched", (4, 8, 16), (4, 16, 8), (((2,), (1,)), ((0,), (0,))), F32,
     F32, False),
    ("grouped", (4, 80, 128), (4, 128, 64), (((2,), (1,)), ((0,), (0,))),
     F32, F32, True),
    ("mixed", (128, 128), (128, 128), (((1,), (0,)), ((), ())), F32, BF16,
     False),
    ("int32", (128, 128), (128, 128), (((1,), (0,)), ((), ())), I32, I32,
     False),
    ("qkt", (4, 64, 64), (4, 64, 64), (((2,), (2,)), ((0,), (0,))), F32,
     F32, False),
    ("ssd_4d", (2, 8, 8, 16), (2, 8, 8, 16),
     (((3,), (3,)), ((0, 1), (0, 1))), F32, F32, False),
    ("ssd_5d", (2, 8, 8, 8, 32), (2, 8, 8, 32, 8),
     (((2,), (2,)), ((0, 1, 4), (0, 1, 3))), F32, F32, False),
]


@dataclasses.dataclass
class _Aval:
    shape: tuple
    dtype: object
    device: str = "cpu"


def _torch_dtype(dt):
    return getattr(torch, np.dtype(dt).name)


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_classifier_matches_reference(layout, interpret):
    _, ls, rs, dims, ldt, rdt, grouped = layout
    out_shape = (1,)  # the classifier reads only the output's dtype here
    ref = ref_harvest.classify_dot_general(
        jax.core.ShapedArray(ls, ldt), jax.core.ShapedArray(rs, rdt),
        jax.core.ShapedArray(out_shape, F32),
        {"dimension_numbers": dims}, interpret=interpret,
        grouped_lhs=grouped)
    got = port_harvest.classify_dot_general(
        _Aval(ls, _torch_dtype(ldt)), _Aval(rs, _torch_dtype(rdt)),
        _Aval(out_shape, torch.float32), {"dimension_numbers": dims},
        interpret=interpret, grouped_lhs=grouped)
    want, have = ref.as_dict(), got.as_dict()
    for key in ("op", "spec", "extents", "status", "reason", "dtype",
                "out_dtype", "lhs_shape", "rhs_shape"):
        assert have[key] == want[key], (key, have, want)


EINSUMS = [
    ("hsd,htd->hst", (4, 64, 32), (4, 48, 32)),
    ("hst,hte->hse", (4, 64, 48), (4, 48, 16)),
    ("ecd,edf->ecf", (4, 80, 128), (4, 128, 64)),
    ("ecf,efd->ecd", (4, 80, 64), (4, 64, 128)),
    ("bsd,df->bsf", (2, 8, 16), (16, 24)),
    ("bkgh,btkh->bkgt", (2, 2, 3, 16), (2, 40, 2, 16)),
    ("bkgt,btkh->bkgh", (2, 2, 3, 40), (2, 40, 2, 16)),
    ("bcln,bcsn->bcls", (2, 4, 8, 16), (2, 4, 8, 16)),
    ("bhpn,bn->bhp", (2, 4, 8, 16), (2, 16)),
    ("kc,bkc->bc", (4, 32), (2, 4, 32)),
    ("ij,jk->ki", (8, 16), (16, 4)),
    ("bij,bjk->bik", (1, 8, 16), (3, 16, 4)),
    ("ij,kj->ik", (8, 16), (4, 16)),
]


def _ref_dot(eq, ls, rs):
    jaxpr = jax.make_jaxpr(lambda a, b: jnp.einsum(eq, a, b))(
        jnp.ones(ls, jnp.float32), jnp.ones(rs, jnp.float32))

    def find(jx):
        for e in jx.eqns:
            if e.primitive.name == "dot_general":
                return e
            for v in e.params.values():
                sub = getattr(v, "jaxpr", None)
                if sub is not None:
                    hit = find(getattr(sub, "jaxpr", sub))
                    if hit is not None:
                        return hit
        return None

    return find(jaxpr.jaxpr)


@pytest.mark.parametrize("eq,ls,rs", EINSUMS, ids=[e[0] for e in EINSUMS])
def test_einsum_lowers_as_jnp_einsum(eq, ls, rs):
    """``einsum_dot`` gives the operands' shapes and the dimension numbers
    of the ``dot_general`` that ``jnp.einsum`` emits, and the permutation
    and reshape that bring its output to the einsum's."""
    ref = _ref_dot(eq, ls, rs)
    form = port_harvest.einsum_dot(eq, ls, rs)
    (lc, rc), (lb, rb) = ref.params["dimension_numbers"]
    want = ((tuple(lc), tuple(rc)), (tuple(lb), tuple(rb)))
    assert form.dimension_numbers == want
    assert form.lhs_shape == tuple(ref.invars[0].aval.shape)
    assert form.rhs_shape == tuple(ref.invars[1].aval.shape)
    assert form.out_shape == tuple(ref.outvars[0].aval.shape)
    # the dot's output, permuted and reshaped, is the einsum's
    a = torch.randn(ls, dtype=torch.float64)
    b = torch.randn(rs, dtype=torch.float64)
    lhs, rhs = (b, a) if form.swapped else (a, b)
    from repro_torch.capture.rewrite import _prepare

    lhs = _prepare(lhs, form.lhs_sum, form.lhs_squeeze)
    rhs = _prepare(rhs, form.rhs_sum, form.rhs_squeeze)
    (lc, rc), (lb, rb) = form.dimension_numbers
    lf = [i for i in range(lhs.dim()) if i not in lc + lb]
    rf = [i for i in range(rhs.dim()) if i not in rc + rb]
    dot = torch.einsum(
        lhs.permute(*lb, *lf, *lc).reshape(
            int(np.prod([lhs.shape[i] for i in lb])),
            int(np.prod([lhs.shape[i] for i in lf])), -1),
        [0, 1, 2],
        rhs.permute(*rb, *rc, *rf).reshape(
            int(np.prod([rhs.shape[i] for i in rb])), -1,
            int(np.prod([rhs.shape[i] for i in rf]))),
        [0, 2, 3], [0, 1, 3]).reshape(form.out_shape)
    if form.perm is not None:
        dot = dot.permute(form.perm)
    want_out = torch.einsum(eq, a, b)
    torch.testing.assert_close(dot.reshape(want_out.shape), want_out)


# ---------------------------------------------------------------------------
# the conformance trio
# ---------------------------------------------------------------------------


def _reports(name):
    pcfg, rcfg, ploss, rloss, pp, rp, pb, rb = _case(name)
    ref = ref_capture.optimize(rloss, interpret=True, label=name) \
        .report_for(rp, rb)
    port = capture.optimize(ploss, interpret=True, label=name) \
        .report_for(pp, pb)
    return ref, port


_SITE_KEYS = ("op", "spec", "extents", "status", "reason", "dtype",
              "out_dtype", "lhs_shape", "rhs_shape", "out_shape")


def _motif_pairs(ref_sites):
    """The reference's (QK^T fallback, P.V batched_dense) pairs: on jax 0.9
    its motif matcher misses the ``where`` of the causal mask, which is a
    ``jit`` equation there, not ``pjit`` (ROADMAP.md queue C)."""
    out = []
    i = 0
    while i < len(ref_sites):
        s = ref_sites[i]
        if (s["op"] is None and "contract=((2,),(2,)) batch=((0,),(0,))"
                in s["reason"] and i + 1 < len(ref_sites)
                and ref_sites[i + 1]["op"] == "batched_dense"):
            out.append((s, ref_sites[i + 1]))
            i += 2
        else:
            out.append(s)
            i += 1
    return out


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_trio_reports_match_reference_site_for_site(name):
    ref, port = _reports(name)
    want = _motif_pairs([s.as_dict() for s in ref.sites])
    have = [s.as_dict() for s in port.sites]
    assert len(have) == len(want), (port.to_json(), ref.to_json())
    motifs = 0
    for got, exp in zip(have, want):
        if isinstance(exp, tuple):
            # the port's motif: one attention site where the reference
            # left QK^T and P.V apart
            qk, pv = exp
            h, s_, d = qk["lhs_shape"]
            t = qk["rhs_shape"][1]
            e = pv["rhs_shape"][2]
            assert got["op"] == "attention" and got["status"] == \
                "dispatched", got
            assert got["extents"] == {"h": h, "s": s_, "t": t, "d": d,
                                      "e": e}
            assert got["lhs_shape"] == qk["lhs_shape"]
            assert got["rhs_shape"] == qk["rhs_shape"]
            assert got["out_shape"] == pv["out_shape"]
            motifs += 1
            continue
        for key in _SITE_KEYS:
            assert got[key] == exp[key], (key, got, exp)
    assert motifs == {"dense": 1, "moe": 2}[name]


def test_ssm_report_parts_where_the_products_differ():
    """The port's SSD is written as pairwise products (no 4-operand
    einsum) scanned row by row (``models.ssm.ssd_chunked``), so its
    fallback products differ from the reference's in number and shape;
    the projections and the unembedding agree site for site."""
    ref, port = _reports("ssm")
    rd = [s.as_dict() for s in ref.sites if s.dispatched]
    pd = [s.as_dict() for s in port.sites if s.dispatched]
    assert len(pd) == len(rd) == 2
    for got, exp in zip(pd, rd):
        for key in _SITE_KEYS:
            assert got[key] == exp[key], (key, got, exp)
    first_ref, first_port = ref.sites[0].as_dict(), port.sites[0].as_dict()
    for key in _SITE_KEYS:
        assert first_port[key] == first_ref[key], key
    ssd = [s for s in port.sites if s.op is None]
    assert ssd and all("unsupported contraction layout" in s.reason
                       for s in ssd)


@pytest.mark.parametrize("name", NAMES)
def test_captured_trio_matches_reference_loss_and_grads(name):
    """Captured loss and gradients equal the reference's uncaptured
    ``loss`` and ``jax.grad``, and the port's uncaptured, at TOL."""
    pcfg, rcfg, ploss, rloss, pp, rp, pb, rb = _case(name)
    cf = capture.optimize(ploss, interpret=True, label=name)
    report = cf.report_for(pp, pb)
    assert report.dispatched > 0
    for site in report.sites:
        if site.dispatched:
            assert site.spec is not None and site.op is not None
        else:
            assert site.reason, site.as_dict()

    ref_l, ref_g = jax.value_and_grad(rloss)(rp, rb)
    unc_l, unc_g = value_and_grad(ploss, pp, pb)
    cap_l, cap_g = value_and_grad(cf, pp, pb)
    np.testing.assert_allclose(float(cap_l), float(ref_l), **TOL)
    np.testing.assert_allclose(float(cap_l), float(unc_l), **TOL)
    ref_flat = _flat(jax.tree.map(np.asarray, ref_g))
    for path, g in leaves(cap_g):
        want = ref_flat[tuple(path)].astype(np.float64)
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(
            g.detach().double().numpy() / scale, want / scale, **TOL,
            err_msg=f"{name} {path}: captured grad vs jax.grad")
    for (path, g), (_, u) in zip(leaves(cap_g), leaves(unc_g)):
        scale = max(float(u.abs().max()), 1.0)
        np.testing.assert_allclose(
            g.detach().double().numpy() / scale,
            u.detach().double().numpy() / scale, **TOL,
            err_msg=f"{name} {path}: captured grad vs uncaptured")


@pytest.mark.parametrize("name", NAMES)
def test_capture_dispatch_floors(name):
    """The reference's per-family floors, and no undocumented fallback."""
    pcfg, _, ploss, _, pp, _, pb, _ = _case(name)
    report = capture.optimize(ploss, interpret=True, label=name) \
        .report_for(pp, pb)
    floors = {"dense": 8, "moe": 10, "ssm": 2}
    assert report.dispatched >= floors[name], report.to_json()
    assert all(s.reason for s in report.sites if not s.dispatched)


def test_harvest_only_mode_replays_bit_for_bit():
    pcfg, _, ploss, _, pp, _, pb, _ = _case("dense")
    cf = capture.optimize(ploss, interpret=True, dispatch=False)
    report = cf.report_for(pp, pb)
    assert report.dispatched == 0
    annotated = [s for s in report.sites if "dispatch disabled" in s.reason]
    dispatchable = capture.optimize(ploss, interpret=True) \
        .report_for(pp, pb).dispatched
    assert len(annotated) == dispatchable > 0
    assert all(s.reason for s in report.sites)
    assert torch.equal(cf(pp, pb), ploss(pp, pb))
    l1, g1 = value_and_grad(cf, pp, pb)
    l2, g2 = value_and_grad(ploss, pp, pb)
    assert torch.equal(l1, l2)
    for (_, a), (_, b) in zip(leaves(g1), leaves(g2)):
        assert torch.equal(a, b)


def test_cpu_without_interpret_falls_back_entirely():
    pcfg, _, ploss, _, pp, _, pb, _ = _case("dense")
    cf = capture.optimize(ploss, interpret=False)
    report = cf.report_for(pp, pb)
    assert report.dispatched == 0
    assert all(s.reason == "cpu backend without interpret mode"
               for s in report.sites)
    assert torch.equal(cf(pp, pb), ploss(pp, pb))


# ---------------------------------------------------------------------------
# plan-DB pickup and the backward's derived specs
# ---------------------------------------------------------------------------


def test_dispatched_sites_consult_plan_db():
    from repro_torch.search import default_plan_db

    pcfg, _, ploss, _, pp, _, pb, _ = _case("dense")
    cf = capture.optimize(ploss, interpret=True)
    specs = cf.report_for(pp, pb).unique_specs()
    assert specs
    db = default_plan_db()
    n = capture.sweep_captured(
        [("t", spec, dt) for spec, dt in specs[:2]], with_grads=False,
        plan_db=db, beam_width=2, topk=1, repeats=1, interpret=True,
        device="cpu")
    assert n == len(specs[:2])
    hits0 = db.lookup_hits
    cf(pp, pb)
    assert db.lookup_hits > hits0, "captured call did not consult the DB"


def test_backward_uses_derived_spec_keys(tmp_path, monkeypatch):
    """Differentiating a captured loss tunes the derived specs' keys
    (``<spec>.dA`` / ``.dB``): the grad cache is larger than the forward
    one, and re-tuning the derived specs against it is all hits."""
    from repro_torch.codegen import tune_schedule
    from repro_torch.grad import derived_specs

    pcfg, _, ploss, _, pp, _, pb, _ = _case("dense")
    fwd_cache = tmp_path / "fwd.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(fwd_cache))
    with torch.no_grad():
        capture.optimize(ploss, interpret=True)(pp, pb)
    fwd_entries = json.loads(fwd_cache.read_text())

    grad_cache = tmp_path / "grad.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(grad_cache))
    value_and_grad(capture.optimize(ploss, interpret=True), pp, pb)
    grad_entries = json.loads(grad_cache.read_text())
    assert len(grad_entries) > len(fwd_entries)
    report = capture.optimize(ploss, interpret=True).report_for(pp, pb)
    matmuls = [s for s, _ in report.unique_specs() if s.name == "matmul"]
    assert matmuls
    before = len(json.loads(grad_cache.read_text()))
    for spec in matmuls:
        for dspec in derived_specs(spec).values():
            tune_schedule(dspec, dtype=torch.float32)
    assert len(json.loads(grad_cache.read_text())) == before


# ---------------------------------------------------------------------------
# replay units
# ---------------------------------------------------------------------------


def _aligned(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def test_replayed_launch_differentiates_through_its_op():
    """A function that already launches a kernel (``ops.dense`` with
    ``interpret``) traces to a ``repro_torch::contract`` node; the replay
    runs the op, whose autograd formula is the wrapper's derived-spec
    backward, so the gradient is the uncaptured one."""
    x, w = _aligned(10, 128, 128), _aligned(11, 128, 128)

    def loss(x_, w_):
        return ops.dense(x_, w_, interpret=True).sum()

    cf = capture.optimize(loss, interpret=True)
    report = cf.report_for(x, w)
    assert [(s.op, s.status) for s in report.sites] == [
        ("dense", "dispatched")]
    assert report.sites[0].path.endswith("@launch")
    grads = []
    for fn in (loss, cf):
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        fn(xr, wr).backward()
        grads.append((xr.grad, wr.grad))
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def test_remat_regions_replay_under_checkpoint(monkeypatch):
    """A ``layers.scan_body`` under remat is one region: the report names
    it once whatever the trip count, and the replay checkpoints it (its
    products run again in the backward)."""
    from repro_torch.models import layers

    w = _aligned(1, 128, 128)
    x = _aligned(0, 128, 128)
    calls = {"n": 0}
    real = ops.dense

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    def fn(x_, w_):
        step = layers.scan_body(lambda h, ww: torch.tanh(h @ ww),
                                name="body", remat_on=True)
        for _ in range(3):
            x_ = step(x_, w_)
        return x_.sum()

    cf = capture.optimize(fn, interpret=True)
    report = cf.report_for(x, w)
    assert [s.path for s in report.sites] == ["body/remat/node0"]
    monkeypatch.setattr(ops, "dense", counting)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    cf(xr, wr).backward()
    assert calls["n"] == 6  # 3 forward + 3 recomputed in the backward
    xe, we = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    fn(xe, we).backward()
    torch.testing.assert_close(wr.grad, we.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xr.grad, xe.grad, rtol=1e-5, atol=1e-5)


def test_transposed_and_batched_sites():
    a = _aligned(2, 16, 8)
    b = _aligned(3, 16, 12)
    xb = _aligned(4, 4, 8, 16)
    wb = _aligned(5, 4, 16, 8)

    def fn(a_, b_, xb_, wb_):
        t = torch.einsum("dm,df->mf", a_, b_)
        bt = torch.bmm(xb_, wb_)
        return t.sum() + bt.sum()

    cf = capture.optimize(fn, interpret=True)
    report = cf.report_for(a, b, xb, wb)
    assert {s.op for s in report.sites if s.dispatched} == {
        "dense_transposed", "batched_dense"}
    torch.testing.assert_close(cf(a, b, xb, wb), fn(a, b, xb, wb),
                               rtol=1e-5, atol=1e-5)


def test_quant_capture_is_within_the_int8_tolerance():
    """``optimize(quant="int8")`` sends the dispatched dense site through
    ``ops.dense(quant="int8")``: within 0.05 of max |x @ w|."""
    x, w = _aligned(20, 128, 256), _aligned(21, 256, 128)
    cf = capture.optimize(lambda a, b: a @ b, interpret=True, quant="int8")
    report = cf.report_for(x, w)
    assert [(s.op, s.status) for s in report.sites] == [
        ("dense", "dispatched")]
    with torch.no_grad():
        got, want = cf(x, w), x @ w
    err = float((got - want).abs().max() / want.abs().max())
    assert 0 < err < 0.05, err


# ---------------------------------------------------------------------------
# abstract whole-model harvest + report artifact
# ---------------------------------------------------------------------------


def _concrete(kind):
    cfg = capture.demo_configs()["dense"]
    api = port_get_api(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((B, S), dtype=torch.int32)
    if kind == "train":
        fn = lambda p, b: api.loss(p, cfg, b)  # noqa: E731
        args = (params, {"tokens": toks, "labels": toks})
    elif kind == "prefill":
        fn = lambda p, b: api.prefill(p, cfg, b, S)  # noqa: E731
        args = (params, {"tokens": toks})
    else:
        caches = api.cache_init(cfg, B, S, device="cpu")
        fn = lambda p, c, t: api.decode_step(p, cfg, c, t)  # noqa: E731
        args = (params, caches, torch.zeros((B, 1), dtype=torch.int32))
    return capture.optimize(fn, interpret=True).report_for(*args)


@pytest.mark.parametrize("kind", capture.KINDS)
def test_abstract_harvest_matches_concrete(kind):
    """``model_capture`` traces on fake tensors — its arguments are fake,
    nothing is allocated — and reports what a call on real tensors does,
    site for site."""
    from torch._subclasses.fake_tensor import FakeTensor

    cfg = capture.demo_configs()["dense"]
    captured, abstract = capture.model_capture(
        cfg, batch=B, seq=S, kind=kind, interpret=True)
    entry = next(iter(captured._entries.values()))
    placeholders = [n for n in entry.traced.gm.graph.nodes
                    if n.op == "placeholder"]
    assert placeholders and all(isinstance(n.meta["val"], FakeTensor)
                                for n in placeholders)
    concrete = _concrete(kind)
    assert abstract.harvested > 0
    if kind == "train":
        assert abstract.dispatched > 0
    a = [{k: v for k, v in s.as_dict().items() if k != "path"}
         for s in abstract.sites]
    c = [{k: v for k, v in s.as_dict().items() if k != "path"}
         for s in concrete.sites]
    assert a == c


def test_abstract_reports_match_reference_counts():
    """Prefill and decode on fake tensors: the reference's counts, with
    the motif's two sites as one (prefill) and decode's attention
    einsums (4-D, fallback in both) alike."""
    cfg_p = capture.demo_configs()["dense"]
    cfg_r = ref_capture.demo_configs()["dense"]
    for kind in ("prefill", "decode"):
        _, port = capture.model_capture(cfg_p, batch=B, seq=S, kind=kind,
                                        interpret=True)
        _, ref = ref_capture.model_capture(cfg_r, batch=B, seq=S, kind=kind,
                                           interpret=True)
        motif = sum(1 for s in port.sites if s.op == "attention")
        assert port.harvested == ref.harvested - motif, kind
        assert port.dispatched == ref.dispatched, kind


def test_model_gemm_specs_dedupes():
    cfg = capture.demo_configs()["dense"]
    points = capture.model_gemm_specs(cfg, batch=B, seq=S,
                                      kinds=("train", "prefill"),
                                      interpret=True)
    keys = [capture.spec_key(spec, dt) for _, spec, dt in points]
    assert points and len(keys) == len(set(keys))


def test_report_json_roundtrip():
    pcfg, _, ploss, _, pp, _, pb, _ = _case("moe")
    report = capture.optimize(ploss, interpret=True).report_for(pp, pb)
    blob = json.loads(report.to_json())
    assert blob["harvested"] == report.harvested
    assert blob["dispatched"] == report.dispatched
    assert len(blob["sites"]) == report.harvested
    for site in blob["sites"]:
        assert site["status"] in ("dispatched", "fallback")
        if site["status"] == "dispatched":
            assert site["spec"] in ("matmul", "transposed_matmul",
                                    "batched_matmul", "attention",
                                    "grouped_matmul")


def test_report_cli_writes_the_trio(tmp_path):
    from repro_torch.capture import report as report_mod

    assert report_mod.main(["--out", str(tmp_path)]) == 0
    index = json.loads((tmp_path / "index.json").read_text())
    assert set(index) == {"dense", "moe", "ssm"}
    assert index["dense"]["train"]["dispatched"] == 9
