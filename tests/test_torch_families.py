"""The port's ssm, hybrid, encdec and vlm families against the reference.

For the smoke config of each of mamba2-130m, zamba2-2.7b, whisper-base and
internvl2-1b, the reference's seeded params go through
``params_from_reference`` and the same numpy inputs go through both
packages' ``models.api``:

* ``forward`` logits and prefill + three ``decode_step``s at rtol 1e-4 /
  atol 1e-5 (f32);
* ``loss`` and the gradient of every leaf against ``jax.grad``, at
  ``tests/test_grad.py``'s (2e-4, 2e-4) scaled by max |ref| (by at least
  1e-4 of the tree's largest gradient: the key biases' gradients vanish
  analytically and are noise on both sides);
* one bf16 leg each: prefill logits within 6e-2 of max |logit|;
* ``ssd_chunked`` at chunks that divide S and that do not, with and
  without an initial state, against the reference's function, and the
  reference's own SSD and decode-matches-forward cases
  (``tests/test_model_consistency.py``) run on the port;
* ``layernorm``, ``sinusoid``, ``batch_spec``, ``ARCH_IDS`` and every full
  config's fields equal to the reference's; ``params_from_reference``
  keeps the reference's float32 leaves.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.configs.base import SHAPES as REF_SHAPES
from repro.models import api as RA
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models import ssm as RS
from repro_torch import configs as PC
from repro_torch.configs.base import SHAPES, ModelConfig, SSMConfig
from repro_torch.models import api as PA
from repro_torch.models import encdec as PE
from repro_torch.models import hybrid as PH
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT

RTOL, ATOL = 1e-4, 1e-5
GRAD_TOL = (2e-4, 2e-4)
BF16_SCALED_TOL = 6e-2
FAMILIES = ("mamba2-130m", "zamba2-2.7b", "whisper-base", "internvl2-1b")
B, S, S_ENC = 2, 16, 12


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(t, np.float64)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _scaled_close(got, want, what, tol, floor=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), floor) or 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol[0],
                               atol=tol[1], err_msg=what)


def _configs(arch, dtype="float32"):
    ref = dataclasses.replace(RC.get_config(arch).smoke(), dtype=dtype)
    port = dataclasses.replace(PC.get_config(arch).smoke(), dtype=dtype)
    return ref, port


def _model(arch, dtype="float32", seed=0):
    ref_cfg, port_cfg = _configs(arch, dtype)
    ref_params, _ = RA.get_api(ref_cfg).init(ref_cfg, jax.random.key(seed))
    port_params = PT.params_from_reference(
        port_cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    return ref_cfg, port_cfg, ref_params, port_params


def _batches(cfg, seed, labels=False, tokens=None):
    """The same inputs for both packages: (reference batch, port batch)."""
    rng = np.random.default_rng(seed)
    if tokens is None:
        tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    arrays = {"tokens": tokens}
    if labels:
        arrays["labels"] = rng.integers(0, cfg.vocab, size=tokens.shape
                                        ).astype(np.int32)
    if cfg.family == "encdec":
        arrays["frames"] = rng.standard_normal(
            (tokens.shape[0], S_ENC, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (tokens.shape[0], RA.N_PATCHES, 1024)).astype(np.float32)
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    port = {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in arrays.items()}
    return ref, port


def _max_len(cfg, prompt):
    return prompt + 8 + (RA.N_PATCHES if cfg.family == "vlm" else 0)


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    return _model(request.param)


# --------------------------------------------------------------------------
# configs and small functions
# --------------------------------------------------------------------------


def test_arch_ids_match_reference():
    assert PC.ARCH_IDS == RC.ARCH_IDS
    assert len(PC.ARCH_IDS) == 10


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_full_config_fields_match_reference(arch):
    ref, port = RC.get_config(arch), PC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_dtype == getattr(torch, ref.dtype)
    assert dataclasses.asdict(port.smoke()) == dataclasses.asdict(ref.smoke())


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    cfg = PC.get_config("whisper-base").smoke()
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(cfg.d_model).astype(np.float32)
    bias = rng.standard_normal(cfg.d_model).astype(np.float32)
    want = RL.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jnp.asarray(x), 1e-5)
    got = PL.layernorm({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)}, torch.from_numpy(x),
                       1e-5)
    _close(got, want, "layernorm")
    init = PL.layernorm_init(cfg)
    assert init["scale"].dtype == init["bias"].dtype == torch.float32
    assert torch.equal(init["scale"], torch.ones(cfg.d_model))
    assert torch.equal(init["bias"], torch.zeros(cfg.d_model))
    # bf16 in, bf16 out, the arithmetic in f32
    xb = torch.from_numpy(x).bfloat16()
    out = PL.layernorm({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)}, xb, 1e-5)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("seq,dim", [(1, 8), (12, 32), (64, 512)])
def test_sinusoid_matches_reference(seq, dim):
    np.testing.assert_allclose(PE.sinusoid(seq, dim).numpy(),
                               np.asarray(RE.sinusoid(seq, dim)),
                               rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_batch_spec_matches_reference(arch, shape):
    got = PA.batch_spec(PC.get_config(arch), SHAPES[shape])
    want = RA.batch_spec(RC.get_config(arch), REF_SHAPES[shape])
    assert list(got) == list(want)
    for name, (shp, dt) in want.items():
        assert got[name][0] == shp, name
        assert str(got[name][1]).rsplit(".", 1)[-1] == np.dtype(dt).name


def test_get_api_serves_every_family():
    for arch in PC.ARCH_IDS:
        cfg = PC.get_config(arch)
        assert PA.get_api(cfg) is not None
    assert PA.N_PATCHES == RA.N_PATCHES


def test_params_from_reference_keeps_f32_leaves():
    """A layernorm bias and the SSM's A_log stay f32 in a bf16 model; the
    projection biases (bq, b1, projector b) take the param dtype."""
    for arch in ("whisper-base", "mamba2-130m", "internvl2-1b"):
        ref_cfg, port_cfg = _configs(arch, "bfloat16")
        ref_params, _ = RA.get_api(ref_cfg).init(ref_cfg, jax.random.key(0))
        port = PT.params_from_reference(
            port_cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
        flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
        for path, leaf in flat_ref:
            node = port
            for key in path:
                node = node[key.key]
            want = str(leaf.dtype)
            assert str(node.dtype).rsplit(".", 1)[-1] == want, (
                arch, jax.tree_util.keystr(path))
    ref_cfg, port_cfg = _configs("whisper-base", "bfloat16")
    rp, _ = RA.get_api(ref_cfg).init(ref_cfg, jax.random.key(0))
    port = PT.params_from_reference(port_cfg, jax.tree.map(np.asarray, rp),
                                    device="cpu")
    lay = port["dec_layers"]
    assert lay["self_norm"]["bias"].dtype == torch.float32
    assert lay["self_attn"]["bq"].dtype == torch.bfloat16
    assert lay["mlp"]["b1"].dtype == torch.bfloat16
    ref_cfg, port_cfg = _configs("mamba2-130m", "bfloat16")
    rp, _ = RA.get_api(ref_cfg).init(ref_cfg, jax.random.key(0))
    port = PT.params_from_reference(port_cfg, jax.tree.map(np.asarray, rp),
                                    device="cpu")
    for leaf in ("A_log", "D", "dt_bias", "norm_scale"):
        assert port["ssm_layers"]["ssm"][leaf].dtype == torch.float32, leaf
    assert port["ssm_layers"]["ssm"]["in_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_init_matches_reference_tree(arch):
    ref_cfg, port_cfg = _configs(arch, "bfloat16")
    ref_params, _ = RA.get_api(ref_cfg).init(ref_cfg, jax.random.key(0))
    port_params = PA.get_api(port_cfg).init(
        port_cfg, torch.Generator().manual_seed(0), "cpu")
    flat_ref = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_flatten_with_path(ref_params)[0]}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}['{k}']"
            if isinstance(v, dict):
                yield from walk(v, path)
            else:
                yield path, v

    flat_port = dict(walk(port_params))
    assert set(flat_port) == set(flat_ref)
    for path, t in flat_port.items():
        r = flat_ref[path]
        assert tuple(t.shape) == tuple(r.shape), path
        assert str(t.dtype).rsplit(".", 1)[-1] == str(r.dtype), path
        if str(r.dtype) == "float32" and r.ndim and not path.endswith(
                "['A_log']"):
            # constant leaves: ones or zeros, equal to the reference's
            np.testing.assert_array_equal(t.numpy(), np.asarray(r),
                                          err_msg=path)


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            (-np.abs(rng.standard_normal((b, s, h))) * 0.5).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


@pytest.mark.parametrize("chunk", [1, 4, 5, 8, 16, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_state):
    """Chunks that divide S (4, 8, 16), that do not (5 -> gcd 4) and that
    exceed it (32 -> S), with and without an initial state."""
    arrays = _ssd_inputs(chunk, 2, 16, 3, 4, 5)
    init = (np.random.default_rng(9).standard_normal((2, 3, 4, 5))
            .astype(np.float32) if with_state else None)
    want_y, want_st = RS.ssd_chunked(
        *map(jnp.asarray, arrays), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    got_y, got_st = PS.ssd_chunked(
        *map(torch.from_numpy, arrays), chunk=chunk,
        initial_state=None if init is None else torch.from_numpy(init))
    _close(got_y, want_y, "y")
    _close(got_st, want_st, "final state")


def naive_ssd(x, A, Bm, C):
    """The sequential state-space recurrence (the definition)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    state = np.zeros((b, h, p, n))
    ys = np.zeros_like(x)
    for t in range(s):
        dA = np.exp(A[:, t])
        state = state * dA[..., None, None] + (
            x[:, t][..., None] * Bm[:, t][:, None, None, :])
        ys[:, t] = np.einsum("bhpn,bn->bhp", state, C[:, t])
    return ys


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16])
def test_ssd_chunked_equals_recurrence(chunk):
    """The reference's case (``tests/test_model_consistency.py``)."""
    x, A, Bm, C = _ssd_inputs(0, 2, 16, 3, 4, 5)
    y, _ = PS.ssd_chunked(*map(torch.from_numpy, (x, A, Bm, C)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), naive_ssd(x, A, Bm, C),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_scans_each_row_alone(with_state, monkeypatch):
    """A batch is scanned one row at a time, so each row of the result is
    bit for bit the scan of that row alone (whatever the card's prefix
    sums would do with more rows)."""
    x, A, Bm, C = map(torch.from_numpy, _ssd_inputs(4, 3, 16, 3, 4, 5))
    init = (torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 3, 4, 5)).astype(np.float32)) if with_state else None)
    rows = []
    scan = PS._ssd_scan
    monkeypatch.setattr(PS, "_ssd_scan",
                        lambda x, *a, **k: rows.append(x.shape[0])
                        or scan(x, *a, **k))
    y, st = PS.ssd_chunked(x, A, Bm, C, chunk=8, initial_state=init)
    assert rows == [1, 1, 1]
    for i in range(3):
        yi, sti = scan(x[i:i + 1], A[i:i + 1], Bm[i:i + 1], C[i:i + 1], 8,
                       None if init is None else init[i:i + 1])
        assert torch.equal(y[i:i + 1], yi) and torch.equal(st[i:i + 1], sti)


def test_ssd_final_state_supports_streaming():
    x, A, Bm, C = map(torch.from_numpy, _ssd_inputs(1, 1, 12, 2, 4, 3))
    y_full, _ = PS.ssd_chunked(x, A, Bm, C, chunk=4)
    y1, st1 = PS.ssd_chunked(x[:, :6], A[:, :6], Bm[:, :6], C[:, :6], chunk=4)
    y2, _ = PS.ssd_chunked(x[:, 6:], A[:, 6:], Bm[:, 6:], C[:, 6:], chunk=4,
                           initial_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_ssm_apply_branches_match_reference():
    """The chunked path (no cache; a prefill with a cache) and the one-token
    recurrent step, against the reference's ``ssm_apply``."""
    ref_cfg, port_cfg = _configs("mamba2-130m")
    pa, _ = RL.split_params(RS.ssm_init(jax.random.key(2), ref_cfg))
    pt = PT.params_from_reference(port_cfg, jax.tree.map(np.asarray, pa),
                                  device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, ref_cfg.d_model)).astype(np.float32)
    want, _ = RS.ssm_apply(pa, ref_cfg, jnp.asarray(x))
    got, _ = PS.ssm_apply(pt, port_cfg, torch.from_numpy(x))
    _close(got, want, "no cache")
    rcache = RS.ssm_cache_init(ref_cfg, 2)
    pcache = PS.ssm_cache_init(port_cfg, 2)
    want, rcache = RS.ssm_apply(pa, ref_cfg, jnp.asarray(x), cache=rcache)
    got, pcache = PS.ssm_apply(pt, port_cfg, torch.from_numpy(x),
                               cache=pcache)
    _close(got, want, "prefill")
    for leaf in ("conv", "state"):
        _close(pcache[leaf], rcache[leaf], f"prefill cache {leaf}")
    for step in range(2):
        x1 = rng.standard_normal((2, 1, ref_cfg.d_model)).astype(np.float32)
        want, rcache = RS.ssm_apply(pa, ref_cfg, jnp.asarray(x1), cache=rcache)
        got, pcache = PS.ssm_apply(pt, port_cfg, torch.from_numpy(x1),
                                   cache=pcache)
        _close(got, want, f"step {step}")
        for leaf in ("conv", "state"):
            _close(pcache[leaf], rcache[leaf], f"step {step} cache {leaf}")


# --------------------------------------------------------------------------
# the four families through models.api
# --------------------------------------------------------------------------


def test_forward_matches_reference(model):
    ref_cfg, port_cfg, ref_params, port_params = model
    rb, pb = _batches(ref_cfg, seed=1)
    want = RA.get_api(ref_cfg).forward(ref_params, ref_cfg, rb)
    with torch.no_grad():
        got = PA.get_api(port_cfg).forward(port_params, port_cfg, pb)
    assert got.dtype == torch.float32 and got.shape == (B, S, ref_cfg.vocab)
    _close(got, want, f"{ref_cfg.arch_id} forward logits")


def test_loss_and_grads_match_reference(model):
    ref_cfg, port_cfg, ref_params, port_params = model
    rb, pb = _batches(ref_cfg, seed=2, labels=True)
    rapi = RA.get_api(ref_cfg)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: rapi.loss(p, ref_cfg, rb))(ref_params)
    params = PT._tree_map(lambda t: t.clone().requires_grad_(True),
                          port_params)
    loss = PA.get_api(port_cfg).loss(params, port_cfg, pb)
    loss.backward()
    _close(loss, want_loss, "loss")
    flat = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    # attention's key bias has an analytically zero gradient (the softmax
    # is invariant to it): both sides are 1e-10 noise, so a leaf is scaled
    # by at least 1e-4 of the tree's largest gradient
    floor = 1e-4 * max(np.abs(np.asarray(w)).max() for _, w in flat)
    for path, want in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert node.grad is not None, jax.tree_util.keystr(path)
        _scaled_close(node.grad, want, f"grad {jax.tree_util.keystr(path)}",
                      GRAD_TOL, floor)


def test_prefill_then_decode_matches_reference(model):
    ref_cfg, port_cfg, ref_params, port_params = model
    rapi, papi = RA.get_api(ref_cfg), PA.get_api(port_cfg)
    rb, pb = _batches(ref_cfg, seed=3)
    max_len = _max_len(ref_cfg, S)
    r_logits, r_caches = rapi.prefill(ref_params, ref_cfg, rb, max_len)
    with torch.inference_mode():
        p_logits, p_caches = papi.prefill(port_params, port_cfg, pb, max_len)
    assert p_logits.shape == (B, 1, ref_cfg.vocab)
    _close(p_logits, r_logits, "prefill logits")
    rng = np.random.default_rng(4)
    for step in range(3):
        nxt = rng.integers(0, ref_cfg.vocab, size=(B, 1)).astype(np.int32)
        r_logits, r_caches = rapi.decode_step(ref_params, ref_cfg, r_caches,
                                              jnp.asarray(nxt))
        with torch.inference_mode():
            p_logits, p_caches = papi.decode_step(
                port_params, port_cfg, p_caches, torch.from_numpy(nxt).long())
        _close(p_logits, r_logits, f"decode step {step} logits")
    # the caches hold what the reference's hold
    flat = jax.tree_util.tree_flatten_with_path(r_caches)[0]
    for path, want in flat:
        node = p_caches
        for key in path:
            node = node[key.key]
        _close(node, want, f"cache {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_prefill_logits_match_reference(arch):
    ref_cfg, port_cfg, ref_params, port_params = _model(arch, "bfloat16", 5)
    rb, pb = _batches(ref_cfg, seed=6)
    max_len = _max_len(ref_cfg, S)
    want, _ = RA.get_api(ref_cfg).prefill(ref_params, ref_cfg, rb, max_len)
    with torch.inference_mode():
        got, _ = PA.get_api(port_cfg).prefill(port_params, port_cfg, pb,
                                              max_len)
    assert got.dtype == torch.float32
    want = _np(want)
    scaled = np.abs(_np(got) - want).max() / np.abs(want).max()
    assert scaled <= BF16_SCALED_TOL, scaled


def test_vlm_prefill_overrunning_the_cache_raises():
    _, port_cfg, _, port_params = _model("internvl2-1b")
    _, pb = _batches(port_cfg, seed=7)
    with pytest.raises(ValueError, match="overruns"):
        PA.get_api(port_cfg).prefill(port_params, port_cfg, pb, S + 4)


@pytest.mark.parametrize("family,key", [("whisper-base", "frames"),
                                        ("internvl2-1b", "patches")])
def test_missing_frontend_input_names_it(family, key):
    _, port_cfg, _, port_params = _model(family)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match=key):
        PA.get_api(port_cfg).prefill(port_params, port_cfg,
                                     {"tokens": tokens}, 64)


def test_hybrid_prefill_refuses_lengths():
    _, port_cfg, _, port_params = _model("zamba2-2.7b")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "lengths": torch.tensor([3])}
    with pytest.raises(NotImplementedError, match="lengths"):
        PA.get_api(port_cfg).prefill(port_params, port_cfg, batch, 8)


# --------------------------------------------------------------------------
# the reference's decode-matches-forward cases, on the port
# --------------------------------------------------------------------------


SSM_SMALL = SSMConfig(d_state=8, expand=2, headdim=8, chunk=4)
CONSISTENCY = {
    "ssm": ModelConfig(arch_id="s", family="ssm", n_layers=2, d_model=32,
                       n_heads=0, n_kv_heads=0, d_ff=0, vocab=97,
                       dtype="float32", ssm=SSM_SMALL),
    "hybrid": ModelConfig(arch_id="h", family="hybrid", n_layers=4,
                          d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                          vocab=97, head_dim=8, dtype="float32",
                          attn_every=2, ssm=SSM_SMALL),
    "encdec": dataclasses.replace(PC.get_config("whisper-base").smoke()),
    "vlm": dataclasses.replace(PC.get_config("internvl2-1b").smoke()),
}


@pytest.mark.parametrize("family", sorted(CONSISTENCY))
def test_decode_matches_forward(family):
    """Prefill of the first S-1 tokens, then one decode step, gives the
    teacher-forced forward's last logits (rtol / atol 5e-3, the
    reference's)."""
    cfg = CONSISTENCY[family]
    api = PA.get_api(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 97, size=(2, 12))).long()
    extra = {}
    if family == "encdec":
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (2, S_ENC, cfg.d_model)).astype(np.float32))
    if family == "vlm":
        extra["patches"] = torch.from_numpy(rng.standard_normal(
            (2, PA.N_PATCHES, 1024)).astype(np.float32))
    with torch.inference_mode():
        full = api.forward(params, cfg, {"tokens": toks, **extra})
        _, caches = api.prefill(params, cfg, {"tokens": toks[:, :-1],
                                              **extra},
                                _max_len(cfg, 12))
        lg, _ = api.decode_step(params, cfg, caches, toks[:, -1:])
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_hybrid_caches_are_per_site():
    cfg = CONSISTENCY["hybrid"]
    caches = PH.cache_init(cfg, 2, 16)
    assert caches["attn"]["k"].shape[0] == cfg.n_layers // cfg.attn_every
    assert caches["ssm"]["state"].shape[0] == cfg.n_layers
    assert caches["ssm"]["state"].dtype == torch.float32
