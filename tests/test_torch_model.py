"""The port's dense model against the reference on the same weights.

A 128-aligned variant of qwen3-8b (2 layers, d_model 256, GQA 4/2 heads
of 64, d_ff 512, vocab 512, float32): the reference's params go through
``params_from_reference``; prefill logits and KV caches on a 128-token
right-padded batch, then three decode steps, must agree at rtol 1e-4 /
atol 1e-5.  ``blockwise_attention`` (both its paths) and
``decode_attention`` are compared on shared inputs too.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config as port_get_config
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=512, vocab=512, dtype="float32")


def small_configs():
    ref = dataclasses.replace(ref_get_config("qwen3-8b"), **SMALL)
    port = dataclasses.replace(port_get_config("qwen3-8b"), **SMALL)
    return ref, port


def reference_params(ref_cfg, seed=0):
    params, _ = RT.init(ref_cfg, jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


def _close(got, want, what):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64),
        rtol=RTOL, atol=ATOL, err_msg=what,
    )


@pytest.fixture(scope="module")
def model():
    ref_cfg, port_cfg = small_configs()
    ref_params, np_params = reference_params(ref_cfg)
    port_params = PT.params_from_reference(port_cfg, np_params, device="cpu")
    return ref_cfg, port_cfg, ref_params, port_params


def test_params_carry_across(model):
    ref_cfg, port_cfg, ref_params, port_params = model
    wq = port_params["seg0"]["dense"]["attn"]["wq"]
    assert wq.shape == (2, 256, 256) and wq.dtype == torch.float32
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(ref_params["seg0"]["dense"]["attn"]["wq"])
    )
    assert port_params["seg0"]["dense"]["attn"]["q_norm"].dtype == (
        torch.float32
    )


def test_port_init_matches_reference_shapes_and_dtypes():
    ref_cfg, port_cfg = small_configs()
    port_cfg = dataclasses.replace(port_cfg, dtype="bfloat16")
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    ref_params, _ = RT.init(ref_cfg, jax.random.key(0))
    port_params = PT.init(port_cfg, torch.Generator().manual_seed(0),
                          device="cpu")
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
    # the embedding's scale is 0.02, the projections' 1/sqrt(fan-in)
    tok = port_params["embedding"]["tok"].float()
    assert 0.015 < tok.std().item() < 0.025
    wq = port_params["seg0"]["dense"]["attn"]["wq"].float()
    assert abs(wq.std().item() * 16.0 - 1.0) < 0.05


def test_prefill_then_decode_matches_reference(model):
    ref_cfg, port_cfg, ref_params, port_params = model
    rng = np.random.default_rng(0)
    S, max_len = 128, 132
    tokens = rng.integers(0, ref_cfg.vocab, size=(2, S)).astype(np.int32)
    lengths = np.array([S, 90], np.int32)
    tokens[1, 90:] = 0

    r_logits, r_caches = RT.prefill(
        ref_params, ref_cfg, jnp.asarray(tokens), max_len,
        lengths=jnp.asarray(lengths),
    )
    p_logits, p_caches = PT.prefill(
        port_params, port_cfg, torch.from_numpy(tokens).long(), max_len,
        lengths=torch.from_numpy(lengths).long(),
    )
    assert p_logits.dtype == torch.float32 and p_logits.shape == (2, 1, 512)
    _close(p_logits, r_logits, "prefill logits")

    def check_caches(step):
        rc, pc = r_caches["seg0"]["dense"], p_caches["seg0"]["dense"]
        lens = np.asarray(rc["len"])
        np.testing.assert_array_equal(pc["len"].numpy(), lens)
        for leaf in ("k", "v"):
            for b in range(2):
                n = int(lens[0, b])  # positions that hold real KV
                _close(pc[leaf][:, b, :n], np.asarray(rc[leaf])[:, b, :n],
                       f"{leaf} cache, row {b}, {step}")

    check_caches("after prefill")
    for step in range(3):
        nxt = rng.integers(0, ref_cfg.vocab, size=(2, 1)).astype(np.int32)
        r_logits, r_caches = RT.decode_step(
            ref_params, ref_cfg, r_caches, jnp.asarray(nxt)
        )
        p_logits, p_caches = PT.decode_step(
            port_params, port_cfg, p_caches, torch.from_numpy(nxt).long()
        )
        _close(p_logits, r_logits, f"decode step {step} logits")
        check_caches(f"after decode step {step}")


def _qkv(rng, B, S, T, H, KV, hd):
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("S,block,causal,with_lengths", [
    (64, 512, True, False),     # single-block path
    (64, 512, False, False),    # single-block path, no causal mask
    (256, 64, True, True),      # online-softmax loop, padded lengths
    (192, 128, True, False),    # loop, gcd-snapped 64 blocks
    (128, 32, False, True),     # loop, non-causal, lengths mask
])
def test_blockwise_attention_matches_reference(S, block, causal,
                                               with_lengths):
    rng = np.random.default_rng(S + block)
    q, k, v = _qkv(rng, 2, S, S, 4, 2, 16)
    lengths = np.array([S, S - 37], np.int32) if with_lengths else None
    want = RL.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_block=block, k_block=block,
        kv_lengths=None if lengths is None else jnp.asarray(lengths),
    )
    got = PL.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_block=block, k_block=block,
        kv_lengths=None if lengths is None else torch.from_numpy(lengths),
    )
    _close(got, want, "blockwise attention")


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 3, 1, 40, 8, 2, 16)
    lens = np.array([40, 7, 1], np.int32)
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(lens))
    got = PL.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lens))
    _close(got, want, "decode attention")


def test_norms_and_rope_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    scale = rng.standard_normal((64,)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32) * 37
    _close(PL.rmsnorm({"scale": torch.from_numpy(scale)},
                      torch.from_numpy(x), 1e-6),
           RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6),
           "rmsnorm")
    _close(PL._qk_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           RL._qk_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), "qk norm")
    _close(PL.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           RL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), "rope")
