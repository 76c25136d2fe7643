"""Whisper-style encoder-decoder (the audio backbone; the conv frontend is
a stub: the caller feeds precomputed frame embeddings).

A port of the reference's ``models/encdec.py``: LayerNorm, the GELU MLP,
sinusoidal positions (no rope) and cross-attention from the decoder to the
encoder's output.  Decode caches the self-attention K/V and each layer's
cross-attention K/V, computed once at prefill.  The encoder and decoder
layers are stacked along a leading ``layers`` axis and walked in a Python
loop (the reference's ``lax.scan``); their self-attention and MLP
projections go through ``ops.dense``.  The cross-attention projections are
``jnp.dot`` in the reference, so ``layers.dot`` here, and its attention is
``layers.blockwise_attention``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from .layers import F32, dot
from .transformer import _tree_map, _unstack, stacked_init


def _angles(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """positions (...,) -> (..., dim // 2): pos / 10000^(2i / dim), f32."""
    i = torch.arange(dim // 2, dtype=F32, device=positions.device)
    return positions.to(F32)[..., None] / torch.pow(
        torch.tensor(10_000.0, dtype=F32, device=positions.device),
        2 * i / dim)


def sinusoid(seq: int, dim: int, device="cpu") -> torch.Tensor:
    ang = _angles(torch.arange(seq, device=device), dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_layer_init(cfg: ModelConfig):
    def layer(generator, device, out):
        return {
            "attn_norm": L.layernorm_init(cfg, device=device,
                                          out=L._leaf(out, "attn_norm")),
            "attn": L.attention_init(cfg, generator, device,
                                     out=L._leaf(out, "attn")),
            "mlp_norm": L.layernorm_init(cfg, device=device,
                                         out=L._leaf(out, "mlp_norm")),
            "mlp": L.mlp_init(cfg, generator, device,
                              out=L._leaf(out, "mlp")),
        }
    return layer


def _dec_layer_init(cfg: ModelConfig):
    def layer(generator, device, out):
        return {
            "self_norm": L.layernorm_init(cfg, device=device,
                                          out=L._leaf(out, "self_norm")),
            "self_attn": L.attention_init(cfg, generator, device,
                                          out=L._leaf(out, "self_attn")),
            "cross_norm": L.layernorm_init(cfg, device=device,
                                           out=L._leaf(out, "cross_norm")),
            "cross_attn": L.attention_init(cfg, generator, device,
                                           out=L._leaf(out, "cross_attn")),
            "mlp_norm": L.layernorm_init(cfg, device=device,
                                         out=L._leaf(out, "mlp_norm")),
            "mlp": L.mlp_init(cfg, generator, device,
                              out=L._leaf(out, "mlp")),
        }
    return layer


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Seeded random params on ``device`` in the reference's tree, shapes
    and dtypes (``generator`` must live on ``device``)."""
    device = resolve_device(device)
    return {
        "embedding": L.embedding_init(cfg, generator, device),
        "enc_final_norm": L.layernorm_init(cfg, device=device),
        "dec_final_norm": L.layernorm_init(cfg, device=device),
        "enc_layers": stacked_init(_enc_layer_init(cfg), cfg.enc_layers,
                                   generator, device),
        "dec_layers": stacked_init(_dec_layer_init(cfg), cfg.n_layers,
                                   generator, device),
    }


def _layers(stacked, count):
    per = _tree_map(_unstack, stacked)
    for layer in range(count):
        yield _tree_map(lambda t: t[layer], per)


def encode(params, cfg: ModelConfig, frames: torch.Tensor,
           q_block=512, k_block=512) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frame embeddings (frontend stub)."""
    B, S, D = frames.shape
    x = (frames + sinusoid(S, D, device=frames.device)[None]).to(
        cfg.param_dtype)
    positions = torch.arange(S, device=frames.device)[None, :]

    def step(x, lp):
        z = L.layernorm(lp["attn_norm"], x, cfg.norm_eps)
        y, _ = L.attention_apply(
            lp["attn"], cfg, z, positions=positions, causal=False,
            q_block=q_block, k_block=k_block,
        )
        x = x + y
        z = L.layernorm(lp["mlp_norm"], x, cfg.norm_eps)
        return x + L.mlp_apply(lp["mlp"], cfg, z)

    step = L.scan_body(step, name="enc_layers")
    for lp in _layers(params["enc_layers"], cfg.enc_layers):
        x = step(x, lp)
    return L.layernorm(params["enc_final_norm"], x, cfg.norm_eps)


def _cross_kv(lp, cfg: ModelConfig, enc_out):
    B, T, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = dot(enc_out, lp["wk"]).reshape(B, T, kv, hd)
    v = dot(enc_out, lp["wv"]).reshape(B, T, kv, hd)
    if cfg.qkv_bias:
        k = k + lp["bk"].reshape(kv, hd)
        v = v + lp["bv"].reshape(kv, hd)
    return k, v


def _cross_apply(lp, cfg: ModelConfig, x, k, v):
    B, S, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = dot(x, lp["wq"]).reshape(B, S, h, hd)
    if cfg.qkv_bias:
        q = q + lp["bq"].reshape(h, hd)
    y = L.blockwise_attention(q, k, v, causal=False)
    return dot(y.reshape(B, S, -1), lp["wo"])


def _decoder(params, cfg: ModelConfig, tokens, enc_out=None, caches=None,
             positions=None, q_block=512, k_block=512, last_only=False):
    B, S = tokens.shape
    x = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :]
        x = x + sinusoid(S, cfg.d_model, device=x.device)[None].to(x.dtype)
    else:
        # per-sequence decode positions, computed directly (no table)
        ang = _angles(positions, cfg.d_model)
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        x = x + pe.to(x.dtype)

    def step(h, lp, lc):
        z = L.layernorm(lp["self_norm"], h, cfg.norm_eps)
        y, new_self = L.attention_apply(
            lp["self_attn"], cfg, z, positions=positions,
            cache=None if lc is None else lc["self"],
            q_block=q_block, k_block=k_block,
        )
        h = h + y
        z = L.layernorm(lp["cross_norm"], h, cfg.norm_eps)
        if enc_out is not None:  # train/prefill: compute (and cache) cross KV
            ck, cv = _cross_kv(lp["cross_attn"], cfg, enc_out)
        else:  # decode: reuse the prefill-cached cross KV
            ck, cv = lc["cross_k"], lc["cross_v"]
        h = h + _cross_apply(lp["cross_attn"], cfg, z, ck, cv)
        z = L.layernorm(lp["mlp_norm"], h, cfg.norm_eps)
        h = h + L.mlp_apply(lp["mlp"], cfg, z)
        return h, new_self, ck, cv

    step = L.scan_body(step, name="dec_layers",
                       remat_on=cfg.remat and caches is None)
    lens = []
    for layer, lp in enumerate(_layers(params["dec_layers"], cfg.n_layers)):
        lc = None
        if caches is not None:
            lc = {"self": {k: v[layer] for k, v in caches["self"].items()},
                  "cross_k": caches["cross_k"][layer],
                  "cross_v": caches["cross_v"][layer]}
        x, new_self, ck, cv = step(x, lp, lc)
        if caches is not None:
            lens.append(new_self["len"])
            if enc_out is not None:
                caches["cross_k"][layer] = ck
                caches["cross_v"][layer] = cv
    new_caches = None
    if caches is not None:
        new_caches = {"self": {"k": caches["self"]["k"],
                               "v": caches["self"]["v"],
                               "len": torch.stack(lens)},
                      "cross_k": caches["cross_k"],
                      "cross_v": caches["cross_v"]}
    if last_only:  # serving: only the next-token distribution is needed
        x = x[:, -1:]
    x = L.layernorm(params["dec_final_norm"], x, cfg.norm_eps)
    return L.logits(params["embedding"], cfg, x), new_caches


def forward(params, cfg: ModelConfig, frames, tokens, q_block=512,
            k_block=512):
    enc_out = encode(params, cfg, frames, q_block, k_block)
    logits_, _ = _decoder(params, cfg, tokens, enc_out=enc_out,
                          q_block=q_block, k_block=k_block)
    return logits_


def loss_fn(params, cfg: ModelConfig, frames, tokens, labels, **kw):
    return L.cross_entropy(forward(params, cfg, frames, tokens, **kw), labels)


def cache_init(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device="cpu") -> Dict:
    n = cfg.n_layers
    self_ = L.attention_cache_init(cfg, batch, max_len, device=device)
    cross = (n, batch, enc_len, cfg.n_kv_heads, cfg.hd)
    return {
        "self": {k: v.new_zeros((n, *v.shape)) for k, v in self_.items()},
        "cross_k": torch.zeros(cross, dtype=cfg.param_dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=cfg.param_dtype, device=device),
    }


def cache_axes(cfg: ModelConfig) -> Dict:
    """Logical axes tree matching cache_init's structure."""
    return {
        "self": {k: ("layers",) + tuple(v) for k, v in L.CACHE_AXES.items()},
        "cross_k": ("layers", "batch", "seq_kv", "kv", None),
        "cross_v": ("layers", "batch", "seq_kv", "kv", None),
    }


def prefill(params, cfg: ModelConfig, frames, tokens, max_len: int):
    B, S = tokens.shape
    enc_out = encode(params, cfg, frames)
    caches = cache_init(cfg, B, max_len, frames.shape[1],
                        device=tokens.device)
    # fill the cross KV by running the decoder once over the prompt
    return _decoder(params, cfg, tokens, enc_out=enc_out, caches=caches,
                    last_only=True)


def decode_step(params, cfg: ModelConfig, caches, tokens):
    pos = caches["self"]["len"][0]  # (B,)
    return _decoder(params, cfg, tokens, caches=caches,
                    positions=pos[:, None])
