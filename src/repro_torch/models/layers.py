"""Shared model layers of the dense and MoE families: norms, rotary, GQA
attention (blockwise online-softmax prefill path + cached decode path), the
MLP, embeddings and logits.

A port of the reference's ``models/layers.py``: parameter trees are nested
dicts of tensors with the reference's names, shapes, dtypes and layouts
(``(B, S, heads, hd)`` activations), so ``transformer.params_from_reference``
can carry the reference's weights across unchanged.  Attention is plain
PyTorch, as it is plain JAX in the reference; every projection and MLP
product goes through ``ops.dense``.  Norms, rotary and softmax compute in
float32 as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..configs.base import ModelConfig

F32 = torch.float32
NEG_INF = -1e30


def _init(generator: torch.Generator, shape: Tuple[int, ...], dtype,
          device, scale: Optional[float] = None,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N(0, 1) * scale drawn in f32 and cast, scale 1/sqrt(fan-in) by
    default — the reference's ``_init``.

    With ``out`` (a view into a stacked leaf, see ``transformer.init``)
    the draw is written into it and ``out`` is returned.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, device=device, dtype=F32)
    w = w.mul_(scale).to(dtype)
    return w if out is None else out.copy_(w)


def _fill(shape, value: float, dtype, device,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A constant leaf (norm scales, biases), or ``out`` filled with it."""
    if out is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    return out.fill_(value)


def _leaf(out: Optional[Dict], name: str) -> Optional[torch.Tensor]:
    return None if out is None else out[name]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(cfg: ModelConfig, dim=None, device="cpu", out=None):
    dim = dim or cfg.d_model
    return {"scale": _fill((dim,), 1.0, F32, device, _leaf(out, "scale"))}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.to(F32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    out = h * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, N, hd), positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = torch.arange(0, half, dtype=F32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=x.device),
                            exponent)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(F32) * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_init(cfg: ModelConfig, generator: torch.Generator, device,
                   out=None):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    p = {
        "wq": _init(generator, (d, h * hd), dt, device, out=_leaf(out, "wq")),
        "wk": _init(generator, (d, kv * hd), dt, device,
                    out=_leaf(out, "wk")),
        "wv": _init(generator, (d, kv * hd), dt, device,
                    out=_leaf(out, "wv")),
        "wo": _init(generator, (h * hd, d), dt, device, out=_leaf(out, "wo")),
    }
    if cfg.qkv_bias:
        p["bq"] = _fill((h * hd,), 0.0, dt, device, _leaf(out, "bq"))
        p["bk"] = _fill((kv * hd,), 0.0, dt, device, _leaf(out, "bk"))
        p["bv"] = _fill((kv * hd,), 0.0, dt, device, _leaf(out, "bv"))
    if cfg.qk_norm:
        p["q_norm"] = _fill((hd,), 1.0, F32, device, _leaf(out, "q_norm"))
        p["k_norm"] = _fill((hd,), 1.0, F32, device, _leaf(out, "k_norm"))
    return p


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.to(F32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _project_qkv(params, cfg: ModelConfig, x: torch.Tensor, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x2 = x.reshape(B * S, -1)
    q = ops.dense(x2, params["wq"]).reshape(B, S, h, hd)
    k = ops.dense(x2, params["wk"]).reshape(B, S, kv, hd)
    v = ops.dense(x2, params["wv"]).reshape(B, S, kv, hd)
    if cfg.qkv_bias:
        q = q + params["bq"].reshape(h, hd)
        k = k + params["bk"].reshape(kv, hd)
        v = v + params["bv"].reshape(kv, hd)
    if cfg.qk_norm:
        q = _qk_norm(q, params["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KV, hd)
    v: torch.Tensor,  # (B, T, KV, hd)
    *,
    causal: bool = True,
    q_block: int = 512,
    k_block: int = 512,
    kv_lengths: Optional[torch.Tensor] = None,  # (B,) valid key counts
) -> torch.Tensor:
    """Flash-style online-softmax attention in plain PyTorch.

    The key/value sequence is cut into ``k_block`` blocks and the softmax
    reduction regrouped over them with a running max and sum; a Python
    loop over query and key blocks stands in for the reference's
    ``vmap``/``lax.scan``.  ``kv_lengths`` masks keys at positions >= the
    per-sequence length (right-padded prefill).
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    # snap block sizes to divisors of the sequence lengths
    q_block = math.gcd(S, min(q_block, S))
    k_block = math.gcd(T, min(k_block, T))
    nq, nk = S // q_block, T // k_block
    scale = hd ** -0.5
    dev = q.device

    if nq == 1 and nk == 1 and kv_lengths is None:
        # single block: one unblocked softmax-attention, numerically the
        # blockwise path at nq == nk == 1 (same f32 math, no rescale step)
        qh = q.permute(0, 2, 1, 3).reshape(B * H, S, hd)
        kx = k if G == 1 else k.repeat_interleave(G, dim=2)
        vx = v if G == 1 else v.repeat_interleave(G, dim=2)
        kh = kx.permute(0, 2, 1, 3).reshape(B * H, T, hd)
        vh = vx.permute(0, 2, 1, 3).reshape(B * H, T, hd)
        s = torch.einsum("hsd,htd->hst", qh.to(F32), kh.to(F32)) * scale
        if causal:
            row = torch.arange(S, device=dev)[:, None]
            col = torch.arange(T, device=dev)[None, :]
            s = torch.where(col <= row, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        num = torch.einsum("hst,hte->hse", p, vh.to(F32))
        out = num / p.sum(dim=-1, keepdim=True)
        out = out.reshape(B, H, S, hd).permute(0, 2, 1, 3)
        return out.to(q.dtype)

    qs = q.reshape(B, nq, q_block, KV, G, hd)
    ks = k.reshape(B, nk, k_block, KV, hd)
    vs = v.reshape(B, nk, k_block, KV, hd)
    outs = []
    for qi in range(nq):
        qc = qs[:, qi].to(F32)  # (B, qb, KV, G, hd)
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B, KV, G, q_block), dtype=F32, device=dev)
        acc = torch.zeros((B, KV, G, q_block, hd), dtype=F32, device=dev)
        for ki in range(nk):
            s = torch.einsum(
                "bqkgh,bpkh->bkgqp", qc, ks[:, ki].to(F32)
            ) * scale
            k_pos = ki * k_block + torch.arange(k_block, device=dev)
            if causal:
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask, s, NEG_INF)
            if kv_lengths is not None:
                valid = k_pos[None, :] < kv_lengths[:, None]  # (B, kb)
                s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqp,bpkh->bkgqh", p, vs[:, ki].to(F32)
            )
            m = m_new
        outs.append(acc / l[..., None])  # (B, KV, G, qb, hd)
    out = torch.stack(outs, dim=1)  # (B, nq, KV, G, qb, hd)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, hd)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, T, KV, hd)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) valid lengths (including current token)
) -> torch.Tensor:
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum(
        "bkgh,btkh->bkgt", qg.to(F32), k_cache.to(F32)
    ) * scale
    valid = torch.arange(T, device=q.device)[None, :] < cache_len[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v_cache.to(F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention_apply(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    cache: Optional[Dict] = None,
    q_block: int = 512,
    k_block: int = 512,
    lengths: Optional[torch.Tensor] = None,
):
    """Returns (y, new_cache).  cache = {k, v, len} for decode / prefill.

    Unlike the reference, which rebuilds the cache functionally, the
    port writes the new K/V rows into ``cache["k"]``/``cache["v"]`` IN
    PLACE (they are views into the stacked per-layer cache, hundreds of
    MB at full width); ``new_cache`` holds the same tensors and the new
    lengths.  ``lengths`` (B,) marks right-padded prefill: keys past each
    sequence's true length are masked and ``len`` starts at the true
    length, so decode overwrites the first pad slot.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    if cache is None:
        y = blockwise_attention(
            q, k, v, causal=causal, q_block=q_block, k_block=k_block,
            kv_lengths=lengths,
        )
        new_cache = None
    elif S == 1:
        idx = cache["len"]  # (B,) current write positions
        bidx = torch.arange(B, device=x.device)
        cache["k"][bidx, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, idx] = v[:, 0].to(cache["v"].dtype)
        y = decode_attention(q, cache["k"], cache["v"], idx + 1)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + 1}
    else:
        # prefill into an empty cache
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
        y = blockwise_attention(
            q, k, v, causal=causal, q_block=q_block, k_block=k_block,
            kv_lengths=lengths,
        )
        new_cache = {
            "k": cache["k"], "v": cache["v"],
            "len": (torch.full((B,), S, dtype=torch.long, device=x.device)
                    if lengths is None else lengths.to(torch.long)),
        }
    y = ops.dense(y.reshape(B * S, -1), params["wo"]).reshape(B, S, -1)
    return y, new_cache


def attention_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                         dtype=None, device="cpu"):
    dtype = dtype or cfg.param_dtype
    kv, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.long, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(cfg: ModelConfig, generator: torch.Generator, device, d_ff=None,
             out=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    if cfg.act == "silu":  # SwiGLU
        return {
            "w_gate": _init(generator, (d, f), dt, device,
                            out=_leaf(out, "w_gate")),
            "w_up": _init(generator, (d, f), dt, device,
                          out=_leaf(out, "w_up")),
            "w_down": _init(generator, (f, d), dt, device,
                            out=_leaf(out, "w_down")),
        }
    return {  # plain 2-layer (gelu)
        "w1": _init(generator, (d, f), dt, device, out=_leaf(out, "w1")),
        "b1": _fill((f,), 0.0, dt, device, _leaf(out, "b1")),
        "w2": _init(generator, (f, d), dt, device, out=_leaf(out, "w2")),
        "b2": _fill((d,), 0.0, dt, device, _leaf(out, "b2")),
    }


def mlp_apply(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    B, S, D = x.shape
    h = x.reshape(B * S, D)
    if cfg.act == "silu":
        g = ops.dense(h, params["w_gate"])
        u = ops.dense(h, params["w_up"])
        out = ops.dense(F.silu(g.to(F32)).to(x.dtype) * u, params["w_down"])
    else:
        # the reference's jax.nn.gelu is the tanh approximation
        h1 = F.gelu(
            (ops.dense(h, params["w1"]) + params["b1"]).to(F32),
            approximate="tanh",
        ).to(x.dtype)
        out = ops.dense(h1, params["w2"]) + params["b2"]
    return out.reshape(B, S, D)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def embedding_init(cfg: ModelConfig, generator: torch.Generator, device):
    dt = cfg.param_dtype
    p = {"tok": _init(generator, (cfg.vocab, cfg.d_model), dt, device,
                      scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = _init(generator, (cfg.d_model, cfg.vocab), dt, device)
    return p


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits, as the reference's ``preferred_element_type=f32``:
    a bf16 product here would round the logits and move greedy ties."""
    B, S, D = x.shape
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return torch.matmul(x.reshape(B * S, D).to(F32), w.to(F32)).reshape(
        B, S, -1
    )
