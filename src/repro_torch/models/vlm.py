"""InternVL2-style VLM: a ViT frontend stub plus the LM backbone.

A port of the reference's ``models/vlm.py``.  The vision tower is not
modelled: the caller feeds precomputed patch embeddings (B, n_patch,
``VIT_DIM``).  This module owns only the projector (``VIT_DIM`` ->
d_model, a ``jnp.dot`` plus bias in the reference) and hands the language
backbone to ``transformer``; the image patches form a prefix of the
sequence (early fusion), so the KV cache holds ``n_patch`` positions
before the text.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from . import transformer as T

VIT_DIM = 1024  # InternViT-300M hidden size (stubbed frontend)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Dict:
    device = resolve_device(device)
    params = T.init(cfg, generator, device)
    params["projector"] = {
        "w": L._init(generator, (VIT_DIM, cfg.d_model), cfg.param_dtype,
                     device),
        "b": L._fill((cfg.d_model,), 0.0, cfg.param_dtype, device),
    }
    return params


def _project(params, patches: torch.Tensor) -> torch.Tensor:
    """The projector in f32: ``dot(patches, w, preferred=f32) + b``."""
    p = params["projector"]
    return torch.matmul(patches.to(L.F32), p["w"].to(L.F32)) + p["b"]


def _embed(params, cfg: ModelConfig, tokens, patches) -> torch.Tensor:
    img = _project(params, patches).to(cfg.param_dtype)
    txt = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
    return torch.cat([img, txt], dim=1)


def forward(params, cfg: ModelConfig, tokens, patches, q_block=512,
            k_block=512):
    """tokens (B, S_text), patches (B, n_patch, VIT_DIM) -> logits on the
    text span."""
    S_text = tokens.shape[1]
    x = _embed(params, cfg, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = T._run_segments(params, cfg, x, positions=positions,
                           q_block=q_block, k_block=k_block)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.logits(params["embedding"], cfg, x)[:, -S_text:]


def loss_fn(params, cfg: ModelConfig, tokens, patches, labels, **kw):
    return L.cross_entropy(forward(params, cfg, tokens, patches, **kw),
                           labels)


def prefill(params, cfg: ModelConfig, tokens, patches, max_len: int):
    """The image prefix and the prompt into a ``max_len`` cache, which must
    hold both (a prefill that overruns it raises)."""
    x = _embed(params, cfg, tokens, patches)
    B, S = x.shape[:2]
    caches = T.cache_init(cfg, B, max_len, device=x.device)
    positions = torch.arange(S, device=x.device)[None, :]
    x, new_caches = T._run_segments(params, cfg, x, positions=positions,
                                    caches=caches)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.logits(params["embedding"], cfg, x), new_caches


decode_step = T.decode_step  # identical once the cache holds the image prefix
cache_init = T.cache_init
cache_axes = T.cache_axes
