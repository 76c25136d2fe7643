"""SSM and hybrid (Zamba2-style) language models.

A port of the reference's ``models/hybrid.py``:

``family == 'ssm'``    : a pure Mamba2 stack (mamba2-130m).
``family == 'hybrid'`` : a Mamba2 backbone with one SHARED attention + MLP
block applied after every ``cfg.attn_every`` SSM layers (Zamba2's
weight-shared global block, arXiv:2411.15242).  The shared block's KV
cache is per *application site*, not per weight copy.

The SSM layers are stacked along a leading ``layers`` axis
(``params["ssm_layers"]["ssm"]["in_proj"]`` is ``(layers, d_model,
in_dim)``) and walked in a Python loop where the reference uses
``lax.scan``; a leaf of the weight-only serving tier is expanded one layer
at a time (``transformer._unstack``).  The shared block's projections and
MLP go through ``ops.dense`` (``layers.attention_apply`` /
``layers.mlp_apply``).  Caches are updated in place: the SSM states and
conv tails per layer, the attention K/V per site.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from .ssm import SSM_CACHE_AXES, ssm_apply, ssm_cache_init, ssm_init
from .transformer import _tree_map, _unstack, stacked_init


def _n_shared_sites(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _ssm_layer_init(cfg: ModelConfig):
    def layer(generator, device, out):
        return {
            "norm": L.rmsnorm_init(cfg, device=device,
                                   out=L._leaf(out, "norm")),
            "ssm": ssm_init(cfg, generator, device, out=L._leaf(out, "ssm")),
        }
    return layer


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Dict:
    """Seeded random params on ``device`` in the reference's tree, shapes
    and dtypes (``generator`` must live on ``device``)."""
    device = resolve_device(device)
    params: Dict = {
        "embedding": L.embedding_init(cfg, generator, device),
        "final_norm": L.rmsnorm_init(cfg, device=device),
        "ssm_layers": stacked_init(_ssm_layer_init(cfg), cfg.n_layers,
                                   generator, device),
    }
    if cfg.attn_every:
        params["shared"] = {
            "attn_norm": L.rmsnorm_init(cfg, device=device),
            "attn": L.attention_init(cfg, generator, device),
            "mlp_norm": L.rmsnorm_init(cfg, device=device),
            "mlp": L.mlp_init(cfg, generator, device),
        }
    return params


def _shared_block(params, cfg: ModelConfig, x, *, positions, cache,
                  q_block=512, k_block=512):
    h = L.rmsnorm(params["attn_norm"], x, cfg.norm_eps)
    y, new_cache = L.attention_apply(
        params["attn"], cfg, h, positions=positions, cache=cache,
        q_block=q_block, k_block=k_block,
    )
    x = x + y
    h = L.rmsnorm(params["mlp_norm"], x, cfg.norm_eps)
    return x + L.mlp_apply(params["mlp"], cfg, h), new_cache


def _ssm_step(cfg: ModelConfig):
    def step(h, lp, lc):
        hn = L.rmsnorm(lp["norm"], h, cfg.norm_eps)
        y, nc = ssm_apply(lp["ssm"], cfg, hn, cache=lc)
        return h + y, nc
    return step


def _run(params, cfg: ModelConfig, x, *, positions, caches=None,
         q_block=512, k_block=512):
    """caches: {'ssm': stacked per layer, 'attn': stacked per site};
    returns (x, new_caches), the caches written in place."""
    ae = cfg.attn_every or cfg.n_layers
    groups = cfg.n_layers // ae if cfg.attn_every else 1
    layers = _tree_map(_unstack, params["ssm_layers"])
    step = L.scan_body(_ssm_step(cfg), name="ssm_layers",
                       remat_on=cfg.remat and caches is None)
    site_lens = []
    for g in range(groups):
        lo, hi = g * ae, min((g + 1) * ae, cfg.n_layers)
        for layer in range(lo, hi):
            lp = _tree_map(lambda t: t[layer], layers)
            lc = (None if caches is None
                  else {k: v[layer] for k, v in caches["ssm"].items()})
            x, nc = step(x, lp, lc)
            if caches is not None:
                for k, v in nc.items():
                    caches["ssm"][k][layer] = v
        if cfg.attn_every:
            site_cache = (None if caches is None else
                          {k: v[g] for k, v in caches["attn"].items()})
            x, site_new = _shared_block(
                params["shared"], cfg, x, positions=positions,
                cache=site_cache, q_block=q_block, k_block=k_block,
            )
            if caches is not None:
                site_lens.append(site_new["len"])
    if caches is None:
        return x, None
    new_caches = {"ssm": caches["ssm"]}
    if cfg.attn_every:
        new_caches["attn"] = {"k": caches["attn"]["k"],
                              "v": caches["attn"]["v"],
                              "len": torch.stack(site_lens)}
    return x, new_caches


def forward(params, cfg: ModelConfig, tokens, *, q_block=512, k_block=512):
    x = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x, _ = _run(params, cfg, x, positions=positions,
                q_block=q_block, k_block=k_block)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.logits(params["embedding"], cfg, x)


def loss_fn(params, cfg: ModelConfig, tokens, labels, **kw):
    return L.cross_entropy(forward(params, cfg, tokens, **kw), labels)


def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               device="cpu") -> Dict:
    one = ssm_cache_init(cfg, batch, device=device)
    caches: Dict = {
        "ssm": {k: v.new_zeros((cfg.n_layers, *v.shape))
                for k, v in one.items()},
    }
    if cfg.attn_every:
        site = L.attention_cache_init(cfg, batch, max_len, device=device)
        caches["attn"] = {k: v.new_zeros((_n_shared_sites(cfg), *v.shape))
                          for k, v in site.items()}
    return caches


def cache_axes(cfg: ModelConfig) -> Dict:
    """Logical axes tree matching cache_init's structure."""
    axes: Dict = {
        "ssm": {k: ("layers",) + tuple(v) for k, v in SSM_CACHE_AXES.items()}
    }
    if cfg.attn_every:
        axes["attn"] = {
            k: ("layers",) + tuple(v) for k, v in L.CACHE_AXES.items()
        }
    return axes


def decode_step(params, cfg: ModelConfig, caches, tokens):
    """One-token decode: tokens (B, 1); caches hold the states."""
    x = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
    if cfg.attn_every:
        pos = caches["attn"]["len"][0]  # (B,)
    else:
        pos = torch.zeros((tokens.shape[0],), dtype=torch.long,
                          device=tokens.device)
    x, new_caches = _run(params, cfg, x, positions=pos[:, None],
                         caches=caches)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.logits(params["embedding"], cfg, x), new_caches


def prefill(params, cfg: ModelConfig, tokens, max_len: int):
    B, S = tokens.shape
    caches = cache_init(cfg, B, max_len, device=tokens.device)
    x = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
    positions = torch.arange(S, device=tokens.device)[None, :]
    x, new_caches = _run(params, cfg, x, positions=positions, caches=caches)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.logits(params["embedding"], cfg, x), new_caches
