"""Decoder-only LM covering the dense and MoE families: init, KV caches,
prefill and decode.

A port of the reference's ``models/transformer.py``.  Layers keep the
reference's *segment* layout (``segment_plan``):

  dense arch            ->  [ (('dense',), L) ]
  kimi-style MoE        ->  [ (('dense',), first_dense), (('moe',), L-fd) ]
  llama4-style MoE      ->  [ (('dense','moe'), L//2) ]   (interleaved)

Each segment's parameters and caches are stacked along a leading
``layers`` axis (``params["seg0"]["dense"]["attn"]["wq"]`` is
``(layers, d_model, heads * hd)``), and ``_run_segments`` walks that axis
in a Python loop where the reference uses ``lax.scan``.  The stacked caches
are updated in place (``layers.attention_apply``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from .moe import moe_apply, moe_init


# --------------------------------------------------------------------------
# nested-dict helpers (the reference's pytree maps)
# --------------------------------------------------------------------------


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------
# segment plan + params
# --------------------------------------------------------------------------


def segment_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense and MoE "
            f"families; the others come with ROADMAP.md queue A item 6"
        )
    if cfg.family == "dense":
        return [(("dense",), cfg.n_layers)]
    m = cfg.moe
    plan: List[Tuple[Tuple[str, ...], int]] = []
    rest = cfg.n_layers
    if m.first_dense:
        plan.append((("dense",), m.first_dense))
        rest -= m.first_dense
    if m.moe_every == 1:
        plan.append((("moe",), rest))
    elif m.moe_every == 2:
        if rest % 2:
            raise ValueError(f"moe_every=2 needs an even number of layers "
                             f"after the dense ones, got {rest}")
        plan.append((("dense", "moe"), rest // 2))
    else:
        raise NotImplementedError(f"moe_every={m.moe_every}")
    return plan


def _layer_init(cfg: ModelConfig, kind: str, generator, device, out=None):
    """One layer of ``kind``; with ``out`` (this layer's views into the
    stacked leaves) every leaf is drawn straight into its view."""
    d_ff = cfg.d_ff
    if kind == "dense" and cfg.moe is not None and cfg.moe.dense_ff:
        d_ff = cfg.moe.dense_ff
    p = {
        "attn_norm": L.rmsnorm_init(cfg, device=device,
                                    out=L._leaf(out, "attn_norm")),
        "attn": L.attention_init(cfg, generator, device,
                                 out=L._leaf(out, "attn")),
        "mlp_norm": L.rmsnorm_init(cfg, device=device,
                                   out=L._leaf(out, "mlp_norm")),
    }
    if kind == "moe":
        p["moe"] = moe_init(cfg, generator, device, out=L._leaf(out, "moe"))
    else:
        p["mlp"] = L.mlp_init(cfg, generator, device, d_ff=d_ff,
                              out=L._leaf(out, "mlp"))
    return p


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Dict:
    """Seeded random params on ``device``, in the reference's tree, shapes,
    dtypes and scales (``generator`` must live on ``device``).

    Each stacked leaf is allocated once (its shape from a pass on the meta
    device) and every layer is drawn straight into its slice of it, so the
    peak is the model plus one leaf's f32 draw (one expert slab for the
    MoE stacks).
    """
    device = resolve_device(device)
    params: Dict = {
        "embedding": L.embedding_init(cfg, generator, device),
        "final_norm": L.rmsnorm_init(cfg, device=device),
    }
    meta = torch.device("meta")
    for si, (pattern, count) in enumerate(segment_plan(cfg)):
        seg = {
            kind: _tree_map(
                lambda t: torch.empty((count, *t.shape), dtype=t.dtype,
                                      device=device),
                _layer_init(cfg, kind, None, meta),
            )
            for kind in pattern
        }
        for layer in range(count):
            for kind in pattern:
                _layer_init(cfg, kind, generator, device,
                            out=_tree_map(lambda t: t[layer], seg[kind]))
        params[f"seg{si}"] = seg
    return params


#: leaves the reference keeps in float32 whatever ``cfg.dtype`` is
_F32_LEAVES = ("scale", "q_norm", "k_norm", "router")


def params_from_reference(cfg: ModelConfig, tree, device="cuda") -> Dict:
    """The reference's params (the same tree, leaves as numpy arrays) as
    the port's tensors: weights in ``cfg.param_dtype``, norm scales and the
    MoE router in float32, on ``device``."""
    device = resolve_device(device)

    def convert(tree, name=None):
        if isinstance(tree, dict):
            return {k: convert(v, k) for k, v in tree.items()}
        dt = torch.float32 if name in _F32_LEAVES else cfg.param_dtype
        return torch.tensor(np.asarray(tree, dtype=np.float32), dtype=dt,
                            device=device)

    return convert(tree)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _block(lp, cfg: ModelConfig, kind: str, x, *, positions, cache=None,
           q_block=512, k_block=512, lengths=None):
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    y, new_cache = L.attention_apply(
        lp["attn"], cfg, h,
        positions=positions, cache=cache,
        q_block=q_block, k_block=k_block, lengths=lengths,
    )
    x = x + y
    h = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    if kind == "moe":
        return x + moe_apply(lp["moe"], cfg, h), new_cache
    return x + L.mlp_apply(lp["mlp"], cfg, h), new_cache


def _run_segments(params, cfg: ModelConfig, x, *, positions, caches=None,
                  q_block=512, k_block=512, lengths=None):
    """caches: same segment structure, stacked; returns (x, new_caches).

    K/V are written into ``caches`` in place; ``new_caches`` carries the
    same K/V tensors with the per-layer lengths stacked anew.
    """
    new_caches: Dict = {}
    for si, (pattern, count) in enumerate(segment_plan(cfg)):
        seg = params[f"seg{si}"]
        seg_cache = None if caches is None else caches[f"seg{si}"]
        lens: Dict[str, list] = {kind: [] for kind in pattern}
        for layer in range(count):
            for kind in pattern:
                lp = _tree_map(lambda t: t[layer], seg[kind])
                c = (None if seg_cache is None
                     else _tree_map(lambda t: t[layer], seg_cache[kind]))
                x, nc = _block(
                    lp, cfg, kind, x, positions=positions, cache=c,
                    q_block=q_block, k_block=k_block, lengths=lengths,
                )
                if nc is not None:
                    lens[kind].append(nc["len"])
        if seg_cache is not None:
            new_caches[f"seg{si}"] = {
                kind: {"k": seg_cache[kind]["k"], "v": seg_cache[kind]["v"],
                       "len": torch.stack(lens[kind])}
                for kind in pattern
            }
    return x, (new_caches if caches is not None else None)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               device="cpu") -> Dict:
    caches: Dict = {}
    for si, (pattern, count) in enumerate(segment_plan(cfg)):
        one = L.attention_cache_init(cfg, batch, max_len, device=device)
        caches[f"seg{si}"] = {
            kind: {k: v.new_zeros((count, *v.shape)) for k, v in one.items()}
            for kind in pattern
        }
    return caches


def _first_cache_len(caches) -> torch.Tensor:
    for seg in caches.values():
        for kind in seg.values():
            return kind["len"][0]  # strip the stacked-layers axis
    raise ValueError("no attention cache found")


def decode_step(params, cfg: ModelConfig, caches, tokens):
    """One-token decode: tokens (B, 1); caches hold the context."""
    x = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
    # current position per sequence = cache length (same for every layer)
    positions = _first_cache_len(caches)[:, None]
    x, new_caches = _run_segments(
        params, cfg, x, positions=positions, caches=caches
    )
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.logits(params["embedding"], cfg, x), new_caches


def prefill(params, cfg: ModelConfig, tokens, max_len: int, lengths=None):
    """Prefill: forward over the prompt, building the KV caches.

    ``lengths`` (B,) declares right-padded prompts: positions past each
    row's true length are excluded from attention, the caches start at the
    true lengths, and the returned logits come from each row's last *real*
    position.  Only that position is unembedded.
    """
    B, S = tokens.shape
    caches = cache_init(cfg, B, max_len, device=tokens.device)
    x = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
    positions = torch.arange(S, device=tokens.device)[None, :]
    x, new_caches = _run_segments(
        params, cfg, x, positions=positions, caches=caches, lengths=lengths
    )
    if lengths is None:
        x_last = x[:, -1:]
    else:
        idx = torch.clamp(lengths.to(torch.long) - 1, 0, S - 1)
        x_last = x[torch.arange(B, device=x.device), idx][:, None]
    x = L.rmsnorm(params["final_norm"], x_last, cfg.norm_eps)
    return L.logits(params["embedding"], cfg, x), new_caches
