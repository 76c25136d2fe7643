"""Decoder-only LM covering the dense and MoE families (and the language
backbone of the vision-language model): init, the training forward and
loss, KV caches, prefill and decode.

A port of the reference's ``models/transformer.py``.  Layers keep the
reference's *segment* layout (``segment_plan``):

  dense arch            ->  [ (('dense',), L) ]
  kimi-style MoE        ->  [ (('dense',), first_dense), (('moe',), L-fd) ]
  llama4-style MoE      ->  [ (('dense','moe'), L//2) ]   (interleaved)

Each segment's parameters and caches are stacked along a leading
``layers`` axis (``params["seg0"]["dense"]["attn"]["wq"]`` is
``(layers, d_model, heads * hd)``), and ``_run_segments`` walks that axis
in a Python loop where the reference uses ``lax.scan``, taking the layers
of each stacked leaf with one ``unbind`` (a leaf quantized for weight-only
serving is expanded one layer at a time instead).  The stacked caches are updated
in place (``layers.attention_apply``).  ``params_from_reference`` and
``opt_state_from_reference`` carry the reference's weights and optimizer
state across as numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..dtensor import is_dtensor
from ..optim.quant import Quantized, QuantizedLayers
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
    """The reference's rule: every family but MoE is one dense segment."""
    if cfg.family != "moe":
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


def stacked_init(layer_init: Callable, count: int, generator,
                 device) -> Dict:
    """``count`` layers of ``layer_init(generator, device, out)`` stacked
    along a leading axis: each leaf allocated once (its shape from a pass
    on the meta device) and every layer drawn straight into its slice."""
    tree = _tree_map(
        lambda t: torch.empty((count, *t.shape), dtype=t.dtype,
                              device=device),
        layer_init(None, torch.device("meta"), None),
    )
    if torch.device(device).type == "meta":  # shapes only
        return tree
    for layer in range(count):
        layer_init(generator, device,
                   _tree_map(lambda t: t[layer], tree))
    return tree


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Dict:
    """Seeded random params on ``device``, in the reference's tree, shapes,
    dtypes and scales (``generator`` must live on ``device``).

    Each stacked leaf is allocated once and every layer is drawn straight
    into its slice of it (``stacked_init``), so the peak is the model plus
    one leaf's f32 draw (one expert slab for the MoE stacks).
    """
    device = resolve_device(device)
    params: Dict = {
        "embedding": L.embedding_init(cfg, generator, device),
        "final_norm": L.rmsnorm_init(cfg, device=device),
    }
    for si, (pattern, count) in enumerate(segment_plan(cfg)):
        params[f"seg{si}"] = stacked_init(
            lambda g, d, out, pattern=pattern: {
                kind: _layer_init(cfg, kind, g, d, out=L._leaf(out, kind))
                for kind in pattern},
            count, generator, device)
    return params


def params_from_reference(cfg: ModelConfig, tree, device="cuda") -> Dict:
    """The reference's params (the same tree, leaves as numpy arrays of
    the reference's dtypes) as the port's tensors on ``device``: float32
    where the array is float32 (norm scales and biases, the MoE router,
    the SSM's decay, skip, step bias and gated-norm scale),
    ``cfg.param_dtype`` where it is another float type."""
    device = resolve_device(device)

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        arr = np.asarray(tree)
        dt = torch.float32 if arr.dtype == np.float32 else cfg.param_dtype
        return torch.tensor(arr.astype(np.float32), dtype=dt, device=device)

    return convert(tree)


def opt_state_from_reference(state, device="cuda"):
    """The reference's ``AdamWState`` (``step``, ``m``, ``v``; leaves as
    numpy arrays, moments ``Quantized`` for ``moments_dtype='int8'``) as
    the port's ``optim.AdamWState`` on ``device``.  f32 and bf16 moments
    keep their dtype; a quantized moment keeps its int8 payload, f32
    scales, shape and dtype, bit for bit."""
    from ..optim import AdamWState, Quantized

    device = resolve_device(device)

    def moment(leaf):
        if isinstance(leaf, dict):
            return {k: moment(v) for k, v in leaf.items()}
        if hasattr(leaf, "q"):
            return Quantized(
                q=torch.tensor(np.asarray(leaf.q), dtype=torch.int8,
                               device=device),
                scale=torch.tensor(np.asarray(leaf.scale, np.float32),
                                   device=device),
                shape=tuple(int(d) for d in leaf.shape),
                dtype=getattr(torch, np.dtype(leaf.dtype).name),
            )
        arr = np.asarray(leaf)
        return torch.tensor(arr.astype(np.float32),
                            dtype=getattr(torch, arr.dtype.name),
                            device=device)

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        m=moment(state.m),
        v=moment(state.v),
    )


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _block(lp, cfg: ModelConfig, kind: str, x, *, positions, cache=None,
           q_block=512, k_block=512, lengths=None):
    # entered here as well as in ``forward``: a checkpointed layer is
    # recomputed in the backward, outside the forward's context
    with L.sharded_ops(lp):
        return _block_body(lp, cfg, kind, x, positions=positions,
                           cache=cache, q_block=q_block, k_block=k_block,
                           lengths=lengths)


def _block_body(lp, cfg: ModelConfig, kind: str, x, *, positions,
                cache=None, q_block=512, k_block=512, lengths=None):
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    y, new_cache = L.attention_apply(
        lp["attn"], cfg, h,
        positions=positions, cache=cache,
        q_block=q_block, k_block=k_block, lengths=lengths,
    )
    x = _residual(x + y)
    h = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    if kind == "moe":
        return _residual(x + moe_apply(lp["moe"], cfg, h)), new_cache
    return _residual(x + L.mlp_apply(lp["mlp"], cfg, h)), new_cache


def _residual(x):
    """The residual stream on the reference's layout where it is a
    DTensor: batch over ``pod`` / ``data``, whole on ``model`` (DTensor
    would sum a ``Partial`` branch into a sequence-sharded stream, whose
    flattened rows come back strided)."""
    if not is_dtensor(x):
        return x
    from ..dtensor import batch_placements, to_placements

    return to_placements(x, x.device_mesh,
                         batch_placements(x.device_mesh, x.shape[0]))


def _unstack(t):
    """The layers of a stacked leaf: ``unbind(0)`` views of a tensor, or,
    for a leaf of the weight-only serving tier, a sequence that expands
    one layer when it is taken (``optim.quant.QuantizedLayers``)."""
    if isinstance(t, Quantized):
        return QuantizedLayers(t)
    return t.unbind(0)


def _run_segments(params, cfg: ModelConfig, x, *, positions, caches=None,
                  q_block=512, k_block=512, lengths=None):
    """caches: same segment structure, stacked; returns (x, new_caches).

    K/V are written into ``caches`` in place; ``new_caches`` carries the
    same K/V tensors with the per-layer lengths stacked anew.
    """
    new_caches: Dict = {}
    for si, (pattern, count) in enumerate(segment_plan(cfg)):
        # one unbind per stacked leaf: its backward stacks the per-layer
        # grads once, where t[layer] would allocate a zero tensor the size
        # of the whole leaf for every layer
        seg = {kind: _tree_map(_unstack, params[f"seg{si}"][kind])
               for kind in pattern}
        seg_cache = None if caches is None else caches[f"seg{si}"]
        lens: Dict[str, list] = {kind: [] for kind in pattern}

        def step(h, lps, layer, pattern=pattern, seg_cache=seg_cache,
                 lens=lens):
            for kind in pattern:
                c = (None if seg_cache is None
                     else _tree_map(lambda t: t[layer], seg_cache[kind]))
                h, nc = _block(
                    lps[kind], cfg, kind, h, positions=positions, cache=c,
                    q_block=q_block, k_block=k_block, lengths=lengths,
                )
                if nc is not None:
                    lens[kind].append(nc["len"])
            return h

        step = L.scan_body(step, name=f"seg{si}",
                           remat_on=cfg.remat and caches is None)
        for layer in range(count):
            lps = {kind: _tree_map(lambda t: t[layer], seg[kind])
                   for kind in pattern}
            x = step(x, lps, layer)
        if seg_cache is not None:
            new_caches[f"seg{si}"] = {
                kind: {"k": seg_cache[kind]["k"], "v": seg_cache[kind]["v"],
                       "len": torch.stack(lens[kind])}
                for kind in pattern
            }
    return x, (new_caches if caches is not None else None)


def forward(params, cfg: ModelConfig, tokens, *, q_block=512, k_block=512):
    """Training forward without cache: tokens (B, S) -> f32 logits
    (B, S, vocab).  With ``cfg.remat`` each layer step is checkpointed
    (``layers.remat``) and recomputed in the backward, as the reference
    wraps its scan body.  DTensor parameters run it sharded
    (``layers.sharded_ops``)."""
    with L.sharded_ops(params):
        x = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        x, _ = _run_segments(params, cfg, x, positions=positions,
                             q_block=q_block, k_block=k_block)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return L.logits(params["embedding"], cfg, x)


def loss_fn(params, cfg: ModelConfig, tokens, labels, **kw):
    lg = forward(params, cfg, tokens, **kw)
    with L.sharded_ops(params):
        return L.cross_entropy(lg, labels)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def cache_init(cfg: ModelConfig, batch: int, max_len: int,
               device="cpu", like=None) -> Dict:
    """Zero KV caches; where ``like`` (the step's tokens) is a DTensor, as
    DTensors on its mesh placed by the reference's cache rules
    (``launch.steps.cache_shardings``), each rank allocating its shard."""
    if is_dtensor(like):
        return _sharded_cache_init(cfg, batch, max_len, like.device_mesh)
    caches: Dict = {}
    for si, (pattern, count) in enumerate(segment_plan(cfg)):
        one = L.attention_cache_init(cfg, batch, max_len, device=device)
        caches[f"seg{si}"] = {
            kind: {k: v.new_zeros((count, *v.shape)) for k, v in one.items()}
            for kind in pattern
        }
    return caches


def _sharded_cache_init(cfg: ModelConfig, batch: int, max_len: int, dm):
    from torch.distributed import tensor as dt

    from ..launch.mesh import MeshShape
    from ..launch.steps import cache_shardings
    from .api import get_api

    mesh = MeshShape([dm.size(i) for i in range(dm.ndim)],
                     dm.mesh_dim_names)
    shapes, places = cache_shardings(mesh, cfg, get_api(cfg), batch, max_len)
    return _tree_zip(lambda t, pl: dt.zeros(
        t.shape, dtype=t.dtype, device_mesh=dm, placements=list(pl)),
        shapes, places)


def _tree_zip(fn: Callable, a, b):
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def cache_axes(cfg: ModelConfig) -> Dict:
    """Logical axes tree matching cache_init's structure."""
    def one():
        return {k: ("layers",) + tuple(v) for k, v in L.CACHE_AXES.items()}

    return {f"seg{si}": {kind: one() for kind in pattern}
            for si, (pattern, _) in enumerate(segment_plan(cfg))}


def _first_cache_len(caches) -> torch.Tensor:
    for seg in caches.values():
        for kind in seg.values():
            return kind["len"][0]  # strip the stacked-layers axis
    raise ValueError("no attention cache found")


def decode_step(params, cfg: ModelConfig, caches, tokens):
    """One-token decode: tokens (B, 1); caches hold the context."""
    with L.sharded_ops(params):
        x = L.embed(params["embedding"], tokens).to(cfg.param_dtype)
        # current position per sequence = cache length (same every layer)
        positions = _first_cache_len(caches)[:, None]
    x, new_caches = _run_segments(
        params, cfg, x, positions=positions, caches=caches
    )
    with L.sharded_ops(params):
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
    caches = cache_init(cfg, B, max_len, device=tokens.device, like=tokens)
    with L.sharded_ops(params):
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
    with L.sharded_ops(params):
        x = L.rmsnorm(params["final_norm"], x_last, cfg.norm_eps)
        return L.logits(params["embedding"], cfg, x), new_caches
