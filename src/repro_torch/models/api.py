"""Uniform model API over the six families.

Everything downstream (the serving engines, the trainer, the tests) talks
to models through this adapter:

    api = get_api(cfg)
    params = api.init(cfg, generator, device)
    logits = api.forward(params, cfg, batch)       # batch: dict of tensors
    loss = api.loss(params, cfg, batch)            # scalar f32
    logits, caches = api.prefill(params, cfg, batch, max_len)
    logits, caches = api.decode_step(params, cfg, caches, tokens)
    axes = api.param_axes(cfg)      # logical axes twin of params
    cache_axes = api.cache_axes(cfg)

The dense and MoE families take ``tokens`` (and ``lengths`` at a
right-padded prefill); ssm and hybrid take ``tokens`` only (their state
folds every token in, so they refuse ``lengths``); encdec also takes
``frames`` (B, S_enc, d_model) and vlm ``patches`` (B, ``N_PATCHES``,
``vlm.VIT_DIM``), the precomputed embeddings of their stubbed frontends.
``batch_spec`` names the step inputs of every (family x shape kind).

The reference's ``init`` returns ``(params, logical_axes)``; the port's
returns the params, and ``param_axes(cfg)`` gives their logical-axes twin
(the same tree, each leaf a tuple of logical axis names), which
``launch.sharding`` maps onto a mesh.  ``cache_axes(cfg)`` is the same for
the decode caches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import encdec, hybrid, transformer, vlm

N_PATCHES = 256  # VLM stub: patches per image sequence prefix


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable           # (cfg, generator, device) -> params
    forward: Callable        # (params, cfg, batch) -> logits
    loss: Callable           # (params, cfg, batch) -> scalar
    prefill: Callable        # (params, cfg, batch, max_len) -> (logits, caches)
    decode_step: Callable    # (params, cfg, caches, tokens) -> (logits, caches)
    cache_init: Callable     # (cfg, batch, max_len, device) -> caches
    cache_axes: Callable = None  # (cfg) -> logical axes tree of the caches
    param_axes: Callable = None  # (cfg) -> logical axes tree of the params


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``cfg``'s parameters (``layers.tree_axes`` of
    its init on the meta device: the tree, no draw, nothing allocated)."""
    from .layers import tree_axes

    return tree_axes(_APIS[cfg.family]().init(cfg, None,
                                              torch.device("meta")))


def _lm_api() -> ModelAPI:
    return ModelAPI(
        init=transformer.init,
        forward=lambda p, c, b, **kw: transformer.forward(
            p, c, b["tokens"], **kw
        ),
        loss=lambda p, c, b, **kw: transformer.loss_fn(
            p, c, b["tokens"], b["labels"], **kw
        ),
        prefill=lambda p, c, b, max_len: transformer.prefill(
            p, c, b["tokens"], max_len, lengths=b.get("lengths")
        ),
        decode_step=transformer.decode_step,
        cache_init=transformer.cache_init,
        cache_axes=transformer.cache_axes,
        param_axes=param_axes,
    )


def _need(batch: Dict, key: str, cfg: ModelConfig):
    """``batch[key]``, or a ValueError that names the missing input."""
    if batch.get(key) is None:
        raise ValueError(
            f"family {cfg.family!r} ({cfg.arch_id}) needs batch[{key!r}], "
            f"the precomputed embeddings of its stubbed frontend; serve it "
            f"through FixedEngine(..., extra_batch={{{key!r}: ...}})"
        )
    return batch[key]


def _hybrid_prefill(p, c, b, max_len):
    if b.get("lengths") is not None:
        # SSM recurrences fold every input token into the state: a pad
        # token pollutes it whatever the attention layers mask, so
        # right-padded batching is attention-family only
        raise NotImplementedError(
            "lengths-masked prefill is not supported for ssm/hybrid "
            "families; serve them with per-request (batch-1) prefill"
        )
    return hybrid.prefill(p, c, b["tokens"], max_len)


def _hybrid_api() -> ModelAPI:
    return ModelAPI(
        init=hybrid.init,
        forward=lambda p, c, b, **kw: hybrid.forward(p, c, b["tokens"], **kw),
        loss=lambda p, c, b, **kw: hybrid.loss_fn(
            p, c, b["tokens"], b["labels"], **kw
        ),
        prefill=_hybrid_prefill,
        decode_step=hybrid.decode_step,
        cache_init=hybrid.cache_init,
        cache_axes=hybrid.cache_axes,
        param_axes=param_axes,
    )


def _encdec_api() -> ModelAPI:
    # the reference's prefill ignores ``lengths``: a shorter prompt of a
    # right-padded batch takes its first token from a pad position
    return ModelAPI(
        init=encdec.init,
        forward=lambda p, c, b, **kw: encdec.forward(
            p, c, _need(b, "frames", c), b["tokens"], **kw
        ),
        loss=lambda p, c, b, **kw: encdec.loss_fn(
            p, c, _need(b, "frames", c), b["tokens"], b["labels"], **kw
        ),
        prefill=lambda p, c, b, max_len: encdec.prefill(
            p, c, _need(b, "frames", c), b["tokens"], max_len
        ),
        decode_step=encdec.decode_step,
        cache_init=lambda c, batch, max_len, device="cpu": encdec.cache_init(
            c, batch, max_len, enc_len=max_len, device=device
        ),
        cache_axes=encdec.cache_axes,
        param_axes=param_axes,
    )


def _vlm_api() -> ModelAPI:
    # as encdec, the reference's prefill ignores ``lengths``
    return ModelAPI(
        init=vlm.init,
        forward=lambda p, c, b, **kw: vlm.forward(
            p, c, b["tokens"], _need(b, "patches", c), **kw
        ),
        loss=lambda p, c, b, **kw: vlm.loss_fn(
            p, c, b["tokens"], _need(b, "patches", c), b["labels"], **kw
        ),
        prefill=lambda p, c, b, max_len: vlm.prefill(
            p, c, b["tokens"], _need(b, "patches", c), max_len
        ),
        decode_step=vlm.decode_step,
        cache_init=vlm.cache_init,
        cache_axes=vlm.cache_axes,
        param_axes=param_axes,
    )


_APIS = {
    "dense": _lm_api,
    "moe": _lm_api,
    "ssm": _hybrid_api,
    "hybrid": _hybrid_api,
    "encdec": _encdec_api,
    "vlm": _vlm_api,
}


def get_api(cfg: ModelConfig) -> ModelAPI:
    return _APIS[cfg.family]()


# ---------------------------------------------------------------------------
# input specifications per (family x shape kind)
# ---------------------------------------------------------------------------


def batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    """name -> (shape, dtype) for the *step inputs* of this cell.

    train/prefill: full-sequence inputs.  decode: a single new token (the
    KV/state caches are separate step inputs).  The sequence budget S is
    split per family: encdec S/2 encoder frames + S/2 decoder tokens; vlm
    ``N_PATCHES`` image patches + (S - ``N_PATCHES``) text tokens.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32)}
    if cfg.family in ("dense", "moe", "ssm", "hybrid"):
        spec = {"tokens": ((B, S), i32)}
    elif cfg.family == "encdec":
        spec = {
            "frames": ((B, S // 2, cfg.d_model), cfg.param_dtype),
            "tokens": ((B, S // 2), i32),
        }
    elif cfg.family == "vlm":
        spec = {
            "patches": ((B, N_PATCHES, vlm.VIT_DIM), cfg.param_dtype),
            "tokens": ((B, S - N_PATCHES), i32),
        }
    else:
        raise KeyError(cfg.family)
    if shape.kind == "train":
        spec["labels"] = (spec["tokens"][0], i32)
    return spec
