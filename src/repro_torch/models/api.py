"""Uniform model API, LM entry only (the dense and MoE families).

    api = get_api(cfg)
    params = api.init(cfg, generator, device)
    logits, caches = api.prefill(params, cfg, batch, max_len)
    logits, caches = api.decode_step(params, cfg, caches, tokens)

The other families' entries come with their models.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ModelConfig
from . import transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable           # (cfg, generator, device) -> params
    prefill: Callable        # (params, cfg, batch, max_len) -> (logits, caches)
    decode_step: Callable    # (params, cfg, caches, tokens) -> (logits, caches)
    cache_init: Callable     # (cfg, batch, max_len, device) -> caches


def _lm_api() -> ModelAPI:
    return ModelAPI(
        init=transformer.init,
        prefill=lambda p, c, b, max_len: transformer.prefill(
            p, c, b["tokens"], max_len, lengths=b.get("lengths")
        ),
        decode_step=transformer.decode_step,
        cache_init=transformer.cache_init,
    )


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no port yet (ROADMAP.md queue A)"
        )
    return _lm_api()
