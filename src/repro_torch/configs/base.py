"""Model/arch configuration schema, copied from the reference.

One ``ModelConfig`` covers all the reference's families (dense, MoE, SSM,
hybrid, encoder-decoder, vision-language).  ``param_dtype`` is a
``torch.dtype``.
``smoke()`` produces the reduced-config variant used by CPU smoke tests
(same family/topology, tiny extents).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    moe_every: int = 1          # MoE layer every Nth layer (1 = all)
    shared_expert_ff: int = 0   # 0 = no shared expert
    first_dense: int = 0        # first N layers stay dense
    dense_ff: int = 0           # d_ff of the dense layers (if any)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    headdim: int = 64
    d_conv: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "silu"            # MLP activation (silu = SwiGLU, gelu = GLU-free)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0          # hybrid: shared attn block every N ssm layers
    enc_layers: int = 0          # encdec: encoder depth
    max_seq: int = 1 << 20
    dtype: str = "bfloat16"
    remat: bool = True           # activation checkpointing around each layer
    # attention flavour: "full" (quadratic, blockwise-computed) only for now;
    # ssm/hybrid archs are sub-quadratic by construction
    sliding_window: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_ff=32,
                shared_expert_ff=min(self.moe.shared_expert_ff, 32),
                dense_ff=min(self.moe.dense_ff, 64) if self.moe.dense_ff else 0,
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(
                self.ssm, d_state=16, headdim=8, chunk=8
            )
        return dataclasses.replace(
            self,
            n_layers=max(2, self.attn_every or 2),
            d_model=32,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            head_dim=8,
            d_ff=64,
            vocab=97,
            enc_layers=2 if self.enc_layers else 0,
            moe=moe,
            ssm=ssm,
            dtype="float32",
        )


# --------------------------------------------------------------------------
# the assigned input-shape grid (LM transformer shapes)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch x shape) runs, with the skip reason per DESIGN.md."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (skip: full-attention arch)"
    return True, ""
