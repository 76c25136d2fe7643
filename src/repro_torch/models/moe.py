"""Token-choice top-k Mixture-of-Experts layer (GShard/Mixtral-style).

A port of the reference's ``models/moe.py``.  Routing uses the sort-based
capacity formulation (no dense (tokens x experts x capacity) dispatch
tensor): tokens are argsorted by expert id (stable), positions within each
expert group come from a ``searchsorted`` over the sorted ids, and tokens
beyond the per-expert capacity go to an overflow slot and are dropped.
Padded prefill tokens are routed like any other and take capacity, as in
the reference.

The expert FFNs are products over a stacked (E, D, F) weight.  By default
they are batched ``torch.einsum``s over f32 upcasts (the reference's
``preferred_element_type=f32``); under ``REPRO_MOE_GROUPED=1``, read at
call time as the reference reads it, they go through ``ops.grouped_dense``
with uniform ``(C,) * E`` groups, three calls per layer: on a CUDA tensor
that is the hand-written grouped kernel B3 (``codegen/csrc/grouped.cu``).

The combine ``.at[token].add`` of the reference is ``index_add_``; on the
card its order of adds is not fixed, so a token's top-k contributions may
sum in another order from run to run (a few ulps of ``x.dtype``; with
top-2 the two adds onto zero commute exactly).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from .. import ops
from ..configs.base import ModelConfig
from .layers import F32, _init, _leaf, mlp_apply, mlp_init


def _expert_stack(generator: torch.Generator, shape, dtype, device,
                  scale: float, out: Optional[torch.Tensor]) -> torch.Tensor:
    """(E, a, b) expert weights, N(0, 1) * scale, drawn one expert slab at a
    time in f32 straight into the stacked leaf, so the f32 draw never holds
    more than one (a, b) slab (kimi-k2's full (384, 7168, 2048) stack would
    be 22.5 GB of f32)."""
    w = torch.empty(shape, dtype=dtype, device=device) if out is None else out
    if w.device.type == "meta":  # shapes only: nothing to draw into
        return w
    for e in range(shape[0]):
        slab = torch.randn(shape[1:], generator=generator, device=device,
                           dtype=F32)
        w[e].copy_(slab.mul_(scale))
    return w


def moe_init(cfg: ModelConfig, generator: torch.Generator, device, out=None):
    """The reference's tree: an f32 ``router`` at 1/sqrt(d), expert stacks
    at 1/sqrt(d) (gate, up) and 1/sqrt(f) (down) -- not the fan-in rule of
    ``layers._init`` for the 3-D stacks -- and the shared expert's MLP."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_ff, m.n_experts
    dt = cfg.param_dtype
    p = {
        "router": _init(generator, (d, e), F32, device,
                        out=_leaf(out, "router")),
        "w_gate": _expert_stack(generator, (e, d, f), dt, device,
                                1.0 / math.sqrt(d), _leaf(out, "w_gate")),
        "w_up": _expert_stack(generator, (e, d, f), dt, device,
                              1.0 / math.sqrt(d), _leaf(out, "w_up")),
        "w_down": _expert_stack(generator, (e, f, d), dt, device,
                                1.0 / math.sqrt(f), _leaf(out, "w_down")),
    }
    if m.shared_expert_ff:
        p["shared"] = mlp_init(cfg, generator, device,
                               d_ff=m.shared_expert_ff,
                               out=_leaf(out, "shared"))
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _einsum_f32(formula: str, a: torch.Tensor, b: torch.Tensor):
    """``einsum`` with an f32 result, as ``preferred_element_type=f32``."""
    return torch.einsum(formula, a.to(F32), b.to(F32))


def route(params, cfg: ModelConfig, xf: torch.Tensor, C: int):
    """Top-k routing of the (N, D) tokens ``xf`` into capacity slots.

    Returns (gate_vals (N, K) softmaxed over the top k, expert_idx (N, K),
    sort_idx, slot, token): the k-th choice of token ``token[i]`` sits at
    flat position ``sort_idx[i]`` and goes to capacity slot ``slot[i]``
    (``E * C`` when its expert is full, which drops it).
    """
    m = cfg.moe
    N = xf.shape[0]
    E, K = m.n_experts, m.top_k
    dev = xf.device
    router_logits = torch.matmul(xf.to(F32), params["router"].to(F32))
    gate_vals, expert_idx = torch.topk(router_logits, K, dim=-1)  # (N, K)
    gate_vals = torch.softmax(gate_vals, dim=-1)

    flat_expert = expert_idx.reshape(-1)  # (N*K,)
    sort_idx = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[sort_idx]
    group_start = torch.searchsorted(
        sorted_expert, torch.arange(E, device=dev), side="left"
    )
    pos_in_group = torch.arange(N * K, device=dev) - group_start[sorted_expert]
    kept = pos_in_group < C
    slot = torch.where(kept, sorted_expert * C + pos_in_group,
                       torch.full_like(pos_in_group, E * C))
    return gate_vals, expert_idx, sort_idx, slot, sort_idx // K


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    m = cfg.moe
    B, S, D = x.shape
    N = B * S
    E = m.n_experts
    C = capacity(cfg, N)
    xf = x.reshape(N, D)
    dev = x.device
    gate_vals, _, sort_idx, slot, token = route(params, cfg, xf, C)

    # slot E*C takes every dropped token and is discarded below
    dispatched = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    dispatched[slot] = xf[token]
    h = dispatched[: E * C].reshape(E, C, D)

    if os.environ.get("REPRO_MOE_GROUPED") == "1":
        Fd = params["w_gate"].shape[-1]
        hf = h.reshape(E * C, D)
        sizes = (C,) * E
        g = ops.grouped_dense(
            hf, params["w_gate"], sizes, out_dtype=F32
        ).reshape(E, C, Fd)
        u = ops.grouped_dense(
            hf, params["w_up"], sizes, out_dtype=F32
        ).reshape(E, C, Fd)
        act = (F.silu(g) * u).to(x.dtype)
        out_e = ops.grouped_dense(
            act.reshape(E * C, Fd), params["w_down"], sizes, out_dtype=F32
        ).reshape(E, C, D).to(x.dtype)
    else:
        g = _einsum_f32("ecd,edf->ecf", h, params["w_gate"])
        u = _einsum_f32("ecd,edf->ecf", h, params["w_up"])
        act = (F.silu(g) * u).to(x.dtype)
        out_e = _einsum_f32("ecf,efd->ecd", act, params["w_down"]).to(
            x.dtype
        )

    padded = torch.cat(
        [out_e.reshape(E * C, D), torch.zeros((1, D), dtype=x.dtype,
                                              device=dev)], dim=0
    )
    contrib = padded[slot] * gate_vals.reshape(-1)[sort_idx][:, None].to(
        x.dtype
    )
    out = torch.zeros((N, D), dtype=x.dtype, device=dev).index_add_(
        0, token, contrib
    )

    if "shared" in params:
        out = out + mlp_apply(params["shared"], cfg, x).reshape(N, D)
    return out.reshape(B, S, D)


def load_balance_loss(cfg: ModelConfig, router_logits: torch.Tensor,
                      expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: mean_prob * mean_assignment per expert."""
    E = cfg.moe.n_experts
    probs = torch.softmax(router_logits.to(F32), dim=-1)
    me = probs.mean(dim=0)
    one_hot = F.one_hot(expert_idx[:, 0].long(), E).to(F32)
    fe = one_hot.mean(dim=0)
    return E * torch.sum(me * fe)
