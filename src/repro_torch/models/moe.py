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
from ..dtensor import is_dtensor
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
    K = cfg.moe.top_k
    router_logits = torch.matmul(xf.to(F32), params["router"].to(F32))
    gate_vals, expert_idx = torch.topk(router_logits, K, dim=-1)  # (N, K)
    gate_vals = torch.softmax(gate_vals, dim=-1)
    sort_idx, slot, token = _slots(cfg, expert_idx, C)
    return gate_vals, expert_idx, sort_idx, slot, token


def _experts(params, h: torch.Tensor, dtype) -> torch.Tensor:
    """The expert FFNs of the dispatched tokens ``h`` (E, C, D): three
    ``ops.grouped_dense`` calls of ``(C,) * E`` groups under
    ``REPRO_MOE_GROUPED=1``, else the batched f32 einsums."""
    E, C, D = h.shape
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
        if is_dtensor(g):
            # the activation on the experts' own layout: any other split of
            # (E, C) would come back strided from the flattening below
            g, u = (_on_experts(t, params["w_gate"]) for t in (g, u))
        act = (F.silu(g) * u).to(dtype)
        return ops.grouped_dense(
            act.reshape(E * C, Fd), params["w_down"], sizes, out_dtype=F32
        ).reshape(E, C, D).to(dtype)
    g = _einsum_f32("ecd,edf->ecf", h, params["w_gate"])
    u = _einsum_f32("ecd,edf->ecf", h, params["w_up"])
    act = (F.silu(g) * u).to(dtype)
    return _einsum_f32("ecf,efd->ecd", act, params["w_down"]).to(dtype)


def _on_experts(t, w):
    """``t`` (E, ...) placed as the expert stack ``w`` shards its experts
    (dim 0), replicated over every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    from ..dtensor import to_placements

    return to_placements(t, w.device_mesh, [
        Shard(0) if p.is_shard(0) else Replicate() for p in w.placements])


def _slots(cfg: ModelConfig, expert_idx: torch.Tensor, C: int):
    """(sort_idx, slot, token) of ``route`` from the (N, K) top-k
    choices."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dev = expert_idx.device
    flat_expert = expert_idx.reshape(-1)
    sort_idx = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[sort_idx]
    group_start = torch.searchsorted(
        sorted_expert, torch.arange(E, device=dev), side="left"
    )
    pos_in_group = (torch.arange(flat_expert.shape[0], device=dev)
                    - group_start[sorted_expert])
    kept = pos_in_group < C
    slot = torch.where(kept, sorted_expert * C + pos_in_group,
                       torch.full_like(pos_in_group, E * C))
    return sort_idx, slot, sort_idx // K


def _combine(out_e, slot, gate, token, n: int) -> torch.Tensor:
    """The (n, D) sum of each kept choice's expert output times its gate
    (``slot`` E * C drops it)."""
    E, C, D = out_e.shape
    padded = torch.cat([out_e.reshape(E * C, D), out_e.new_zeros((1, D))],
                       dim=0)
    contrib = padded[slot] * gate[:, None].to(out_e.dtype)
    return out_e.new_zeros((n, D)).index_add_(0, token, contrib)


def _moe_sharded(params, cfg: ModelConfig, x) -> torch.Tensor:
    """``moe_apply`` of a DTensor ``x``: the reference's routing over all
    N tokens (capacity and slot positions global), the experts on their
    shards.

    By default the tokens are gathered (one all-gather) and every rank
    routes, dispatches and combines all of them; the dispatched (E, C, D)
    tokens are a replicated DTensor, so the expert products run on each
    rank's experts (the op's rule shards the rows with their groups where
    ``w`` is expert-sharded: a slice, no collective) and their outputs are
    gathered for the combine.  ``REPRO_MOE_CONSTRAINT=1`` places the
    dispatched tokens on ``P("model", None, None)`` -- the reference's
    sharding constraint -- by all-to-alls instead (``_dispatch_all_to_all``).
    """
    from ..dtensor import (batch_placements, from_local, local_block,
                           replicate, to_placements)

    m = cfg.moe
    B, S, D = x.shape
    N, E = B * S, m.n_experts
    C = capacity(cfg, N)
    mesh = x.device_mesh
    R = replicate(mesh)
    xf = x.reshape(N, D)
    if os.environ.get("REPRO_MOE_CONSTRAINT") == "1":
        out = _dispatch_all_to_all(params, cfg, xf, C)
    else:
        router = local_block(params["router"].redistribute(mesh, R))
        xl = local_block(to_placements(xf, mesh, R))
        gate_vals, _, sort_idx, slot, token = route(
            {"router": router}, cfg, xl, C)
        dispatched = xl.new_zeros((E * C + 1, D))
        dispatched[slot] = xl[token]
        h = from_local(dispatched[: E * C].reshape(E, C, D), mesh, R,
                       (E, C, D))
        out_e = _experts(params, h, x.dtype).redistribute(mesh, R)
        out = _combine(local_block(out_e), slot,
                       gate_vals.reshape(-1)[sort_idx], token, N)
        out = from_local(out, mesh, R, (N, D)).redistribute(
            mesh, batch_placements(mesh, N))
    if "shared" in params:
        out = out + mlp_apply(params["shared"], cfg, x).reshape(N, D)
    return out.reshape(B, S, D)


class _AllToAll(torch.autograd.Function):
    """An all-to-all of equal splits over ``group``; its transpose, the
    backward, is the same all-to-all."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


def _all_to_all(x, group):
    from torch.distributed._functional_collectives import (all_to_all_single,
                                                           wait_tensor)

    return wait_tensor(all_to_all_single(x.contiguous(), None, None, group))


def _dispatch_all_to_all(params, cfg: ModelConfig, xf, C: int):
    """The (N, D) MoE output of the DTensor ``xf`` (routed experts only)
    under ``REPRO_MOE_CONSTRAINT=1``.

    Each rank routes its own block of the tokens (the rows split over
    every mesh dim, in rank order); one all-gather of each rank's (E,)
    choice counts gives every choice its global position in its expert's
    group, so capacity drops the reference's choices.  Along ``model``
    an all-to-all sends each kept choice's row, with its slot, to the rank
    that holds its expert: a fixed ``n * K`` rows for each peer (``n`` the
    largest block), so shapes do not depend on the routing.  Each rank
    scatters what it receives into its experts' (E / M, C, D) slots; the
    ranks of the other dims hold disjoint slots, whose sum (one all-reduce
    of that buffer) is the reference's ``P("model", None, None)`` layout.
    The expert outputs go back by the same all-to-all, and each rank
    combines its own tokens.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..dtensor import (batch_placements, from_local, local_block,
                           replicate, to_placements)

    m = cfg.moe
    N, D = xf.shape
    E, K = m.n_experts, m.top_k
    mesh = xf.device_mesh
    names = mesh.mesh_dim_names
    M = mesh.size(names.index("model")) if "model" in names else 1
    if E % M:
        raise ValueError(f"{E} experts do not split over a model axis of "
                         f"{M}")
    El = E // M
    every = [Shard(0)] * mesh.ndim
    # the router is used on this rank's tokens alone: its gradient is
    # summed over the ranks
    router = local_block(params["router"].redistribute(mesh, replicate(mesh)),
                         [Partial()] * mesh.ndim)
    xs = local_block(to_placements(xf, mesh, every))
    n = xs.shape[0]
    rows = N  # the largest block of rows, nested as DTensor nests shards
    for i in range(mesh.ndim):
        rows = -(-rows // mesh.size(i))
    P = rows * K
    dev = xs.device
    logits = torch.matmul(xs.to(F32), router.to(F32))
    gate, idx = torch.topk(logits, K, dim=-1)
    gate = torch.softmax(gate, dim=-1)
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))
    # every rank's counts, in the order of the blocks: row-major over the
    # mesh's coordinates
    block = 0
    for i, c in enumerate(mesh.get_coordinate()):
        block = block * mesh.size(i) + c
    every_count = from_local(counts[None], mesh, every,
                             (mesh.size(), E)).full_tensor()
    first = (torch.cumsum(every_count, 0) - every_count)[block]
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    ar = torch.arange(n * K, device=dev)
    pos = ar - torch.searchsorted(se, torch.arange(E, device=dev))[se] \
        + first[se]
    local_slot = torch.where(pos < C, (se % El) * C + pos,
                             torch.full_like(pos, El * C))
    dest = se // El
    at = dest * P + ar - torch.searchsorted(
        dest, torch.arange(M, device=dev))[dest]
    send = xs.new_zeros((M * P, D))
    send[at] = xs[order // K]
    send_slot = torch.full((M * P,), El * C, dtype=torch.int64, device=dev)
    send_slot[at] = local_slot
    if M > 1:
        group = mesh.get_group("model")
        recv = _AllToAll.apply(send, group)
        recv_slot = _all_to_all(send_slot, group)
    else:
        recv, recv_slot = send, send_slot
    buf = recv.new_zeros((El * C + 1, D))
    buf[recv_slot] = recv
    on_model = [Shard(0) if nm == "model" else Replicate() for nm in names]
    h = from_local(buf[: El * C].reshape(El, C, D), mesh,
                   [Shard(0) if nm == "model" else Partial() for nm in names],
                   (E, C, D)).redistribute(mesh, on_model)
    out_e = _experts(params, h, xf.dtype).redistribute(mesh, on_model)
    # each rank reads only its own choices' slots: the gradient of the
    # expert outputs is summed over the other dims
    o = local_block(out_e, [Shard(0) if nm == "model" else Partial()
                            for nm in names]).reshape(El * C, D)
    back = torch.cat([o, o.new_zeros((1, D))], dim=0)[recv_slot]
    if M > 1:
        back = _AllToAll.apply(back, group)
    contrib = back[at] * gate.reshape(-1)[order][:, None].to(xf.dtype)
    out = xs.new_zeros((n, D)).index_add_(0, order // K, contrib)
    return from_local(out, mesh, every, (N, D)).redistribute(
        mesh, batch_placements(mesh, N))


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if is_dtensor(x):
        return _moe_sharded(params, cfg, x)
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
    out_e = _experts(params, h, x.dtype)
    out = _combine(out_e, slot, gate_vals.reshape(-1)[sort_idx], token, N)
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
