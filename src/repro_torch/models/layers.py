"""Shared model layers: norms (RMS and layer), rotary, GQA attention
(blockwise online-softmax prefill path + cached decode path), the MLPs,
embeddings and logits.

A port of the reference's ``models/layers.py``: parameter trees are nested
dicts of tensors with the reference's names, shapes, dtypes and layouts
(``(B, S, heads, hd)`` activations), so ``transformer.params_from_reference``
can carry the reference's weights across unchanged.  Attention is plain
PyTorch, as it is plain JAX in the reference; every projection and MLP
product goes through ``ops.dense``.  Norms, rotary and softmax compute in
float32 as the reference does.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import ops
from ..configs.base import ModelConfig
from ..dtensor import (batch_placements, from_local, is_dtensor,
                       local_block, merge_heads, offset, replicate,
                       sharded_ops, split_last, to_placements, whole_heads)

F32 = torch.float32
NEG_INF = -1e30


#: ``$REPRO_REMAT_POLICY``'s names, as the reference's
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch")


def _save_products(batched: bool):
    """The selective-checkpoint policy that saves every product's output
    (``batched``) or only those of products without batch dimensions:
    ``ops.library.product_batched`` names the products (the kernels'
    ``repro_torch`` ops, ``aten.mm`` / ``addmm`` / ``bmm`` /
    ``baddbmm``); everything else is recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    from ..ops.library import product_batched

    def policy(ctx, func, *args, **kwargs):
        kind = product_batched(func, args)
        if kind is not None and (batched or not kind):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def remat(fn: Callable, policy: Optional[str] = None) -> Callable:
    """Activation-checkpoint a layer step under the active remat policy.

    ``$REPRO_REMAT_POLICY`` as in the reference: ``nothing`` (the default)
    saves nothing inside the step and recomputes all of it in the
    backward; ``dots`` saves the output of every product (the reference's
    ``checkpoint_dots``) and ``dots_no_batch`` of every product without
    batch dimensions (``checkpoint_dots_with_no_batch_dims``: the
    projections, the MoE router, B3's grouped products; not attention's
    batched einsums nor ``batched_dense``), and recompute the rest.  An
    unknown name raises.  ``torch.utils.checkpoint(use_reentrant=False)``,
    with ``create_selective_checkpoint_contexts`` for the two ``dots``
    policies: the policy is a dispatch mode, so it sees each kernel launch
    as one op, ``repro_torch::contract`` / ``::grouped`` / ``::attention``
    (``ops.library``), and the plain products of the CPU as ``aten`` ops.
    The RNG state is not stashed: the models draw no random numbers in a
    step (the reference threads its keys explicitly).  ``policy`` names
    the policy instead of the environment (a captured replay keeps the
    policy its trace saw).
    """
    pol = policy or remat_policy()
    if pol not in REMAT_POLICIES:
        raise ValueError(f"REPRO_REMAT_POLICY={pol!r}: one of "
                         f"{REMAT_POLICIES}")
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    kw = {}
    if pol != "nothing":
        policy = _save_products(batched=pol == "dots")
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    def wrapped(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw, **kwargs)

    return wrapped


def remat_policy() -> str:
    """``$REPRO_REMAT_POLICY`` (``nothing`` when unset)."""
    return os.environ.get("REPRO_REMAT_POLICY", "nothing")


#: the capture trace in progress (``capture.harvest``), which records each
#: call of a ``scan_body`` as one region of its graph; None otherwise
_CAPTURE = None


def scan_body(fn: Callable, *, name: str, remat_on: bool = False) -> Callable:
    """The step a loop over stacked layers calls once a layer: the
    counterpart of the reference's ``lax.scan`` body, checkpointed under
    the active remat policy where ``remat_on`` (``remat``).

    Outside a capture trace it is ``fn`` (or ``remat(fn)``).  While
    ``capture`` traces (``_CAPTURE`` set), each call is recorded as one
    region of the traced graph, named ``name``: the harvest reports the
    sites of a body once, as the reference's walk of a scan body does,
    and the replay runs each remat region under ``torch.utils.checkpoint``
    with the policy the trace saw, so a captured train step keeps the
    uncaptured one's recompute and peak.
    """
    policy = remat_policy() if remat_on else None
    step = remat(fn, policy) if remat_on else fn

    def wrapped(*args, **kwargs):
        if _CAPTURE is not None:
            return _CAPTURE.region(name, wrapped, policy, fn, args, kwargs)
        return step(*args, **kwargs)

    return wrapped


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
# DTensor parameters
# ---------------------------------------------------------------------------
#
# A model whose parameters are DTensors (``launch.steps.shard_tree``) runs
# sharded: every ``ops`` product goes through its kernel's op and sharding
# rule (``ops.library.sharded_launch``), every other op through DTensor's
# own propagation, and a plain tensor made inside (positions, masks,
# rotary tables) is taken as replicated (``sharded_ops``).  Where an op has
# no DTensor rule, or where propagation would pick another layout than the
# reference's sharding rules imply, the layout is named explicitly: the
# embedding gather on a replicated table, attention on each rank's
# sequences and heads (``on_local_heads``), the f32 cross-entropy on each
# rank's rows, and MoE routing (``models.moe``).


def on_local_heads(fn, q, k, v, *, kv_lengths=None, **kw):
    """``fn(q, k, v, kv_lengths=, **kw)`` of (batch, seq, heads, hd)
    DTensors run on each rank's sequences and heads (``batch_placements``)
    as plain tensors: the attention the reference's sharding gives each
    chip, with no collective inside."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    pl = batch_placements(mesh, q.shape[0], (H,))
    pl_kv = batch_placements(mesh, q.shape[0], (H, KV))
    q_loc = local_block(to_placements(q, mesh, pl))
    if pl_kv == pl:
        k_loc, v_loc = (local_block(to_placements(t, mesh, pl))
                        for t in (k, v))
    else:
        # the query heads split over ``model`` and the key / value heads
        # do not: each rank takes the key / value heads its query heads
        # read (GQA), whose gradients the ranks then sum
        dim = next(i for i, p in enumerate(pl) if p.is_shard(2))
        h_loc = H // mesh.size(dim)
        first = mesh.get_coordinate()[dim] * h_loc
        g = H // KV
        heads = slice(first // g, (first + h_loc - 1) // g + 1)
        grads = [Partial() if i == dim else p for i, p in enumerate(pl_kv)]
        k_loc, v_loc = (local_block(to_placements(t, mesh, pl_kv),
                                    grads)[:, :, heads] for t in (k, v))
    lens = None
    if kv_lengths is not None:
        lens = to_placements(kv_lengths, mesh, [
            p if p.is_shard(0) else Replicate() for p in pl]).to_local()
    out = fn(q_loc, k_loc, v_loc, kv_lengths=lens, **kw)
    return from_local(out.contiguous(), mesh, pl, (*q.shape[:3], v.shape[3]))


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


def layernorm_init(cfg: ModelConfig, dim=None, device="cpu", out=None):
    dim = dim or cfg.d_model
    return {"scale": _fill((dim,), 1.0, F32, device, _leaf(out, "scale")),
            "bias": _fill((dim,), 0.0, F32, device, _leaf(out, "bias"))}


def layernorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = x.to(F32)
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out.to(x.dtype)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's ``jnp.dot(x, w, preferred_element_type=f32)
    .astype(x.dtype)`` where it calls no kernel (the SSM and cross-attention
    projections): a plain product accumulated in f32 (the engines turn
    TF32 and reduced-precision bf16 reductions off), rounded once to x's
    dtype."""
    return torch.matmul(x, w.to(x.dtype))


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
    if is_dtensor(x) and not is_dtensor(cos):
        # replicated tables, named here: the backward saves them
        cos, sin = (to_placements(t, x.device_mesh,
                                  replicate(x.device_mesh))
                    for t in (cos, sin))
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
    q = split_last(ops.dense(x2, params["wq"]), B, S, h, hd)
    k = split_last(ops.dense(x2, params["wk"]), B, S, kv, hd)
    v = split_last(ops.dense(x2, params["wv"]), B, S, kv, hd)
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
    reduction regrouped over them with a running max and sum; the query
    blocks run together (the reference's ``vmap``) and a Python loop over
    the key blocks stands in for its ``lax.scan``.  ``kv_lengths`` masks
    keys at positions >= the per-sequence length (right-padded prefill).
    ``REPRO_CAUSAL_SKIP=1`` (causal only) skips the fully masked blocks:
    key block ki updates only the query blocks from ki * k_block //
    q_block on, with the same result.
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

    # every query block at once, as the reference vmaps over them; a
    # Python loop over the key blocks stands in for its lax.scan
    qs = q.reshape(B, nq, q_block, KV, G, hd).to(F32)
    ks = k.reshape(B, nk, k_block, KV, hd)
    vs = v.reshape(B, nk, k_block, KV, hd)
    q_pos = torch.arange(S, device=dev).reshape(nq, 1, 1, q_block, 1)
    m = torch.full((B, nq, KV, G, q_block), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, nq, KV, G, q_block), dtype=F32, device=dev)
    acc = torch.zeros((B, nq, KV, G, q_block, hd), dtype=F32, device=dev)
    # REPRO_CAUSAL_SKIP=1 (the reference's knob): key block ki updates only
    # the query blocks its causal frontier reaches, ki * k_block // q_block
    # on; the blocks before it are finished (a fully masked block would
    # leave their m, l and acc as they are), so the result is the same
    causal_skip = causal and os.environ.get("REPRO_CAUSAL_SKIP") == "1"
    done = []  # finished query blocks' outputs, in order
    for ki in range(nk):
        if causal_skip:
            cut = min(ki * k_block // q_block, nq) - (nq - qs.shape[1])
            if cut > 0:
                done.append(acc[:, :cut] / l[:, :cut, ..., None])
                qs, q_pos = qs[:, cut:], q_pos[cut:]
                m, l, acc = m[:, cut:], l[:, cut:], acc[:, cut:]
            if not qs.shape[1]:
                break
        s = torch.einsum(
            "bnqkgh,bpkh->bnkgqp", qs, ks[:, ki].to(F32)
        ) * scale
        k_pos = ki * k_block + torch.arange(k_block, device=dev)
        if causal:
            s = torch.where(q_pos >= k_pos, s, NEG_INF)
        if kv_lengths is not None:
            valid = k_pos[None, :] < kv_lengths[:, None]  # (B, kb)
            s = torch.where(valid[:, None, None, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnkgqp,bpkh->bnkgqh", p, vs[:, ki].to(F32)
        )
        m = m_new
    out = acc / l[..., None]  # (B, nq, KV, G, qb, hd)
    if done:
        out = torch.cat(done + [out], dim=1)
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


def _plain(fn, *args, **kw):
    return fn(*args, **kw)


def _write_prefix(cache, new) -> None:
    """``cache[:, :S] = new`` for DTensors: the prompt's keys (or values)
    on the cache's layout with their positions whole, each rank copying
    the positions its block of the cache holds."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache.device_mesh, cache.placements
    rows = to_placements(new.to(cache.dtype), mesh, [
        Replicate() if p.is_shard(1) else p for p in pl]).to_local()
    local = cache.to_local()
    first = offset(mesh, [Shard(0) if p.is_shard(1) else Replicate()
                          for p in pl], cache.shape[1])
    lo, hi = first, min(first + local.shape[1], new.shape[1])
    if hi > lo:
        local[:, :hi - lo] = rows[:, lo:hi]


def _write_token(cache, new, idx) -> None:
    """``cache[b, idx[b]] = new[b]`` for DTensors: each rank writes the rows
    of its batch block whose position falls in its block of the sequence
    (a cache sharded over its sequence keeps each row on one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache.device_mesh, cache.placements
    # the new row: the cache's layout, its sequence dim dropped
    row_pl = [Replicate() if p.is_shard(1) else
              (type(p)(p.dim - 1) if p.is_shard() and p.dim > 1 else p)
              for p in pl]
    row = to_placements(new.to(cache.dtype), mesh, row_pl).to_local()
    pos = to_placements(idx, mesh, [p if p.is_shard(0) else Replicate()
                                    for p in pl]).to_local()
    local = cache.to_local()
    first = offset(mesh, [Shard(0) if p.is_shard(1) else Replicate()
                          for p in pl], cache.shape[1])
    mine = (pos >= first) & (pos < first + local.shape[1])
    rows = torch.arange(local.shape[0], device=local.device)
    at = (pos - first).clamp(0, local.shape[1] - 1)
    keep = local[rows, at]  # rows whose position another rank holds
    local[rows, at] = torch.where(mine[:, None, None], row, keep)


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
        y = (on_local_heads if is_dtensor(q) else _plain)(
            blockwise_attention, q, k, v, causal=causal, q_block=q_block,
            k_block=k_block, kv_lengths=lengths,
        )
        new_cache = None
    elif S == 1:
        idx = cache["len"]  # (B,) current write positions
        if is_dtensor(idx):
            _write_token(cache["k"], k[:, 0], idx)
            _write_token(cache["v"], v[:, 0], idx)
            q = whole_heads(q, 2, cfg.n_kv_heads)
        else:
            bidx = torch.arange(B, device=x.device)
            cache["k"][bidx, idx] = k[:, 0].to(cache["k"].dtype)
            cache["v"][bidx, idx] = v[:, 0].to(cache["v"].dtype)
        y = decode_attention(q, cache["k"], cache["v"], idx + 1)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + 1}
    else:
        # prefill into an empty cache; one longer than the cache raises
        # (the reference's dynamic_update_slice would clamp the write)
        if S > cache["k"].shape[1]:
            raise ValueError(f"a {S}-position prefill overruns a "
                             f"{cache['k'].shape[1]}-position KV cache")
        sharded = is_dtensor(cache["k"])
        if sharded:
            _write_prefix(cache["k"], k)
            _write_prefix(cache["v"], v)
        else:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        y = (on_local_heads if is_dtensor(q) else _plain)(
            blockwise_attention, q, k, v, causal=causal, q_block=q_block,
            k_block=k_block, kv_lengths=lengths,
        )
        lens = (torch.full((B,), S, dtype=torch.long, device=x.device)
                if lengths is None else lengths.to(torch.long))
        if sharded:
            lens = to_placements(lens, cache["len"].device_mesh,
                                 cache["len"].placements)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": lens}
    y = ops.dense(merge_heads(y).reshape(B * S, -1),
                  params["wo"]).reshape(B, S, -1)
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


#: logical axes of the attention cache (for sharding long-context decode)
CACHE_AXES = {"k": ("batch", "seq_kv", "kv", None),
              "v": ("batch", "seq_kv", "kv", None),
              "len": ("batch",)}


# ---------------------------------------------------------------------------
# logical axes of the parameters
# ---------------------------------------------------------------------------

#: a leaf's logical axes by the kind of the dict that holds it: the
#: reference annotates each leaf as its ``*_init`` builds it (``PA``); the
#: port's trees carry the same names, so one table per kind of block
#: gives the same axes
_NORM = {"scale": ("embed",), "bias": ("embed",)}
_ATTENTION = {
    "wq": ("embed", "heads"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
    "wo": ("heads", "embed"), "bq": ("heads",), "bk": ("kv",),
    "bv": ("kv",), "q_norm": (None,), "k_norm": (None,),
}
_MLP = {
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"), "w1": ("embed", "mlp"), "b1": ("mlp",),
    "w2": ("mlp", "embed"), "b2": ("embed",),
}
_MOE = {
    "router": ("embed", "experts"),
    "w_gate": ("experts", "embed", "mlp"),
    "w_up": ("experts", "embed", "mlp"),
    "w_down": ("experts", "mlp", "embed"),
}
_SSM = {
    "in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"),
    "conv_b": ("mlp",), "A_log": ("heads",), "D": ("heads",),
    "dt_bias": ("heads",), "norm_scale": ("mlp",),
    "out_proj": ("mlp", "embed"),
}
_BLOCKS = {
    "embedding": {"tok": ("vocab", "embed"), "unembed": ("embed", "vocab")},
    "attn": _ATTENTION, "self_attn": _ATTENTION, "cross_attn": _ATTENTION,
    "mlp": _MLP, "shared": _MLP, "moe": _MOE, "ssm": _SSM,
    "projector": {"w": (None, "embed"), "b": ("embed",)},
}
#: top-level subtrees whose leaves are stacked along a leading layers axis
STACKED = ("ssm_layers", "enc_layers", "dec_layers")


def _leaf_axes(block: str, leaf: str):
    table = _NORM if block.endswith("norm") else _BLOCKS.get(block)
    if table is None or leaf not in table:
        raise KeyError(f"no logical axes for parameter {block}/{leaf}")
    return table[leaf]


def tree_axes(tree: Dict) -> Dict:
    """The logical-axes twin of a parameter tree: the second half of the
    reference's ``split_params`` of an annotated init, with ``"layers"``
    prepended under the stacked segments (``seg*`` and ``STACKED``), as
    the reference's ``init``s do."""

    def walk(node, block, stacked):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k, stacked)
            else:
                axes = _leaf_axes(block, k)
                out[k] = ("layers",) + tuple(axes) if stacked else axes
        return out

    return {k: walk(v, k, k.startswith("seg") or k in STACKED)
            for k, v in tree.items()}


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
    tok = params["tok"]
    if is_dtensor(tok):
        # the gather reads a whole table: the vocab-sharded one replicated
        tok = tok.redistribute(tok.device_mesh, replicate(tok.device_mesh))
        return F.embedding(tokens, tok)
    return tok[tokens]


def logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits, as the reference's ``preferred_element_type=f32``:
    a bf16 product here would round the logits and move greedy ties."""
    B, S, D = x.shape
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    x2 = x.reshape(B * S, D)
    if is_dtensor(x2):
        # each rank's rows against its vocab columns, the table gathered
        # over the rest (FSDP), not a sum of partial products over the
        # whole batch
        from torch.distributed.tensor import Replicate, Shard

        mesh = x2.device_mesh
        x2 = to_placements(x2, mesh, batch_placements(mesh, B * S))
        cols = [Shard(1) if n == "model" and w.shape[1] % mesh.size(i) == 0
                else Replicate() for i, n in enumerate(mesh.mesh_dim_names)]
        w = to_placements(w, mesh, cols)
    return torch.matmul(x2.to(F32), w.to(F32)).reshape(B, S, -1)


def cross_entropy(logits_: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL, numerically stable, f32: the reference's value.

    The reference extracts the gold logit with a one-hot multiply-reduce;
    here it is a ``gather`` (the one-hot would be a (tokens, vocab) f32
    tensor, 1.24 GB at 2048 x 151936).
    """
    if is_dtensor(logits_):
        return _sharded_cross_entropy(logits_, labels)
    logits_ = logits_.to(F32)
    lse = torch.logsumexp(logits_, dim=-1)
    gold = torch.gather(logits_, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _sharded_cross_entropy(logits_, labels) -> torch.Tensor:
    """The f32 cross-entropy of DTensor logits: each rank's rows with
    their whole vocab (the vocab-sharded logits gathered), the local sum of
    NLLs over the global token count, summed over the ranks."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = logits_.device_mesh
    pl = batch_placements(mesh, logits_.shape[0])
    loc = local_block(to_placements(logits_, mesh, pl)).to(F32)
    lab = to_placements(labels, mesh, pl).to_local()
    lse = torch.logsumexp(loc, dim=-1)
    gold = torch.gather(loc, -1, lab.long()[..., None])[..., 0]
    part = torch.sum(lse - gold) / labels.numel()
    loss = from_local(part, mesh, [Partial() if p.is_shard() else Replicate()
                                   for p in pl], ())
    return loss.redistribute(mesh, replicate(mesh))
