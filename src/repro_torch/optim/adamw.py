"""AdamW with optional block-quantized 8-bit moments and global-norm clip.

A port of the reference's ``optim/adamw.py``.  State mirrors the params
tree; with ``moments_dtype='int8'`` each moment leaf is a ``Quantized``.
The arithmetic is the reference's, in its order: the global norm of the
grads, the clip ``scale``, the bias corrections ``1 - b ** step`` in f32,
then per element ``m``, ``v``, the update and the decayed parameter, one
rounding to the parameter's dtype at the end.

Where the reference's jitted step lets XLA fuse the f32 round trip, the
port works leaf by leaf on flat chunks of ``CHUNK`` elements (a multiple
of ``quant.BLOCK``, so a chunk covers whole quantization blocks and the
int8 moments come out bit for bit as a whole-leaf ``quantize``): no f32
copy of a whole leaf's g, m, v or p ever exists, whatever the leaf's
size.  ``update`` writes the new parameters and moments IN PLACE into
``params`` and ``state.m``/``state.v`` (the moments alone are 22 GB of f32
for qwen3-8b cut to 8 layers; a second copy would not fit beside them) and
returns those same trees; only ``state.step`` is a new tensor.  Leaves are
visited in sorted-key order, as JAX flattens a dict.

DTensor parameters (``launch.steps.shard_tree``) keep DTensor state:
``init`` gives each float moment its parameter's placements and each int8
moment ``quant.block_placements``'s layout.  ``update`` brings each
gradient to its parameter's placements and runs the same chunked, in-place
code on the local shards (the gradients in ``grads`` are replaced by the
placed ones); the global norm is the local sums of squares of those (a
replicated shard counted once) summed over the ranks in one all-reduce.  An int8 moment's blocks cover a flat range of the whole
leaf, not the parameter's shard: its rank updates that range of the
gathered leaf and the new ranges are gathered back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import torch

from ..dtensor import (copies, from_local, is_dtensor, local, offset,
                       reduced, replicate, to_placements)
from ..roofline.op_count import repeated, repeats
from .quant import (BLOCK, Quantized, block_placements, dequantize_blocks,
                    quantize_blocks)

#: elements per f32 temporary in ``update`` and ``global_norm``: 64 MiB
CHUNK = 1 << 24
assert CHUNK % BLOCK == 0


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"  # float32 | bfloat16 | int8


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: Any
    v: Any


def leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a nested dict, keys in sorted order; a
    ``Quantized`` is one leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def at_path(tree, path):
    """The leaf of a nested dict at a key path of ``leaves``."""
    for k in path:
        tree = tree[k]
    return tree


def _zeros_moment(p: torch.Tensor, how: str):
    if is_dtensor(p):
        return _sharded_zeros_moment(p, how)
    if how == "int8":
        n = p.numel()
        nblocks = -(-n // BLOCK)
        # quantize(zeros): every block's absmax is 0, so its scale is 1
        return Quantized(
            q=torch.zeros((nblocks, BLOCK), dtype=torch.int8, device=p.device),
            scale=torch.ones((nblocks, 1), dtype=torch.float32,
                             device=p.device),
            shape=tuple(p.shape), dtype=torch.float32,
        )
    return torch.zeros(p.shape, dtype=getattr(torch, how), device=p.device)


def _sharded_zeros_moment(p, how: str):
    from torch.distributed import tensor as dt

    mesh = p.device_mesh
    if how == "int8":
        nblocks = -(-p.numel() // BLOCK)
        pl = block_placements(mesh, nblocks)
        return Quantized(
            q=dt.zeros((nblocks, BLOCK), dtype=torch.int8, device_mesh=mesh,
                       placements=pl),
            scale=dt.ones((nblocks, 1), dtype=torch.float32,
                          device_mesh=mesh, placements=pl),
            shape=tuple(p.shape), dtype=torch.float32,
        )
    return dt.zeros(p.shape, dtype=getattr(torch, how), device_mesh=mesh,
                    placements=p.placements)


def _replicated(x, mesh):
    """A 0-d tensor ``x`` as a replicated DTensor on ``mesh``."""
    return from_local(x, mesh, replicate(mesh), ())


def init(params, cfg: AdamWConfig) -> AdamWState:
    if cfg.moments_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"moments_dtype {cfg.moments_dtype!r}")
    m = tree_map(lambda p: _zeros_moment(p, cfg.moments_dtype), params)
    v = tree_map(lambda p: _zeros_moment(p, cfg.moments_dtype), params)
    first = next(t for _, t in leaves(params))
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if is_dtensor(first):
        step = _replicated(step, first.device_mesh)
    return AdamWState(step=step, m=m, v=v)


def _chunks(n: int):
    """(a, b, times): the chunks of a flat leaf of ``n`` elements, each
    once (``times`` 1).  While a dry-run counts the step
    (``roofline.op_count``), the full chunks run as one counted ``times``
    times, then the tail."""
    full = n // CHUNK
    once = repeats(full)
    for i in range(once):
        yield i * CHUNK, (i + 1) * CHUNK, full // once
    if n % CHUNK:
        yield full * CHUNK, n, 1


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g**2) in f32, each leaf summed
    chunk by chunk.  For DTensor leaves each rank sums its shards (a
    ``Partial`` leaf reduced first, since its blocks are addends; a shard
    replicated over r ranks weighted 1 / r) and one all-reduce over the
    world sums the ranks; the norm is then a replicated DTensor."""
    total = None
    mesh = None
    with torch.no_grad():
        for _, g in leaves(tree):
            held = 1
            if is_dtensor(g):
                g = reduced(g)
                mesh, held = g.device_mesh, copies(g)
                g = g.to_local()
            flat = g.reshape(-1)
            for a, b, times in _chunks(flat.numel()):
                with repeated(times):
                    s = torch.sum(torch.square(flat[a:b].to(torch.float32)))
                    if held > 1:
                        s = s / held
                    total = s if total is None else total + s
        if mesh is not None:
            return _replicated(torch.sqrt(_sum_over_ranks(total, mesh)),
                               mesh)
    return torch.sqrt(total)


def _sum_over_ranks(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over every rank of ``mesh`` (one all-reduce where the
    mesh is the world)."""
    import torch.distributed as dist
    from torch.distributed._functional_collectives import (all_reduce,
                                                           wait_tensor)

    if mesh.size() == dist.get_world_size():
        return wait_tensor(all_reduce(x, "sum", dist.group.WORLD))
    from torch.distributed.tensor import Partial

    return from_local(x, mesh, [Partial()] * mesh.ndim, x.shape).redistribute(
        mesh, replicate(mesh)).to_local()


def _decode(m, a: int, b: int) -> torch.Tensor:
    if isinstance(m, Quantized):
        return dequantize_blocks(m.q[a // BLOCK: -(-b // BLOCK)],
                                 m.scale[a // BLOCK: -(-b // BLOCK)], b - a)
    return m.reshape(-1)[a:b].to(torch.float32)


def _encode_into(m, a: int, b: int, new: torch.Tensor) -> None:
    if isinstance(m, Quantized):
        q, scale = quantize_blocks(new)
        m.q[a // BLOCK: -(-b // BLOCK)] = q
        m.scale[a // BLOCK: -(-b // BLOCK)] = scale
    else:
        m.view(-1)[a:b] = new.to(m.dtype)


def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           lr_scale=1.0):
    """Returns (params, new_state, metrics); params and moments are updated
    in place (see the module docstring)."""
    with torch.no_grad():
        _place_grads(grads, params)
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (local(gnorm) + 1e-9), max=1.0)
        step = local(state.step) + 1
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(cfg.b1, stepf)
        b2c = 1 - torch.pow(cfg.b2, stepf)
        lr = cfg.lr * local(lr_scale)
        for path, p in leaves(params):
            g = at_path(grads, path)
            m, v = at_path(state.m, path), at_path(state.v, path)
            if is_dtensor(p):
                if isinstance(m, Quantized):
                    _update_blocks(p, g, m, v, scale, b1c, b2c, lr, cfg)
                    continue
                g, m, v, p = local(g), local(m), local(v), local(p)
            g = g.reshape(-1)
            if not p.is_contiguous():
                raise ValueError(f"parameter {'/'.join(path)} is not "
                                 f"contiguous; the update writes it in place")
            flat = p.view(-1)
            for a, b, times in _chunks(flat.numel()):
                with repeated(times):
                    _update_chunk(flat, g, m, v, a, b, scale, b1c, b2c, lr,
                                  cfg, p.dtype)
        if is_dtensor(gnorm):
            mesh = gnorm.device_mesh
            scale = _replicated(scale, mesh)
            step = _replicated(step, mesh)
    metrics: Dict[str, torch.Tensor] = {"grad_norm": gnorm,
                                        "clip_scale": scale}
    return params, AdamWState(step, state.m, state.v), metrics


def _place_grads(grads, params) -> None:
    """Each DTensor gradient in ``grads`` replaced, in place, by itself on
    its parameter's placements (a partial sum reduced, a replicated one
    sliced), so the norm and the update read the same local blocks and
    the unplaced gradient is freed leaf by leaf."""
    for path, p in leaves(params):
        if not is_dtensor(p):
            continue
        node = at_path(grads, path[:-1])
        node[path[-1]] = node[path[-1]].redistribute(p.device_mesh,
                                                     p.placements)


def _update_blocks(p, g, m: Quantized, v: Quantized, scale, b1c, b2c, lr,
                   cfg) -> None:
    """AdamW's step on a DTensor parameter with int8 moments: this rank's
    moment blocks cover the flat range [a0, a1) of the whole leaf, so it
    updates that range of the gathered parameter and gradient, and the
    ranges are gathered back into the parameter's shards."""
    mesh = p.device_mesh
    R = replicate(mesh)
    n = p.numel()
    nblocks = m.q.shape[0]
    pl = m.q.placements
    b0 = offset(mesh, pl, nblocks)
    mq, vq = (Quantized(local(t.q), local(t.scale), t.shape, t.dtype)
              for t in (m, v))
    a0, a1 = b0 * BLOCK, min((b0 + mq.q.shape[0]) * BLOCK, n)
    full = to_placements(p, mesh, R).to_local().reshape(-1)
    grad = to_placements(g, mesh, R).to_local().reshape(-1)
    flat, gr = full[a0:a1], grad[a0:a1]
    for a, b, times in _chunks(flat.numel()):
        with repeated(times):
            _update_chunk(flat, gr, mq, vq, a, b, scale, b1c, b2c, lr, cfg,
                          p.dtype)
    piece = torch.nn.functional.pad(flat, (0, mq.q.shape[0] * BLOCK
                                           - flat.numel()))
    new = from_local(piece, mesh, pl, (nblocks * BLOCK,)).redistribute(
        mesh, R).to_local()[:n].reshape(p.shape)
    shard = to_placements(new, mesh, p.placements).to_local()
    p.to_local().copy_(shard)


def _update_chunk(flat, g, m, v, a, b, scale, b1c, b2c, lr, cfg, dtype):
    """AdamW's step on the chunk [a, b) of a flat leaf, written in
    place."""
    gc = g[a:b].to(torch.float32) * scale
    m_new = cfg.b1 * _decode(m, a, b) + (1 - cfg.b1) * gc
    v_new = cfg.b2 * _decode(v, a, b) + (1 - cfg.b2) * gc * gc
    upd = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
    pf = flat[a:b].to(torch.float32)
    flat[a:b] = (pf - lr * (upd + cfg.weight_decay * pf)).to(dtype)
    _encode_into(m, a, b, m_new)
    _encode_into(v, a, b, v_new)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def warmup_cosine(warmup: int, total: int, min_ratio: float = 0.1) -> Callable:
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac)
        )
        return warm * cos

    return fn
