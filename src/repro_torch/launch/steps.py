"""Step builders: the train step, and the one-card bundles a dry-run
traces.

A port of the reference's ``launch/steps.py``.  Autograd differentiates
straight through the hand-written kernels: every model matmul is a
``repro_torch.ops`` entry point that registers an ``autograd.Function``
(``repro_torch.grad``) whose backward GEMMs are the derived specs on the
same kernels, so on the card both sides of the tape run them (B1, and
under ``REPRO_MOE_GROUPED=1`` B3 and B4).

``train_bundle`` / ``prefill_bundle`` / ``serve_bundle`` give a
(arch x shape) cell's step function and its arguments (``StepBundle``), as
the reference's do: the arguments are built on the device asked for under
the active ``FakeTensorMode`` (``eval_params``), so a cell of production
size is traced (``launch.dryrun``) and never allocated.  ``capture=True``
(or ``$REPRO_CAPTURE=1``) routes the loss through ``capture.optimize``.
With ``mesh=`` a bundle also carries the reference's output shardings
(``StepBundle.out_shardings``: ``launch.sharding`` placements from the
logical axes, ``param_shardings`` / ``opt_shardings`` /
``batch_shardings`` / ``cache_shardings``), and its train step runs under
the mesh.

``make_train_step(mesh=)`` activates the mesh for the step body, as the
reference's does, so ``ops._tuned_kernel`` consults the mesh-qualified
plans a ``--mesh`` sweep persisted and eligible GEMMs on plain
(replicated) parameters, forward and backward, run as
``codegen.bind_mesh`` kernels over the mesh's ranks.  A step whose
parameters are DTensors (``shard_tree``, placed by the reference's
sharding rules) runs sharded instead, as the reference's is sharded by
its arrays' shardings: every kernel launch goes through its op's sharding
rule (``ops.library.sharded_launch``) and runs on each rank's shards,
every other op through DTensor, and the optimizer updates each rank's
shards.  A bundle built on a mesh with ranks (a ``launch.mesh.Mesh``,
``fake_world``'s too) places its arguments by its ``in_shardings``;
``check_placements`` holds its outputs to its ``out_shardings``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.api import ModelAPI, batch_spec, get_api
from ..optim import AdamWConfig, Quantized
from ..optim import adamw as optim
from . import sharding as shd
from .mesh import set_mesh


@dataclasses.dataclass
class StepBundle:
    """Everything needed to trace or run one (arch x shape) cell."""

    fn: Callable                      # the step function
    in_shapes: Tuple                  # its arguments (fake under a dry-run)
    static_name: str                  # train_step | prefill_step | serve_step
    out_shardings: Any = None         # placements of the outputs, or None
    in_shardings: Any = None          # placements of the arguments, or None


def _fake_mode():
    mode = torch._guards.detect_fake_mode()
    if mode is None:
        raise RuntimeError(
            "the step bundles build their arguments at production size; "
            "build them under a torch._subclasses.FakeTensorMode (as "
            "launch.dryrun does), so that nothing is allocated"
        )
    return mode


def shard_tree(mesh, tree, shardings):
    """``tree`` (nested dicts, named tuples such as ``AdamWState`` and
    ``Quantized`` moments) placed leaf by leaf on ``mesh`` by its twin
    ``shardings`` (``Placements`` leaves): each leaf becomes a DTensor
    whose local shard every rank slices from its own copy of the leaf
    (``distribute_tensor(src_data_rank=None)``: no collective) and copies,
    so the ranks must hold the same values, as a seeded init or a restored
    checkpoint gives them.  One leaf is placed at a time; the caller may
    drop the whole-leaf tree afterwards."""
    from torch.distributed.tensor import distribute_tensor

    from ..dtensor import from_local

    dm = mesh.device_mesh

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        if isinstance(t, Quantized):
            return Quantized(walk(t.q, s.q), walk(t.scale, s.scale),
                             t.shape, t.dtype)
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(getattr(t, f), getattr(s, f))
                             for f in t._fields))
        d = distribute_tensor(t.detach(), dm, list(s), src_data_rank=None)
        # a shard of its own: the slice may be a view of ``t``, which the
        # in-place optimizer must not write through
        return from_local(d.to_local().clone(), dm, d.placements, d.shape)

    return walk(tree, shardings)


def check_placements(tree, shardings, what: str = "output") -> None:
    """Raise unless every leaf of ``tree`` is a DTensor with the
    placements of its twin in ``shardings``."""
    from ..dtensor import is_dtensor

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (k,))
        elif isinstance(t, Quantized):
            walk(t.q, s.q, path + ("q",))
            walk(t.scale, s.scale, path + ("scale",))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), getattr(s, f), path + (f,))
        elif isinstance(t, (tuple, list)):
            for i, (x, y) in enumerate(zip(t, s)):
                walk(x, y, path + (f"#{i}",))
        elif not is_dtensor(t) or tuple(t.placements) != tuple(s):
            have = tuple(t.placements) if is_dtensor(t) else "a plain tensor"
            raise AssertionError(f"{what} {'/'.join(path)}: placements "
                                 f"{have}, the shardings say {tuple(s)}")

    walk(tree, shardings, ())


def eval_params(cfg: ModelConfig, api: ModelAPI, device="cuda"):
    """The params of ``cfg`` as fake tensors on ``device`` under the
    active ``FakeTensorMode``: the model's own ``init`` on the meta device
    (the tree, shapes and dtypes, no draw, nothing allocated; the
    reference's ``jax.eval_shape`` of its init), each leaf then made a
    fake tensor."""
    _fake_mode()
    shapes = api.init(cfg, None, torch.device("meta"))
    return optim.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), shapes)


def _meta_params(cfg: ModelConfig, api: ModelAPI):
    return api.init(cfg, None, torch.device("meta"))


def param_shardings(mesh, cfg: ModelConfig, api: ModelAPI):
    """(param shapes on the meta device, logical axes, placements)."""
    shapes = _meta_params(cfg, api)
    axes = api.param_axes(cfg)
    return shapes, axes, shd.tree_shardings(mesh, shapes, axes)


def opt_shardings(mesh, opt_shapes, param_shardings_tree):
    """Moments inherit the param sharding; Quantized moments shard their
    flat block axis across the whole mesh."""
    from ..codegen.mesh_gen import Placements

    def like_params(moments, psh):
        if isinstance(moments, dict):
            return {k: like_params(moments[k], psh[k]) for k in moments}
        if isinstance(moments, Quantized):
            q = shd.quantized_sharding(mesh, moments)
            return Quantized(q["q"], q["scale"], moments.shape,
                             moments.dtype)
        return psh

    return optim.AdamWState(
        step=Placements((), mesh.axis_names),
        m=like_params(opt_shapes.m, param_shardings_tree),
        v=like_params(opt_shapes.v, param_shardings_tree),
    )


def batch_shardings(mesh, cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Each step input's placements (``batch_spec_for``, the sequence as
    the fallback axis)."""
    return {name: shd.batch_spec_for(mesh, shp, seq_axis=1)
            for name, (shp, _) in batch_spec(cfg, shape).items()}


def cache_shardings(mesh, cfg: ModelConfig, api: ModelAPI, batch, max_len):
    """(cache shapes on the meta device, their placements)."""
    c_shapes = api.cache_init(cfg, batch, max_len, device="meta")
    c_axes = api.cache_axes(cfg)
    rules = {**shd.PARAM_RULES, "heads": shd.PARAM_RULES["heads"]}

    def walk(s, a):
        if isinstance(s, dict):
            return {k: walk(v, a[k] if isinstance(a, dict) and k in a
                            else a)
                    for k, v in s.items()}
        ax = a if isinstance(a, (tuple, type(None))) else None
        return shd.spec_for(mesh, ax, tuple(s.shape), rules=rules)

    return c_shapes, walk(c_shapes, c_axes)


def _metrics_shardings(mesh) -> dict:
    from ..codegen.mesh_gen import Placements

    return {k: Placements((), mesh.axis_names)
            for k in ("grad_norm", "clip_scale", "loss")}


def _batch(cfg: ModelConfig, shape: ShapeConfig, device) -> dict:
    return {name: torch.zeros(shp, dtype=dt, device=device)
            for name, (shp, dt) in batch_spec(cfg, shape).items()}


def _runs_on(mesh) -> bool:
    """Whether ``mesh`` has ranks (a ``launch.mesh.Mesh``), so a bundle's
    arguments are placed on it, rather than shapes only."""
    return getattr(mesh, "device_mesh", None) is not None


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every leaf of ``params`` (a leaf the loss does not reach
    gets zeros, as ``jax.grad`` gives)."""
    paths = [p for p, _ in optim.leaves(params)]
    leaves = [t for _, t in optim.leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    tree: dict = {}
    for path, t, g in zip(paths, leaves, grads):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros_like(t) if g is None else g
    return loss.detach(), tree


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    lr_schedule: Optional[Callable] = None,
    microbatch: int = 1,
    capture: Optional[bool] = None,
    mesh=None,
):
    """Loss + grad + optimizer update for one (micro)batch.

    ``train_step(params, opt_state, batch)`` returns ``(params, opt_state,
    metrics)`` with ``metrics`` = ``loss``, ``grad_norm``, ``clip_scale``
    (0-d tensors on the params' device).  The update is in place
    (``optim.adamw.update``).  With ``microbatch > 1`` the batch is split
    along its leading axis and the gradients are accumulated in f32, each
    divided by ``microbatch``, as the reference's scan does; the update
    then takes the f32 sums.

    ``capture`` (or ``$REPRO_CAPTURE=1``) routes the loss through
    ``repro_torch.capture.optimize``, as the reference does: the model's
    remaining plain products (the attention motif, the unembedding, the
    MoE experts' batched einsums) are harvested into ContractionSpecs and,
    where eligible, dispatched through the same plan-DB pipeline, fwd and
    bwd; the model's own ``ops`` launches replay as they are, and each
    layer's checkpoint region keeps its remat policy.  Ineligible sites
    run untouched, so this is a strict superset of the uncaptured step.

    ``mesh`` activates that mesh for the step body (``launch.mesh
    .set_mesh``), so ``ops._tuned_kernel`` consults the mesh-shape-qualified
    plan keys a ``--mesh`` sweep persisted and eligible GEMMs, forward and
    backward, dispatch through the mesh-bound kernels
    (``codegen.bind_mesh``).  Every rank of the mesh must call the step,
    with the same parameters and batch.  Callers that already run under
    ``set_mesh(mesh)`` get the same behaviour without passing it.
    """
    if capture is None:
        capture = os.environ.get("REPRO_CAPTURE", "") == "1"
    api = get_api(cfg)

    def loss_fn(p, b):
        return api.loss(p, cfg, b)

    if capture:
        from .. import capture as _capture

        loss_fn = _capture.optimize(loss_fn,
                                    label=f"{cfg.arch_id}:train_step")

    def train_step(params, opt_state, batch):
        with set_mesh(mesh):  # no change where mesh is None
            return _body(params, opt_state, batch)

    def _body(params, opt_state, batch):
        if microbatch > 1:
            loss = None
            grads = None
            for i in range(microbatch):
                mb = {k: v.reshape(microbatch, v.shape[0] // microbatch,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, params, mb)
                loss = (l / microbatch if loss is None
                        else loss + l / microbatch)
                if grads is None:
                    grads = optim.tree_map(
                        lambda t: t.to(torch.float32) / microbatch, g
                    )
                else:
                    for path, acc in optim.leaves(grads):
                        acc.add_(optim.at_path(g, path).to(torch.float32)
                                 / microbatch)
                del g
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)

        lr_scale = lr_schedule(opt_state.step) if lr_schedule else 1.0
        # a profiler range, so a trace can tell the optimizer's kernels
        with torch.profiler.record_function("optim.update"):
            params, opt_state, metrics = optim.update(
                grads, opt_state, params, opt_cfg, lr_scale=lr_scale
            )
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train_bundle(cfg: ModelConfig, shape: ShapeConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 microbatch: int = 1, capture: Optional[bool] = None,
                 device="cuda", mesh=None) -> StepBundle:
    """The train step of a cell and its (params, opt_state, batch), built
    under the active ``FakeTensorMode``.  As in the reference, a model of
    256 experts or more keeps int8 moments (it needs them to fit), and
    ``$REPRO_OPT_INT8=1`` forces them for every model.  With ``mesh``
    ``out_shardings`` holds the placements of (params, opt_state,
    metrics) and ``in_shardings`` those of (params, opt_state, batch); on
    a mesh with ranks (a ``Mesh``, ``fake_world``'s included) the
    arguments are DTensors placed by them (``shard_tree``), so the step
    runs sharded, one rank's share of it."""
    api = get_api(cfg)
    if opt_cfg is None:
        big = cfg.moe is not None and cfg.moe.n_experts >= 256
        use_int8 = big or os.environ.get("REPRO_OPT_INT8") == "1"
        opt_cfg = AdamWConfig(moments_dtype="int8" if use_int8 else "float32")
    params = eval_params(cfg, api, device)
    batch = _batch(cfg, shape, device)
    step = make_train_step(cfg, opt_cfg, microbatch=microbatch,
                           capture=capture, mesh=mesh)
    out = ins = None
    if mesh is not None:
        p_shapes, _, p_shard = param_shardings(mesh, cfg, api)
        o_shard = opt_shardings(mesh, optim.init(p_shapes, opt_cfg), p_shard)
        out = (p_shard, o_shard, _metrics_shardings(mesh))
        ins = (p_shard, o_shard, batch_shardings(mesh, cfg, shape))
        if _runs_on(mesh):
            params = shard_tree(mesh, params, p_shard)
            batch = shard_tree(mesh, batch, ins[2])
    opt_state = optim.init(params, opt_cfg)
    return StepBundle(fn=step, in_shapes=(params, opt_state, batch),
                      static_name="train_step", out_shardings=out,
                      in_shardings=ins)


def serve_bundle(cfg: ModelConfig, shape: ShapeConfig,
                 device="cuda", mesh=None) -> StepBundle:
    """decode_*: one new token against a ``seq_len``-deep cache; with
    ``mesh``, ``out_shardings`` holds the placements of (logits, caches)
    and ``in_shardings`` those of (params, caches, tokens), by which the
    arguments are placed on a mesh with ranks (the dense and MoE
    families)."""
    api = get_api(cfg)
    B, S = shape.global_batch, shape.seq_len
    params = eval_params(cfg, api, device)
    caches = api.cache_init(cfg, B, S, device=device)
    tokens = torch.zeros((B, 1), dtype=torch.int32, device=device)
    out = ins = None
    if mesh is not None:
        _, c_shard = cache_shardings(mesh, cfg, api, B, S)
        out = (shd.batch_spec_for(mesh, (B, 1, cfg.vocab)), c_shard)
        ins = (param_shardings(mesh, cfg, api)[2], c_shard,
               shd.batch_spec_for(mesh, (B, 1)))
        if _runs_on(mesh):
            params, caches, tokens = (shard_tree(mesh, t, s) for t, s in
                                      zip((params, caches, tokens), ins))

    def serve_step(params, caches, tokens):
        with torch.no_grad():
            logits, new = api.decode_step(params, cfg, caches, tokens)
        return _placed(logits, mesh, out), new

    return StepBundle(fn=serve_step, in_shapes=(params, caches, tokens),
                      static_name="serve_step", out_shardings=out,
                      in_shardings=ins)


def prefill_bundle(cfg: ModelConfig, shape: ShapeConfig,
                   device="cuda", mesh=None) -> StepBundle:
    """prefill_*: the prompt of ``seq_len`` tokens, building caches as
    deep; with ``mesh``, ``out_shardings`` holds the placements of
    (logits, caches) and ``in_shardings`` those of (params, batch), by
    which the arguments are placed on a mesh with ranks (the dense and
    MoE families)."""
    api = get_api(cfg)
    params = eval_params(cfg, api, device)
    batch = _batch(cfg, shape, device)
    max_len = shape.seq_len
    out = ins = None
    if mesh is not None:
        dec_len = batch_spec(cfg, shape)["tokens"][0][1]
        _, c_shard = cache_shardings(mesh, cfg, api, shape.global_batch,
                                     max_len)
        out = (shd.batch_spec_for(
            mesh, (shape.global_batch, dec_len, cfg.vocab)), c_shard)
        ins = (param_shardings(mesh, cfg, api)[2],
               batch_shardings(mesh, cfg, shape))
        if _runs_on(mesh):
            params, batch = (shard_tree(mesh, t, s) for t, s in
                             zip((params, batch), ins))

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, caches = api.prefill(params, cfg, batch, max_len)
        return _placed(logits, mesh, out), caches

    return StepBundle(fn=prefill_step, in_shapes=(params, batch),
                      static_name="prefill_step", out_shardings=out,
                      in_shardings=ins)


def _placed(logits, mesh, out):
    """The step's logits on their ``out_shardings`` placements (the
    vocab-sharded unembedding gathered), where the step runs sharded."""
    from ..dtensor import is_dtensor, to_placements

    if not is_dtensor(logits):
        return logits
    return to_placements(logits, mesh.device_mesh, list(out[0]))
