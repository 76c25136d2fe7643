"""The train step: loss, gradient and optimizer update.

A port of the reference's ``launch/steps.py``, training part.  Autograd
differentiates straight through the hand-written kernels: every model
matmul is a ``repro_torch.ops`` entry point that registers an
``autograd.Function`` (``repro_torch.grad``) whose backward GEMMs are the
derived specs on the same kernels, so on the card both sides of the tape
run them (B1, and under ``REPRO_MOE_GROUPED=1`` B3 and B4).

Sharded bundles (``train_bundle``, the ``mesh=`` argument), capture
(``capture=True`` or ``$REPRO_CAPTURE=1``) and the serving bundles come
with the mesh tier and capture, ROADMAP.md queue A item 6.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..models.api import get_api
from ..optim import AdamWConfig
from ..optim import adamw as optim


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
    """
    if capture is None:
        capture = os.environ.get("REPRO_CAPTURE", "") == "1"
    if capture:
        raise NotImplementedError(
            "capture of the train step comes with the capture slice, "
            "ROADMAP.md queue A item 6"
        )
    if mesh is not None:
        raise NotImplementedError(
            "a mesh-bound train step comes with the mesh tier, ROADMAP.md "
            "queue A item 6"
        )
    api = get_api(cfg)

    def loss_fn(p, b):
        return api.loss(p, cfg, b)

    def train_step(params, opt_state, batch):
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
