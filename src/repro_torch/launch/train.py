"""Training driver: data pipeline -> train step -> checkpoint/restart.

A port of the reference's ``launch/train.py`` on one device.  Fault
tolerance is the ``runtime.fault`` loop: deterministic data + atomic
checkpoints = exact replay after restore.  On the card the whole step,
forward and backward, runs the hand-written kernels wherever the model's
GEMMs are eligible (see ``launch.steps.make_train_step``).

  python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ck

Every step's grad norm also goes to the ``obs`` histogram
``train.grad_norm`` (its wall time to ``fault.step_wall_s``).  ``--device`` defaults to ``cuda`` and the run
fails without a card; pass ``--device cpu`` for the plain PyTorch
versions.  A run cut in depth goes through
``train(TrainRun(cfg=dataclasses.replace(cfg, n_layers=...), ...))``, or
``train(run_from_args(cut_cfg, parse_args(flags)))``.  ``--capture`` (or
``$REPRO_CAPTURE=1``) trains through the captured loss
(``capture.optimize``): the model's remaining plain products, the
attention motif and the unembedding, run the kernels forward and
backward too.

``TrainRun(mesh=)`` (a ``launch.mesh.Mesh``; every rank of its world
calls ``train``) trains sharded: the parameters, the optimizer state and
each batch are DTensors placed by the reference's sharding rules
(``launch.steps.shard_tree``), and a checkpoint is restored with the
current mesh's shardings (``checkpoint.restore(shardings=, mesh=)``),
whatever mesh saved it: a run restarted on another mesh resumes there.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..configs import get_config
from ..data.pipeline import DataConfig, batch_at
from ..device import resolve_device
from ..models.api import get_api
from ..obs import histogram, log
from ..optim import AdamWConfig, warmup_cosine
from ..optim import adamw as optim
from ..runtime.fault import FaultTolerantLoop, LoopConfig
from ..dtensor import local
from .sharding import batch_spec_for
from .steps import (_meta_params, make_train_step, opt_shardings,
                    param_shardings, shard_tree)


@dataclasses.dataclass
class TrainRun:
    cfg: object
    opt_cfg: AdamWConfig
    data_cfg: DataConfig
    steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    #: route the loss through capture.optimize; None reads $REPRO_CAPTURE
    capture: Optional[bool] = None
    #: torch device of the params, state and batches
    device: str = "cuda"
    #: a ``launch.mesh.Mesh`` to train sharded on, or None
    mesh: object = None


def _batch(run: TrainRun, step: int, device) -> dict:
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in batch_at(run.data_cfg, step).items()}
    if run.mesh is not None:
        batch = shard_tree(run.mesh, batch, {
            k: batch_spec_for(run.mesh, tuple(v.shape), seq_axis=1)
            for k, v in batch.items()})
    return batch


def train(run: TrainRun, params=None, verbose: bool = True):
    """Train ``run.steps`` steps; returns ((params, opt_state), losses,
    loop report).  ``params`` default to ``api.init`` from seed 0 on
    ``run.device``."""
    cfg = run.cfg
    device = resolve_device(run.device)
    api = get_api(cfg)
    if params is None:
        params = api.init(cfg, torch.Generator(device=device).manual_seed(0),
                          device)
    shardings = None
    if run.mesh is not None:
        _, _, p_shard = param_shardings(run.mesh, cfg, api)
        params = shard_tree(run.mesh, params, p_shard)
    opt_state = optim.init(params, run.opt_cfg)
    if run.mesh is not None:
        o_shard = opt_shardings(run.mesh, optim.init(
            _meta_params(cfg, api), run.opt_cfg), p_shard)
        shardings = (p_shard, o_shard)
    schedule = warmup_cosine(
        warmup=min(100, run.steps // 10 + 1), total=run.steps
    )
    step_fn = make_train_step(cfg, run.opt_cfg, lr_schedule=schedule,
                              capture=run.capture)

    mgr = (
        ckpt.CheckpointManager(run.ckpt_dir, keep=3) if run.ckpt_dir else None
    )
    start_step = 0
    if run.ckpt_dir and ckpt.latest_step(run.ckpt_dir) is not None:
        (params, opt_state), manifest = ckpt.restore(
            run.ckpt_dir, (params, opt_state), shardings=shardings,
            mesh=run.mesh if shardings else None,
        )
        start_step = manifest["step"]
        if verbose:
            log.info("restore", f"resuming from step {start_step}")

    losses = []
    state = (params, opt_state)

    def one_step(step, state):
        params, opt_state = state
        params, opt_state, metrics = step_fn(params, opt_state,
                                             _batch(run, step, device))
        loss, gnorm = (float(local(metrics[k]))  # waits for the step
                       for k in ("loss", "grad_norm"))
        losses.append(loss)
        histogram("train.grad_norm").observe(gnorm)
        if verbose and step % run.log_every == 0:
            log.info(None, f"step {step:5d} loss {loss:.4f} "
                     f"gnorm {gnorm:.3f}", flush=True)
        return (params, opt_state)

    def save_fn(step, state):
        if mgr:
            mgr.save_async(step, state, extra={"step": step})

    def restore_fn():
        if mgr:
            mgr.wait()
        (p, o), manifest = ckpt.restore(
            run.ckpt_dir, state, shardings=shardings,
            mesh=run.mesh if shardings else None)
        return manifest["step"], (p, o)

    loop = FaultTolerantLoop(
        step_fn=one_step,
        save_fn=save_fn,
        restore_fn=restore_fn,
        config=LoopConfig(checkpoint_every=run.ckpt_every),
    )
    state = loop.run(state, start_step, run.steps - start_step)
    if mgr:
        mgr.close()
    return state, losses, loop.report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--moments", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--capture", action="store_true",
                    help="capture the whole model: harvest its plain "
                         "products and dispatch the eligible ones through "
                         "the plan-DB pipeline, fwd and bwd "
                         "(repro_torch.capture; also $REPRO_CAPTURE=1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def run_from_args(cfg, args: argparse.Namespace) -> TrainRun:
    """The ``TrainRun`` of ``cfg`` with the flags of ``parse_args``."""
    return TrainRun(
        cfg=cfg,
        opt_cfg=AdamWConfig(lr=args.lr, moments_dtype=args.moments),
        data_cfg=DataConfig(
            vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch
        ),
        steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        capture=args.capture or None,
        device=args.device,
    )


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    t0 = time.time()
    state, losses, report = train(run_from_args(cfg, args))
    dt = time.time() - t0
    log.info(
        "train",
        f"{args.steps} steps in {dt:.1f}s; "
        f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f}; "
        f"stragglers={len(report.straggler_events)}"
    )
    return state, losses, report


if __name__ == "__main__":
    main()
