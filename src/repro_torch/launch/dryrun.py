"""Dry-run: trace every (arch x shape) cell at production size, on one
card or one rank's share of a pod.

The reference lowers and compiles each cell's step over a 256- or
512-chip mesh and reads XLA's memory and cost analyses.  The port's
counterpart runs the real step function (``launch.steps``'s bundles: the
model, the remat policy, the optimizer) on fake tensors of the production
size under ``FakeTensorMode``: every product goes through the kernels'
``repro_torch`` ops (``ops.library``) on fake CUDA tensors, whose fake
implementations check the operands and build, load and launch nothing,
and ``roofline.op_count`` counts each op.  The plan lookup behind each op
reads the plan DB or takes the analytic tuner's plan, as a compile does
on the reference's side; nothing is timed.

For each cell this records the reference's keys: ``status``, ``step``,
``lower_s`` (the trace's seconds), ``flops`` (the products'),
``bytes_accessed`` (the products' operands and outputs plus every other
op's output), ``memory`` (``argument_size_in_bytes``,
``peak_memory_in_bytes``: the highest sum of live storages, and
``saved_bytes``: what the backward holds), ``collectives`` (bytes by the
reference's kinds and ``count``; all zero on one card) and ``parsed``
(``op_count``'s keys, read by ``roofline.analysis``); ``"hw": "h100"``.
``--device cpu`` traces the plain path (fake CPU tensors: the products
are ``aten`` ops of the same flops), for a machine whose PyTorch has no
CUDA build: there autograd's engine refuses even a fake CUDA tensor.

``--mesh 1`` (the default; ``"mesh": "1"``, ``"chips": 1``, tag ``__1``)
traces the one-card step.  ``--mesh pod`` / ``multipod`` / ``both`` trace
the step over the reference's production meshes, (data 16, model 16)
and (pod 2, data 16, model 16): inside ``launch.mesh.fake_world`` of 256
or 512 ranks, the bundle's arguments are DTensors placed by the
reference's sharding rules (``launch.sharding``, ``$REPRO_SHARDING``) and
the step runs as rank 0 runs it, on fake tensors, with every collective
a no-op of the fake process group.  The record is per device, as the
reference's partitioned HLO is: ``flops``, ``bytes_accessed``,
``memory`` (the local storages) and ``collectives`` (the bytes of each
collective's output, ``op_count.CollectiveRecorder``), with ``"mesh":
"16x16"`` / ``"2x16x16"`` and ``"chips"`` 256 / 512, tags ``__sp`` /
``__mp``; every output's placements are checked against the bundle's
``out_shardings``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --out results/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \
      --shape train_4k --mesh both --out results/
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time
import traceback
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCH_IDS, SHAPES, cell_is_applicable, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..roofline.op_count import COLLECTIVES, CollectiveRecorder, count_step
from .mesh import fake_world, make_debug_mesh, make_production_mesh
from .steps import (check_placements, prefill_bundle, serve_bundle,
                    train_bundle)

#: --mesh -> (descriptor, chips, tag, multi_pod)
MESHES = {"1": ("1", 1, "1", None), "pod": ("16x16", 256, "sp", False),
          "multipod": ("2x16x16", 512, "mp", True)}


def _mesh_entry(mesh: str):
    """``MESHES[mesh]``, or for ``"AxB"`` a data x model mesh of A * B
    ranks (a stand-in for the card's worlds)."""
    if mesh in MESHES:
        return MESHES[mesh]
    a, b = (int(n) for n in mesh.split("x"))
    return mesh, a * b, mesh, None


def collective_bytes(fn, *args, **kwargs) -> Dict[str, int]:
    """The bytes of the collectives one call ``fn(*args, **kwargs)`` runs
    on this rank, by the reference's kinds, with ``count``: the port's
    counterpart of the reference's parse of a compiled step's HLO (the
    port has no HLO), recorded as the collectives run
    (``op_count.CollectiveRecorder``) on a real world or a
    ``fake_world``."""
    rec = CollectiveRecorder()
    with rec:
        fn(*args, **kwargs)
    return {k: int(v) for k, v in rec.collectives.items()}


def _bundle(cfg: ModelConfig, shape: ShapeConfig, device, mesh=None):
    if shape.kind == "train":
        return train_bundle(cfg, shape, device=device, mesh=mesh)
    if shape.kind == "prefill":
        return prefill_bundle(cfg, shape, device=device, mesh=mesh)
    return serve_bundle(cfg, shape, device=device, mesh=mesh)


def _trace(cfg, shape, device, mesh):
    with FakeTensorMode():
        bundle = _bundle(cfg, shape, device, mesh)
        counts = count_step(bundle.fn, *bundle.in_shapes)
    if mesh is not None:
        check_placements(counts["output"], bundle.out_shardings)
    counts.pop("output")
    return bundle, counts


def run_cell(arch: str, shape_name: str, *, device="cuda",
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None, mesh: str = "1") -> Dict:
    """Trace one cell on fake tensors of ``device`` and return its record;
    ``mesh`` is ``"1"`` (one card), ``"pod"`` or ``"multipod"`` (one
    rank's share of the step over that production mesh, per device), or
    ``"AxB"`` (a data x model mesh of that shape).

    ``cfg`` and ``shape`` stand in for the registry's (a cut model, a
    smaller shape); by default the cell is traced at production size."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    desc, chips, _, multi_pod = _mesh_entry(mesh)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": desc,
                 "chips": chips, "hw": "h100",
                 "device": str(torch.device(device))}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    if chips == 1:
        bundle, counts = _trace(cfg, shape, device, None)
    else:
        with fake_world(chips):
            if multi_pod is None:  # a mesh of data x model
                m = make_debug_mesh(tuple(int(n) for n in desc.split("x")),
                                    ("data", "model"), device=device)
            else:
                m = make_production_mesh(multi_pod=multi_pod, device=device)
            bundle, counts = _trace(cfg, shape, device, m)
    t_trace = time.time() - t0
    colls = {k: int(v) for k, v in counts["collectives"].items()}
    parsed = {k: counts[k] for k in ("dot_flops", "collective_bytes",
                                     "out_bytes_proxy", "dot_bytes",
                                     "n_ops")}
    parsed.update({f"coll_{k}": float(colls[k]) for k in COLLECTIVES})
    rec.update(
        status="ok",
        step=bundle.static_name,
        lower_s=round(t_trace, 2),
        flops=counts["dot_flops"],
        bytes_accessed=counts["dot_bytes"] + counts["out_bytes_proxy"],
        memory={
            "argument_size_in_bytes": int(counts["argument_bytes"]),
            "peak_memory_in_bytes": int(counts["peak_live_bytes"]),
            "saved_bytes": int(counts["saved_bytes"]),
        },
        collectives=colls,
        parsed=parsed,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["1", "pod", "multipod", "both"],
                    default="1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu: the plain path)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = (["pod", "multipod"] if args.mesh == "both" else [args.mesh])
    limit = int(os.environ.get("DRYRUN_TIMEOUT", "1800"))
    for arch, shape, mesh in ((a, s, m) for a in archs for s in shapes
                              for m in meshes):
        desc, chips, suffix, _ = MESHES[mesh]
        tag = f"{arch}__{shape}__{suffix}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip-existing] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            def _alarm(sig, frm):
                raise TimeoutError(f"cell exceeded {limit}s")

            signal.signal(signal.SIGALRM, _alarm)
            signal.alarm(limit)
            try:
                rec = run_cell(arch, shape, device=args.device,
                               mesh=mesh)
            finally:
                signal.alarm(0)
        except Exception as e:
            rec = {
                "arch": arch, "shape": shape, "mesh": desc,
                "chips": chips, "hw": "h100", "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-3000:],
            }
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[done] {tag}: {rec['status']}", flush=True)


if __name__ == "__main__":
    main()
