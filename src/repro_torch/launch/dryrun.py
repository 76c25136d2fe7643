"""One-card dry-run: trace every (arch x shape) cell at production size.

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
``saved_bytes``: what the backward holds), ``collectives`` (all zero on
one card) and ``parsed`` (``op_count``'s keys, read by
``roofline.analysis``); ``"mesh": "1"``, ``"chips": 1`` and ``"hw":
"h100"``.  ``--device cpu`` traces the plain path (fake CPU tensors: the
products are ``aten`` ops of the same flops), for a machine whose PyTorch
has no CUDA build: there autograd's engine refuses even a fake CUDA
tensor.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --out results/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/

The meshes (``--mesh pod|multipod``, with their collective bytes) come
with ROADMAP.md queue A item 6c (part 2).
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
from ..roofline.op_count import count_step
from .steps import prefill_bundle, serve_bundle, train_bundle

#: the reference's collective kinds, each 0 bytes on one card
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

MESH_REFUSAL = ("a dry-run over a pod or multi-pod mesh comes with "
                "ROADMAP.md queue A item 6c (part 2)")


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """The reference parses the collectives of compiled HLO; the port has
    no HLO and no mesh yet."""
    raise NotImplementedError(MESH_REFUSAL)


def _bundle(cfg: ModelConfig, shape: ShapeConfig, device):
    if shape.kind == "train":
        return train_bundle(cfg, shape, device=device)
    if shape.kind == "prefill":
        return prefill_bundle(cfg, shape, device=device)
    return serve_bundle(cfg, shape, device=device)


def run_cell(arch: str, shape_name: str, *, device="cuda",
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict:
    """Trace one cell on fake tensors of ``device`` and return its record.

    ``cfg`` and ``shape`` stand in for the registry's (a cut model, a
    smaller shape); by default the cell is traced at production size."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": "1", "chips": 1,
                 "hw": "h100", "device": str(torch.device(device))}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    with FakeTensorMode():
        bundle = _bundle(cfg, shape, device)
        counts = count_step(bundle.fn, *bundle.in_shapes)
    counts.pop("output")
    t_trace = time.time() - t0
    colls = {k: 0 for k in COLLECTIVES}
    colls["count"] = 0
    parsed = {k: counts[k] for k in ("dot_flops", "collective_bytes",
                                     "out_bytes_proxy", "dot_bytes",
                                     "n_ops")}
    parsed.update({f"coll_{k}": 0.0 for k in COLLECTIVES})
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
    if args.mesh != "1":
        raise NotImplementedError(MESH_REFUSAL)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    limit = int(os.environ.get("DRYRUN_TIMEOUT", "1800"))
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__1"
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
                    rec = run_cell(arch, shape, device=args.device)
                finally:
                    signal.alarm(0)
            except Exception as e:
                rec = {
                    "arch": arch, "shape": shape, "mesh": "1", "chips": 1,
                    "hw": "h100", "status": "error",
                    "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-3000:],
                }
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[done] {tag}: {rec['status']}", flush=True)


if __name__ == "__main__":
    main()
